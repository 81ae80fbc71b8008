"""Host pipeline stages of the PyTorch/CUDA port."""
