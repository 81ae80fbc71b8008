"""plan layer of the PyTorch/CUDA port."""
