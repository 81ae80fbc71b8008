"""io layer of the PyTorch/CUDA port."""
