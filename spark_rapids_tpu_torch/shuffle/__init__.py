"""shuffle layer of the PyTorch/CUDA port."""
