"""Device-residency admission of the PyTorch/CUDA port."""
