"""columnar layer of the PyTorch/CUDA port."""
