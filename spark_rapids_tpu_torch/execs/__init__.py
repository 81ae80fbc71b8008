"""execs layer of the PyTorch/CUDA port."""
