"""exprs layer of the PyTorch/CUDA port."""
