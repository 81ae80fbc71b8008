"""Deterministic fault injection of the PyTorch/CUDA port."""
