"""cpu layer of the PyTorch/CUDA port: the CPU engine (``engine.py``)."""
