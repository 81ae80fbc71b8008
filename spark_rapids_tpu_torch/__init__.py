"""spark_rapids_tpu_torch: the PyTorch/CUDA port of spark_rapids_tpu.

A columnar SQL engine that runs on an NVIDIA H100 through PyTorch, with
hand-written CUDA kernels (``csrc/``) where the JAX package had Pallas
TPU kernels.  It mirrors ``spark_rapids_tpu``'s layout and names, and
imports neither JAX nor that package.  Entry point: ``TorchSession``.

The names below load on first use, so that importing a torch-free
submodule (the Python worker's child, ``python_worker``) imports no
torch.
"""

import importlib

_EXPORTS = {
    "exprs.window": ("Window", "dense_rank", "lag", "lead", "rank",
                     "row_number"),
    "session": ("DataFrame", "TorchSession", "avg", "col", "count",
                "count_star", "lit", "max_", "min_", "sum_"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_WHERE)


def __getattr__(name: str):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'spark_rapids_tpu_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value
