"""spark_rapids_tpu_torch: the PyTorch/CUDA port of spark_rapids_tpu.

A columnar SQL engine that runs on an NVIDIA H100 through PyTorch, with
hand-written CUDA kernels (``csrc/``) where the JAX package had Pallas
TPU kernels.  It mirrors ``spark_rapids_tpu``'s layout and names, and
imports neither JAX nor that package.  Entry point: ``TorchSession``.
"""

from spark_rapids_tpu_torch.exprs.window import (  # noqa: F401
    Window,
    dense_rank,
    lag,
    lead,
    rank,
    row_number,
)
from spark_rapids_tpu_torch.session import (  # noqa: F401
    DataFrame,
    TorchSession,
    avg,
    col,
    count,
    count_star,
    lit,
    max_,
    min_,
    sum_,
)
