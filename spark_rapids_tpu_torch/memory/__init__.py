"""The memory runtime of the PyTorch/CUDA port: the spill-tiered buffer
store and the task semaphore (``spark_rapids_tpu/memory/__init__.py``).
The store is proactive: operators register the batches they hold,
reserve room before they restore one, and the store spills the lowest
priority unpinned batches down DEVICE -> HOST -> DISK to make it."""

from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore  # noqa: F401
from spark_rapids_tpu_torch.memory.store import (  # noqa: F401
    BufferStore,
    SpillableBatch,
    SpillPriorities,
    StorageTier,
    get_store,
    reset_store,
)
