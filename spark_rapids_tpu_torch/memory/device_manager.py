"""The device's memory budget, and recycled host staging buffers.

Counterpart of ``spark_rapids_tpu/memory/device_manager.py``
(GpuDeviceManager in the reference):

- ``device_alloc_checkpoint``: the ``alloc.device`` fault seam that
  ``BufferStore.reserve`` consults before it admits a reservation, in
  place of the allocation-failure hook the allocator does not expose;
- ``initialize(conf, device)`` sizes the buffer store and installs it
  as the process store: the plugin calls it once at bring-up
  (``plugin.py``), and a test or a run that wants another budget calls
  it again through a plugin restart.  On CUDA the device budget is
  ``memory.fraction`` of the card's memory as
  ``torch.cuda.mem_get_info`` reports it (the JAX code asks PJRT's
  ``memory_stats``), unless the conf sets ``memory.hbm.budgetBytes``
  itself: an explicit value wins, as an explicit ``batchSizeRows`` wins
  over the JAX package's automatic sizing.  On the CPU the budget is
  ``hbm.budgetBytes``;
- ``select_device``: the card a session with no device given takes,
  from ``spark.rapids.tpu.deviceOrdinal`` (JAX ``select_device``);
- ``HostBufferPool``: recycled uint8 staging buffers for the disk
  tier's serializer, pinned on a CUDA session, keeping at most
  ``memory.hostPool.maxBytes`` of free buffers (set by ``initialize``).
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.robustness import faults as _faults


def device_alloc_checkpoint(nbytes: int) -> None:
    """The ``alloc.device`` fault seam: disarmed, one global read."""
    _faults.fault_point("alloc.device", nbytes=nbytes)


def select_device(conf: C.TorchConf, device_count: int) -> torch.device:
    """``cuda:<deviceOrdinal>``; -1, or an ordinal past ``device_count``
    cards, takes ``cuda:0`` (JAX ``select_device``)."""
    ordinal = conf.get(C.DEVICE_ORDINAL)
    return torch.device("cuda", ordinal if 0 <= ordinal < device_count
                        else 0)


def device_budget(conf: C.TorchConf, device: torch.device) -> int:
    """The store's device budget for a session on ``device``."""
    if device.type == "cuda" and not conf.is_set(C.HBM_BUDGET_BYTES):
        _free, total = torch.cuda.mem_get_info(device)
        return int(total * conf.get(C.MEMORY_FRACTION))
    return int(conf.get(C.HBM_BUDGET_BYTES))


def initialize(conf: C.TorchConf, device: torch.device):
    """A buffer store sized for ``device`` from ``conf``, installed as
    the process store (the one it replaces is closed); returns it."""
    from spark_rapids_tpu_torch.memory.store import BufferStore, reset_store

    device = torch.device(device)
    pool = HostBufferPool.get()
    pool.pinned = device.type == "cuda"
    pool.max_bytes = conf.get(C.HOST_POOL_BYTES)
    store = BufferStore(device_budget=device_budget(conf, device),
                        host_budget=conf.get(C.HOST_SPILL_BYTES),
                        spill_dir=conf.get(C.SPILL_DIR) or None,
                        codec=conf.get(C.SPILL_CODEC),
                        compress_host=conf.get(C.SPILL_COMPRESS_HOST))
    reset_store(store)
    return store


class HostBufferPool:
    """Recycled uint8 host buffers, bucketed by power-of-two size; page
    locked when ``pinned`` (a CUDA session)."""

    _instance: Optional["HostBufferPool"] = None
    _ilock = threading.Lock()

    def __init__(self, max_bytes: int = C.DEFAULTS[C.HOST_POOL_BYTES],
                 pinned: bool = False):
        self._free: dict[int, list[torch.Tensor]] = {}
        self._lock = threading.Lock()
        self._held = 0
        self.max_bytes = max_bytes
        self.pinned = pinned

    @classmethod
    def get(cls) -> "HostBufferPool":
        with cls._ilock:
            if cls._instance is None:
                cls._instance = HostBufferPool()
            return cls._instance

    @staticmethod
    def _bucket(nbytes: int) -> int:
        b = 4096
        while b < nbytes:
            b <<= 1
        return b

    def take(self, nbytes: int) -> torch.Tensor:
        """A uint8 tensor of at least ``nbytes`` (not zeroed)."""
        b = self._bucket(nbytes)
        with self._lock:
            lst = self._free.get(b)
            if lst:
                buf = lst.pop()
                self._held -= b
                return buf
        pin = self.pinned and torch.cuda.is_available()
        return torch.empty(b, dtype=torch.uint8, pin_memory=pin)

    def give(self, buf: torch.Tensor) -> None:
        """Return a buffer from ``take`` (keep no reference to it)."""
        b = buf.numel()
        if buf.dtype != torch.uint8 or buf.dim() != 1 or b & (b - 1) \
                or b < 4096:
            return
        with self._lock:
            if self._held + b > self.max_bytes:
                return
            self._free.setdefault(b, []).append(buf)
            self._held += b
