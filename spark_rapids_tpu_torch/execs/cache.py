"""The cache exec: materialize once, serve from then on.

Counterpart of ``spark_rapids_tpu/execs/cache.py`` (Spark's
InMemoryTableScan under ``df.cache()``).  A cached subtree's batches
live in the session's buffer store (``memory/store.py``) at
``SpillPriorities.CACHED``: on the device while the budget allows,
spilled to host and disk under pressure like every other parked batch,
and brought back by ``get``.

- The first run streams each batch through to its consumer and stages
  a handle for it.  The slot publishes once every partition has
  drained, so a LIMIT that stops early publishes nothing; ``close``
  frees what a partial drain staged.  Partitions may drain on pool
  threads at once, so the completion count and the publish are one
  step under a lock.
- Every later run over the slot serves the stored batches and never
  runs the child: no scan reads a file (``cacheHits`` counts the
  batches served, ``cacheWrites`` those stored).
- Torch tensors are mutable where JAX arrays are not: the store holds
  a copy of each batch the first run hands on, and each run is served
  a copy of the stored one, so a consumer that writes into its input
  (a user's columnar function, an in-place op) cannot change the cache.
  A copy is one device-to-device pass over the batch.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.execs.base import Metrics, TaskRuntime, TpuExec
from spark_rapids_tpu_torch.memory.store import SpillPriorities


def copy_batch(batch: ColumnarBatch) -> ColumnarBatch:
    """A batch with its own copy of every tensor."""
    return batch.gather(torch.arange(batch.num_rows, device=batch.device))


class TpuCacheExec(TpuExec):
    def __init__(self, slot, child: TpuExec,
                 runtime: Optional[TaskRuntime] = None):
        super().__init__(child)
        self.slot = slot
        self.runtime = runtime or TaskRuntime.serial()
        self.metrics = Metrics("cacheHits", "cacheWrites", "numOutputRows")
        self._staged: dict[int, list] = {}
        self._complete: set[int] = set()
        self._stage_lock = threading.Lock()

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    @property
    def num_partitions(self) -> int:
        parts = self.slot.parts
        if parts is not None:
            return max(1, len(parts))
        return self.children[0].num_partitions

    def node_desc(self) -> str:
        state = "cached" if self.slot.filled else "materializing"
        return f"TpuCacheExec [{state}]"

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        parts = self.slot.parts
        if parts is not None:
            for h in parts[p] if p < len(parts) else ():
                try:
                    out = copy_batch(h.get())
                finally:
                    h.unpin()  # spillable again between queries
                self.metrics.add("cacheHits", 1)
                self.metrics.add("numOutputRows", out.num_rows)
                yield out
            return
        store = self.runtime.store
        staged: list = []
        with self._stage_lock:
            self._staged[p] = staged
        for batch in self.children[0].execute_partition(p):
            staged.append(store.register(copy_batch(batch),
                                         SpillPriorities.CACHED))
            self.metrics.add("cacheWrites", 1)
            self.metrics.add("numOutputRows", batch.num_rows)
            yield batch
        n_parts = self.children[0].num_partitions
        with self._stage_lock:
            self._complete.add(p)
            if len(self._complete) < n_parts:
                return
            parts = [self._staged.get(i, []) for i in range(n_parts)]
            self._staged, self._complete = {}, set()
        self.slot.publish(parts)

    def close(self) -> None:
        """Free what a partial drain (a LIMIT, an error) staged."""
        with self._stage_lock:
            staged, self._staged = self._staged, {}
            self._complete = set()
        for handles in staged.values():
            for h in handles:
                h.close()
