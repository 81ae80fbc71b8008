"""In-process shuffle block storage.

Counterpart of ``spark_rapids_tpu/shuffle/manager.py``: map tasks write
device-resident blocks keyed by (shuffle, reduce partition), reduce
tasks read them back.  Blocks stay on the device; there is no spill in
this slice.  A session owns one manager.
"""

from __future__ import annotations

import threading

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch


class ShuffleManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._next_id = 0
        self._blocks: dict[int, dict[int, list[ColumnarBatch]]] = {}

    def new_shuffle_id(self) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self._blocks[sid] = {}
            return sid

    def commit_task(self, shuffle_id: int,
                    blocks: list[tuple[int, ColumnarBatch]]) -> None:
        """Publish one map task's (reduce id, batch) blocks at once."""
        with self._lock:
            parts = self._blocks[shuffle_id]
            for rid, b in blocks:
                parts.setdefault(rid, []).append(b)

    def read(self, shuffle_id: int, reduce_id: int) -> list[ColumnarBatch]:
        with self._lock:
            return list(self._blocks[shuffle_id].get(reduce_id, ()))

    def unregister(self, shuffle_id: int) -> None:
        with self._lock:
            self._blocks.pop(shuffle_id, None)
