"""In-process shuffle block storage.

Counterpart of ``spark_rapids_tpu/shuffle/manager.py``: map tasks write
device-resident blocks keyed by (shuffle, reduce partition), reduce
tasks read them back.  Blocks stay on the device; there is no spill in
this slice.  A session owns one manager.

Map tasks run on a pool and commit in whatever order they end; a reduce
partition still reads its blocks in map-task order (the JAX manager
keeps commit order), so a pooled run's float sums add in the serial
run's order and its results equal the serial run's bit for bit.
"""

from __future__ import annotations

import threading

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch


class ShuffleManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._next_id = 0
        #: shuffle -> reduce id -> map task -> its blocks, in order
        self._blocks: dict[int, dict[int, dict[int, list[ColumnarBatch]]]] \
            = {}

    def new_shuffle_id(self) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self._blocks[sid] = {}
            return sid

    def commit_task(self, shuffle_id: int, map_index: int,
                    blocks: list[tuple[int, ColumnarBatch]]) -> None:
        """Publish map task ``map_index``'s (reduce id, batch) blocks at
        once; a task commits once."""
        with self._lock:
            parts = self._blocks[shuffle_id]
            for rid, b in blocks:
                parts.setdefault(rid, {}).setdefault(map_index, []).append(b)

    def read(self, shuffle_id: int, reduce_id: int) -> list[ColumnarBatch]:
        """A reduce partition's blocks, in map-task order."""
        with self._lock:
            by_task = self._blocks[shuffle_id].get(reduce_id, {})
            return [b for m in sorted(by_task) for b in by_task[m]]

    def unregister(self, shuffle_id: int) -> None:
        with self._lock:
            self._blocks.pop(shuffle_id, None)
