"""In-process shuffle block storage.

Counterpart of ``spark_rapids_tpu/shuffle/manager.py``: map tasks
commit blocks keyed by (shuffle, reduce partition), reduce tasks read
them back.  A block lives in the buffer store at ``OUTPUT_FOR_SHUFFLE``
priority, the first thing spilled under pressure, and unpinned; a read
acquires it (restoring it if it spilled) and unpins it once the reader
moves on.  The exchange releases a reduce partition it has read to its
end (its blocks close) and unregisters the shuffle at ``close()``,
which closes the rest.  A session owns one manager.

Map tasks run on a pool and commit in whatever order they end; a reduce
partition still reads its blocks in map-task order (the JAX manager
keeps commit order), so a pooled run's float sums add in the serial
run's order and its results equal the serial run's bit for bit.
"""

from __future__ import annotations

import threading
from typing import Iterator

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.memory.store import SpillableBatch


class ShuffleManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._next_id = 0
        #: shuffle -> reduce id -> map task -> its block handles, in order
        self._blocks: dict[int, dict[int, dict[int, list[SpillableBatch]]]] \
            = {}

    def new_shuffle_id(self) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self._blocks[sid] = {}
            return sid

    def commit_task(self, shuffle_id: int, map_index: int,
                    blocks: list[tuple[int, SpillableBatch]]) -> None:
        """Publish map task ``map_index``'s (reduce id, registered block)
        pairs at once; a task commits once, and only a task that ran to
        its end commits (a failed attempt closes its own blocks)."""
        with self._lock:
            parts = self._blocks[shuffle_id]
            for rid, h in blocks:
                parts.setdefault(rid, {}).setdefault(map_index, []).append(h)

    def read(self, shuffle_id: int, reduce_id: int
             ) -> Iterator[ColumnarBatch]:
        """A reduce partition's blocks, in map-task order, each on the
        device while the reader holds it."""
        with self._lock:
            by_task = self._blocks[shuffle_id].get(reduce_id, {})
            handles = [h for m in sorted(by_task) for h in by_task[m]]
        for h in handles:
            b = h.get()
            try:
                yield b
            finally:
                h.unpin()

    def release(self, shuffle_id: int, reduce_id: int) -> None:
        """Close a reduce partition's blocks (it has been read)."""
        with self._lock:
            by_task = self._blocks[shuffle_id].pop(reduce_id, {})
        for hs in by_task.values():
            for h in hs:
                h.close()

    def unregister(self, shuffle_id: int) -> None:
        """Close the shuffle's blocks."""
        with self._lock:
            parts = self._blocks.pop(shuffle_id, {})
        for by_task in parts.values():
            for hs in by_task.values():
                for h in hs:
                    h.close()
