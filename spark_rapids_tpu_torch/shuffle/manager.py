"""In-process shuffle block storage.

Counterpart of ``spark_rapids_tpu/shuffle/manager.py``: map tasks
commit blocks keyed by (shuffle, reduce partition), reduce tasks read
them back.  A block lives in the buffer store at ``OUTPUT_FOR_SHUFFLE``
priority, the first thing spilled under pressure, and unpinned; a read
acquires it (restoring it if it spilled) and unpins it once the reader
moves on.  The exchange releases a reduce partition it has read to its
end (its blocks close) and unregisters the shuffle at ``close()``,
which closes the rest.  A session owns one manager.

A commit also records each reduce partition's (bytes, rows), the
bytes each block holds in the store: ``partition_stats`` hands them to
the adaptive join (``execs/adaptive.py``), as Spark's
MapOutputStatistics.  The blocks hold live rows only (no power-of-two
capacity, no string width buckets), so these bytes may be fewer than
the JAX manager's for the same data.  ``read_keep`` reads a partition
and leaves its blocks registered, for a reader that visits it more than
once (a skew split's slices).

Map tasks run on a pool and commit in whatever order they end; a reduce
partition still reads its blocks in map-task order (the JAX manager
keeps commit order), so a pooled run's float sums add in the serial
run's order and its results equal the serial run's bit for bit.
"""

from __future__ import annotations

import threading
from typing import Iterator

from spark_rapids_tpu_torch import trace as _trace
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.memory.store import SpillableBatch


class ShuffleManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._next_id = 0
        #: shuffle -> reduce id -> map task -> its block handles, in order
        self._blocks: dict[int, dict[int, dict[int, list[SpillableBatch]]]] \
            = {}
        #: shuffle -> reduce id -> [bytes, rows] committed
        self._stats: dict[int, dict[int, list[int]]] = {}

    def new_shuffle_id(self) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self._blocks[sid] = {}
            self._stats[sid] = {}
            return sid

    def commit_task(self, shuffle_id: int, map_index: int,
                    blocks: list[tuple[int, SpillableBatch, int]]) -> None:
        """Publish map task ``map_index``'s (reduce id, registered block,
        rows) triples at once; a task commits once, and only a task that
        ran to its end commits (a failed attempt closes its own
        blocks)."""
        if blocks and _trace.TRACER.enabled:
            _trace.event("shuffle.block.send", shuffle=shuffle_id,
                         blocks=len(blocks),
                         bytes=sum(h.nbytes for _r, h, _n in blocks),
                         rows=sum(n for _r, _h, n in blocks))
        with self._lock:
            parts = self._blocks[shuffle_id]
            stats = self._stats[shuffle_id]
            for rid, h, rows in blocks:
                parts.setdefault(rid, {}).setdefault(map_index, []).append(h)
                st = stats.setdefault(rid, [0, 0])
                st[0] += h.nbytes
                st[1] += rows

    def _handles(self, shuffle_id: int, reduce_id: int
                 ) -> list[SpillableBatch]:
        """A reduce partition's block handles, in map-task order."""
        with self._lock:
            by_task = self._blocks[shuffle_id].get(reduce_id, {})
            return [h for m in sorted(by_task) for h in by_task[m]]

    def partition_stats(self, shuffle_id: int, n_partitions: int
                        ) -> list[tuple[int, int]]:
        """Each reduce partition's committed (bytes, rows)."""
        with self._lock:
            stats = self._stats[shuffle_id]
            return [tuple(stats.get(rid, (0, 0)))
                    for rid in range(n_partitions)]

    def block_counts(self, shuffle_id: int, n_partitions: int) -> list[int]:
        """Each reduce partition's committed blocks: the most skew slices
        of it that can hold rows (slices deal blocks)."""
        return [len(self._handles(shuffle_id, rid))
                for rid in range(n_partitions)]

    def read(self, shuffle_id: int, reduce_id: int, slice_index: int = 0,
             slice_count: int = 1) -> Iterator[ColumnarBatch]:
        """A reduce partition's blocks, in map-task order, each on the
        device while the reader holds it; with ``slice_count`` k > 1,
        only the blocks whose place in that order is ``slice_index``
        modulo k.  The blocks stay registered (``release`` closes
        them)."""
        handles = self._handles(shuffle_id, reduce_id)
        for h in handles[slice_index::slice_count]:
            if _trace.TRACER.enabled:
                with _trace.span("shuffle.block.recv", shuffle=shuffle_id,
                                 reduce=reduce_id, bytes=h.nbytes):
                    b = h.get()
            else:
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

    #: the JAX manager's read that leaves the blocks registered: every
    #: read here does, the exchange releases a partition apart
    read_keep = read

    def unregister(self, shuffle_id: int) -> None:
        """Close the shuffle's blocks and forget its statistics."""
        with self._lock:
            parts = self._blocks.pop(shuffle_id, {})
            self._stats.pop(shuffle_id, None)
        for by_task in parts.values():
            for hs in by_task.values():
                for h in hs:
                    h.close()
