"""Shuffle exchange and partition coalescing.

``TpuShuffleExchangeExec`` is the counterpart of the exec of the same
name in ``spark_rapids_tpu/execs/exchange.py``: the map stage gives
every child batch its partition ids, splits it, and commits the slices
to the session's shuffle manager; each reduce partition then reads its
blocks.  The map stage runs once, under a lock, whichever reduce
partition first asks for it (several threads ask at once when the
exchange sits under another exchange's map tasks), and its map tasks
run on a pool of ``sql.taskThreads`` threads (``execs/base.py::
run_tasks``), each holding a permit of the session's task semaphore
from its child's first batch to its end.  The manager hands blocks back
in map-task order, so the pool changes no result.

A reduce partition reads its blocks concatenated, in that order, into
batches of up to ``batch_rows`` rows (``sql.batchSizeRows``), as the
reference's GpuShuffleCoalesceExec coalesces shuffle reads.  The JAX
exchange yields block by block; here that made block counts multiply
by the partition count at every level of a chain of partition-wise
joins (a join yields a batch per stream block, the next exchange splits
each into every partition): TPC-DS q13's fourth join ran 3 072 joins
of a few hundred rows each.

- Hash partitioning: each map batch's key tuple is hashed to partition
  ids (murmur3-pmod) by one K1 launch.
- Range partitioning: bounds must exist before any batch is split, and
  they come from a sample of the whole input, so the map stage makes
  two passes, each on the pool (``_run_range_map_stage`` there).  Pass
  1 drains every map task, parks its batches and samples
  ``samplesPerBatch`` rows (with replacement) from each; the bounds come
  from the samples pooled in map order; pass 2 splits the parked
  batches by their rows' buckets.  A batch's sample positions come
  from a ``numpy.random.Generator`` seeded with (``RANGE_SAMPLE_SEED``,
  map task, batch index), so the bounds do not depend on which thread
  ran first; the sorted output does not depend on them at all.  No K1
  launch.

``TpuCoalescePartitionsExec`` (``execs/coalesce.py`` there) pulls every
child partition into one, the "exchange" of a grand aggregate: on the
pool, each worker holding a permit while it pulls, and yielded in
partition order through a reorder window of at most 2 x threads
batches, so a grand sum adds in the serial order.
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from typing import Iterator, Optional, Union

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    concat_batches,
)
from spark_rapids_tpu_torch.execs.base import (
    POOL_THREAD_PREFIX,
    TaskRuntime,
    TpuExec,
    run_tasks,
)
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.ops.partition import (
    HashPartitioning,
    RangePartitioning,
    split_batch,
)
from spark_rapids_tpu_torch.ops.range_partition import choose_bounds
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager

#: seed of the range exchange's sample positions (the JAX package's)
RANGE_SAMPLE_SEED = 0x52414E47


class TpuShuffleExchangeExec(TpuExec):
    def __init__(self, partitioning: Union[HashPartitioning,
                                           RangePartitioning],
                 child: TpuExec, manager: ShuffleManager,
                 samples_per_batch: int = 128,
                 runtime: Optional[TaskRuntime] = None,
                 batch_rows: int = 1 << 20):
        """``samples_per_batch``: rows a range exchange samples from each
        map batch (``spark.rapids.tpu.sql.sort.samplesPerBatch``);
        ``runtime``: the session's pool size and task semaphore (None:
        serial); ``batch_rows``: the most rows of a batch a reduce
        partition yields, unless one block holds more."""
        super().__init__(child)
        self.partitioning = partitioning.bind(child.schema)
        self.manager = manager
        self.samples_per_batch = samples_per_batch
        self.runtime = runtime or TaskRuntime.serial()
        self.batch_rows = batch_rows
        self._map_lock = threading.Lock()
        self._shuffle_id: Optional[int] = None

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    @property
    def num_partitions(self) -> int:
        return self.partitioning.num_partitions

    @property
    def output_partitioning(self) -> Union[HashPartitioning,
                                           RangePartitioning]:
        return self.partitioning

    def node_desc(self) -> str:
        return f"TpuShuffleExchangeExec {self.partitioning.describe()}"

    def _blocks(self, batch: ColumnarBatch, pids: torch.Tensor
                ) -> list[tuple[int, ColumnarBatch]]:
        """The batch split by partition id: its non-empty blocks."""
        return [(rid, sub) for rid, sub in enumerate(
            split_batch(batch, pids, self.num_partitions)) if sub.num_rows]

    def _map_task(self, shuffle_id: int, child_part: int) -> None:
        sem, task = self.runtime.semaphore, object()
        blocks: list[tuple[int, ColumnarBatch]] = []
        try:
            for batch in self.children[0].execute_partition(child_part):
                sem.acquire_if_necessary(task)
                if batch.num_rows:
                    blocks += self._blocks(
                        batch, self.partitioning.partition_ids(batch))
            self.manager.commit_task(shuffle_id, child_part, blocks)
        finally:
            sem.release_if_necessary(task)

    def _sample_task(self, child_part: int
                     ) -> tuple[list[ColumnarBatch], list[ColumnarBatch]]:
        """Range pass 1 for one map task: (its non-empty batches, a
        sample of each's keys)."""
        part = self.partitioning
        sem, task = self.runtime.semaphore, object()
        parked: list[ColumnarBatch] = []
        samples: list[ColumnarBatch] = []
        try:
            for i, batch in enumerate(
                    self.children[0].execute_partition(child_part)):
                sem.acquire_if_necessary(task)
                if batch.num_rows == 0:
                    continue
                rng = np.random.default_rng(
                    (RANGE_SAMPLE_SEED, child_part, i))
                pos = rng.integers(0, batch.num_rows, self.samples_per_batch)
                samples.append(part.key_batch(batch).gather(
                    torch.from_numpy(pos).to(batch.device)))
                parked.append(batch)
        finally:
            sem.release_if_necessary(task)
        return parked, samples

    def _range_map_stage(self, shuffle_id: int) -> None:
        part = self.partitioning
        threads = self.runtime.task_threads
        tasks = run_tasks(self._sample_task, self.children[0].num_partitions,
                          threads)
        parked = [b for batches, _ in tasks for b in batches]
        if not parked:
            return
        bounds = choose_bounds(concat_batches([s for _, ss in tasks
                                               for s in ss]),
                               part.key_orders(), self.num_partitions)
        sem = self.runtime.semaphore

        def split(i: int) -> None:
            task = object()
            sem.acquire_if_necessary(task)
            try:
                self.manager.commit_task(shuffle_id, i, self._blocks(
                    parked[i], part.partition_ids_with_bounds(parked[i],
                                                              bounds)))
            finally:
                sem.release_if_necessary(task)

        run_tasks(split, len(parked), threads)

    def _ensure_map_stage(self) -> int:
        with self._map_lock:
            if self._shuffle_id is None:
                sid = self.manager.new_shuffle_id()
                try:
                    if isinstance(self.partitioning, RangePartitioning):
                        self._range_map_stage(sid)
                    else:
                        run_tasks(lambda p: self._map_task(sid, p),
                                  self.children[0].num_partitions,
                                  self.runtime.task_threads)
                except BaseException:
                    self.manager.unregister(sid)
                    raise
                self._shuffle_id = sid
            return self._shuffle_id

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        pending: list[ColumnarBatch] = []
        rows = 0
        for block in self.manager.read(self._ensure_map_stage(), p):
            if pending and rows + block.num_rows > self.batch_rows:
                yield concat_batches(pending)
                pending, rows = [], 0
            pending.append(block)
            rows += block.num_rows
        if pending:
            yield concat_batches(pending)

    def close(self) -> None:
        """Drop this exchange's blocks."""
        with self._map_lock:
            if self._shuffle_id is not None:
                self.manager.unregister(self._shuffle_id)
                self._shuffle_id = None


class _ReorderWindow:
    """Batches that several workers pull from the partitions of one
    child, handed to one consumer in partition order.  At most
    ``capacity`` batches wait: the worker of the head partition (the
    one the consumer is taking) may fill the window, any other only up
    to ``capacity - 1``, so the head always has room and the consumer
    always moves."""

    def __init__(self, n_parts: int, capacity: int):
        self.cv = threading.Condition()
        self.bufs: list[deque] = [deque() for _ in range(n_parts)]
        self.done = [False] * n_parts
        self.head = 0
        self.size = 0
        self.capacity = capacity
        self.aborted = False
        self.error: Optional[BaseException] = None

    def _room(self, p: int) -> bool:
        return self.size < self.capacity - (p != self.head)

    def put(self, p: int, batch: ColumnarBatch, on_block) -> bool:
        """Queue ``batch`` of partition ``p``, calling ``on_block`` first
        if it must wait for room; False once the consumer aborted."""
        with self.cv:
            if not self._room(p) and not self.aborted:
                on_block()
                while not self._room(p) and not self.aborted:
                    self.cv.wait()
            if self.aborted:
                return False
            self.bufs[p].append(batch)
            self.size += 1
            self.cv.notify_all()
            return True

    def finish(self, p: int) -> None:
        with self.cv:
            self.done[p] = True
            self.cv.notify_all()

    def fail(self, error: BaseException) -> None:
        with self.cv:
            self.error = self.error or error
            self.cv.notify_all()

    def pop(self) -> Optional[ColumnarBatch]:
        """The next batch in partition order; None after the last."""
        with self.cv:
            while True:
                if self.error is not None:
                    raise self.error
                if self.head == len(self.bufs):
                    return None
                if self.bufs[self.head]:
                    self.size -= 1
                    self.cv.notify_all()
                    return self.bufs[self.head].popleft()
                if self.done[self.head]:
                    self.head += 1
                    self.cv.notify_all()
                    continue
                self.cv.wait()

    def abort(self) -> None:
        with self.cv:
            self.aborted = True
            for b in self.bufs:
                b.clear()
            self.cv.notify_all()


def drain_in_order(child: TpuExec, threads: int,
                   sem: TpuSemaphore) -> Iterator[ColumnarBatch]:
    """Every partition of ``child``, pulled by ``threads`` workers (each
    takes the next partition not yet taken) and yielded in partition
    order (``_ReorderWindow``, 2 x ``threads`` batches).  A worker holds
    a permit from its partition's first batch to its end, and gives it
    back while it waits for room, so a worker the consumer waits on can
    always get one.  A failure in any worker is raised here; leaving
    early stops the workers, closes their partitions and joins them."""
    n = child.num_partitions
    window = _ReorderWindow(n, 2 * threads)
    parts = iter(range(n))
    parts_lock = threading.Lock()

    def worker() -> None:
        try:
            while True:
                with parts_lock:
                    p = next(parts, None)
                if p is None:
                    return
                task = object()
                try:
                    with contextlib.closing(child.execute_partition(p)) as it:
                        for batch in it:
                            sem.acquire_if_necessary(task)
                            if not window.put(
                                    p, batch,
                                    lambda: sem.release_if_necessary(task)):
                                return
                            sem.acquire_if_necessary(task)
                finally:
                    sem.release_if_necessary(task)
                window.finish(p)
        except BaseException as e:  # noqa: BLE001 - raised at the consumer
            window.fail(e)

    workers = [threading.Thread(target=worker, daemon=True,
                                name=f"{POOL_THREAD_PREFIX}coalesce")
               for _ in range(min(threads, n))]
    for w in workers:
        w.start()
    try:
        while True:
            batch = window.pop()
            if batch is None:
                return
            yield batch
    finally:
        window.abort()
        for w in workers:
            w.join()


class TpuCoalescePartitionsExec(TpuExec):
    def __init__(self, child: TpuExec,
                 runtime: Optional[TaskRuntime] = None):
        super().__init__(child)
        self.runtime = runtime or TaskRuntime.serial()

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    @property
    def num_partitions(self) -> int:
        return 1

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        child = self.children[0]
        threads = min(self.runtime.task_threads, child.num_partitions)
        if threads <= 1:
            yield from child.execute()
            return
        yield from drain_in_order(child, threads, self.runtime.semaphore)
