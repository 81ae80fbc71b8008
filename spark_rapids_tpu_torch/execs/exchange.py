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

Map output lives in the buffer store (``shuffle/manager.py``): a map
task parks each block at ``OUTPUT_FOR_SHUFFLE`` priority as it makes
it and commits them all at its end, so a failed attempt leaves none
behind.  A map task runs under ``with_task_retries`` and each of its
batches under ``with_split_retry`` (``execs/retry.py``), as in the JAX
exchange; ``metrics`` counts the batches of committed attempts
(``mapBatches``), the ladder's runs over them (``mapBatchRuns``: one
K1 launch each), the map tasks (``mapTasks``) and the rows their
committed blocks hold (``shuffleWriteRows``), the last two as JAX's.

A map batch's split needs its per-partition counts on the host (tag
``exchange.split``).  With speculative sizing on
(``parallel/speculation.py``, the default) they ride an asynchronous
read (``device_read_async``) and the batch waits, grouped, in a deque
of at most ``stage_depth + 1`` entries: the head is finished (sliced
and parked) as soon as its read has landed, the head past the bound is
finished blocking, and at the task's end every entry is finished
before ``commit_task``.  The bound is there because a grouped batch in
flight is device memory the store cannot see yet.  Each finish is a
retry transaction of its own (``run_with_oom_retry``) that rolls back
only its own slices.  Off, the counts are read blocking in the
retire half, one batch behind the dispatch.

- Hash partitioning: each map batch's key tuple is hashed to partition
  ids (murmur3-pmod) by one K1 launch.
- Round-robin and single partitioning: no K1.  A round-robin map task
  starts its rows at partition ``task % n``, as the JAX exchange does,
  so the output stays balanced when every task holds one batch.
- Range partitioning: bounds must exist before any batch is split, and
  they come from a sample of the whole input, so the map stage makes
  two passes, each on the pool (``_run_range_map_stage`` there).  Pass
  1 drains every map task, parks its batches in the store at
  ``COALESCE_PENDING`` and samples
  ``samplesPerBatch`` rows (with replacement) from each; the bounds come
  from the samples pooled in map order; pass 2 splits the parked
  batches by their rows' buckets.  A batch's sample positions come
  from a ``numpy.random.Generator`` seeded with (``RANGE_SAMPLE_SEED``,
  map task, batch index), so the bounds do not depend on which thread
  ran first; the sorted output does not depend on them at all.  No K1
  launch.

The map stage doubles as a query stage for the adaptive join
(``execs/adaptive.py``): ``materialize_stats`` runs it and returns each
reduce partition's (bytes, rows), ``block_counts`` its blocks, and
``execute_partition_keep`` reads a partition, or one block-wise slice of
it, without releasing it; the blocks go at ``close()``.  A slice takes
the blocks whose place in map-task order is ``i`` modulo ``k`` and
concatenates only those, so every slice of a partition of ``k`` or more
blocks holds rows.

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

from spark_rapids_tpu_torch import trace as _trace
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    concat_batches,
)
from spark_rapids_tpu_torch.execs.base import (
    POOL_THREAD_PREFIX,
    Metrics,
    TaskRuntime,
    TpuExec,
    run_tasks,
)
from spark_rapids_tpu_torch.execs.jit_cache import exprs_key
from spark_rapids_tpu_torch.execs.retry import (
    guarded_pipeline,
    run_with_oom_retry,
    with_task_retries,
)
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.memory.store import (
    SpillableBatch,
    SpillPriorities,
)
from spark_rapids_tpu_torch.ops.partition import (
    HashPartitioning,
    RangePartitioning,
    RoundRobinPartitioning,
    SinglePartitioning,
    split_batch,
    split_batch_dispatch,
    split_batch_finish,
)
from spark_rapids_tpu_torch.ops.range_partition import choose_bounds
from spark_rapids_tpu_torch.parallel.pipeline import (
    device_read,
    device_read_async,
    pipelined,
)
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager
from spark_rapids_tpu_torch.serving.cancel import (
    attach_token,
    check_point,
    current_token,
)

#: seed of the range exchange's sample positions (the JAX package's)
RANGE_SAMPLE_SEED = 0x52414E47


#: the partitionings an exchange takes
Partitioning = Union[HashPartitioning, RangePartitioning,
                     RoundRobinPartitioning, SinglePartitioning]


class TpuShuffleExchangeExec(TpuExec):
    def __init__(self, partitioning: Partitioning,
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
        #: reduce partitions of the current shuffle read and released
        self._released: set[int] = set()
        #: hash map stage: the non-empty batches its committed attempts
        #: split, and the runs of the split ladder over them (more than
        #: the batches when the ladder re-ran or bisected one; each run
        #: launches K1 once)
        self.metrics = Metrics("mapBatches", "mapBatchRuns", "mapTasks",
                               "shuffleWriteRows")

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    @property
    def num_partitions(self) -> int:
        return self.partitioning.num_partitions

    @property
    def output_partitioning(self) -> Partitioning:
        return self.partitioning

    def node_desc(self) -> str:
        return f"TpuShuffleExchangeExec {self.partitioning.describe()}"

    def _blocks(self, batch: ColumnarBatch, pids: torch.Tensor
                ) -> list[tuple[int, ColumnarBatch]]:
        """The batch split by partition id: its non-empty blocks."""
        return [(rid, sub) for rid, sub in enumerate(
            split_batch(batch, pids, self.num_partitions)) if sub.num_rows]

    def _park(self, blocks: list, rid: int, sub: ColumnarBatch) -> None:
        blocks.append((rid, self.runtime.store.register(
            sub, SpillPriorities.OUTPUT_FOR_SHUFFLE), sub.num_rows))

    def _map_task(self, shuffle_id: int, child_part: int) -> None:
        with _trace.span("exchange.task", task=child_part):
            with_task_retries(lambda: self._map_task_attempt(shuffle_id,
                                                             child_part),
                              f"map task {child_part}", self.runtime.retry)
        self.metrics.add("mapTasks", 1)

    @staticmethod
    def _split_dispatch(part, batch: ColumnarBatch, n_parts: int):
        """The map program: partition ids (K1 for a hash exchange) and
        the rows grouped by them, with their counts still on the
        device; (batch, None) for one partition."""
        pids = part.partition_ids(batch)
        if n_parts == 1:
            return batch, None
        return split_batch_dispatch(batch, pids, n_parts)

    def _map_task_attempt(self, shuffle_id: int, child_part: int) -> None:
        """One attempt of a map task, a pipelined loop (JAX
        ``_map_task``): batch k+1's ids and grouping are dispatched
        before batch k's counts are read back (``exchange.split``;
        asynchronously under speculation, the module docstring).  Each
        batch is a unit of the split ladder; its blocks are parked in
        the store as they are made and published only when the attempt
        commits, so a failed attempt leaves none behind."""
        sem, task = self.runtime.semaphore, object()
        blocks: list[tuple[int, SpillableBatch, int]] = []
        batches = runs = 0
        n_parts = self.num_partitions
        part = self.partitioning
        if isinstance(part, RoundRobinPartitioning):
            part = RoundRobinPartitioning(part.num_partitions,
                                          child_part % part.num_partitions)
        # the key names the partitioning's expressions: each exchange
        # of a query is its own program
        split = self.program("exchange.split", lambda: (
            n_parts, type(part).__name__,
            exprs_key(getattr(part, "exprs", ()))), self._split_dispatch)
        spec_on = self.runtime.speculation.enabled
        #: (grouped batch, count future) waiting for its counts
        inflight: deque = deque()
        max_inflight = self.runtime.stage_depth + 1

        def park_all(grouped: ColumnarBatch, counts) -> None:
            """Slice a grouped batch by its host counts and park the
            non-empty slices; on failure, close what this call
            parked."""
            n0 = len(blocks)
            try:
                subs = [grouped] if counts is None else \
                    split_batch_finish(grouped, counts)
                for rid, sub in enumerate(subs):
                    if sub.num_rows:
                        self._park(blocks, rid, sub)
            except BaseException:
                for _rid, h, _n in blocks[n0:]:
                    h.close()
                del blocks[n0:]
                raise

        def finish(item) -> None:
            """Park one in-flight batch once its counts are here: a
            retry transaction of its own (a re-run reads the resolved
            future again for free)."""
            grouped, fut = item
            with self.timer():
                run_with_oom_retry(lambda: park_all(grouped, fut.result()),
                                   "exchange.finish",
                                   policy=self.runtime.retry)

        def dispatch(batch: ColumnarBatch):
            nonlocal runs
            runs += 1
            with self.timer() as t:
                return t.observe(split(part, batch, n_parts))

        def retire(entry):
            grouped, counts = entry
            if counts is None:
                with self.timer():
                    park_all(grouped, None)
            elif spec_on:
                inflight.append((grouped, device_read_async(
                    counts, tag="exchange.split")))
            else:
                with self.timer():
                    park_all(grouped, device_read(counts,
                                                  tag="exchange.split"))
            return ()

        def finish_arrived() -> None:
            """Outside the ladder: finish the head while its counts have
            arrived, or while the deque is past its bound."""
            while inflight and (inflight[0][1].done()
                                or len(inflight) > max_inflight):
                finish(inflight.popleft())

        def source():
            nonlocal batches
            for batch in self.children[0].execute_partition(child_part):
                check_point()
                sem.acquire_if_necessary(task)
                if batch.num_rows:
                    batches += 1
                    yield batch

        dispatch_guarded, retire_guarded = guarded_pipeline(
            dispatch, retire, "exchange.map", self.runtime.retry,
            after=finish_arrived if spec_on else None)
        try:
            for _ in pipelined(source(), dispatch_guarded, retire_guarded,
                               self.runtime.lookahead, tag="exchange.map"):
                pass
            while inflight:
                finish(inflight.popleft())
            self.manager.commit_task(shuffle_id, child_part, blocks)
            self.metrics.add("shuffleWriteRows", sum(n for *_, n in blocks))
        except BaseException:
            inflight.clear()
            for _rid, h, _n in blocks:
                h.close()
            raise
        finally:
            sem.release_if_necessary(task)
            self.metrics.add("mapBatchRuns", runs)
        self.metrics.add("mapBatches", batches)

    def _sample_task(self, child_part: int
                     ) -> tuple[list[SpillableBatch], list[ColumnarBatch]]:
        """Range pass 1 for one map task: (its non-empty batches, parked
        in the store, and a sample of each's keys)."""
        return with_task_retries(lambda: self._sample_attempt(child_part),
                                 f"range pass1 {child_part}",
                                 self.runtime.retry)

    def _sample_attempt(self, child_part: int
                        ) -> tuple[list[SpillableBatch], list[ColumnarBatch]]:
        part = self.partitioning
        sem, task = self.runtime.semaphore, object()
        parked: list[SpillableBatch] = []
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
                parked.append(self.runtime.store.register(
                    batch, SpillPriorities.COALESCE_PENDING))
        except BaseException:
            for h in parked:
                h.close()
            raise
        finally:
            sem.release_if_necessary(task)
        return parked, samples

    def _range_map_stage(self, shuffle_id: int) -> None:
        part = self.partitioning
        threads = self.runtime.task_threads
        tasks = run_tasks(self._sample_task, self.children[0].num_partitions,
                          threads)
        parked = [h for handles, _ in tasks for h in handles]
        try:
            if parked:
                bounds = choose_bounds(concat_batches(
                    [s for _, ss in tasks for s in ss]), part.key_orders(),
                    self.num_partitions)
                run_tasks(lambda i: self._range_split(shuffle_id, i,
                                                      parked[i], bounds),
                          len(parked), threads)
        finally:
            for h in parked:
                h.close()

    def _range_split(self, shuffle_id: int, i: int, h: SpillableBatch,
                     bounds: ColumnarBatch) -> None:
        """Range pass 2 for parked batch ``i``: its blocks, committed as
        map task ``i`` (the input is closed by the caller, after every
        attempt)."""
        part, sem = self.partitioning, self.runtime.semaphore

        def attempt() -> None:
            task = object()
            blocks: list[tuple[int, SpillableBatch, int]] = []
            sem.acquire_if_necessary(task)
            try:
                batch = h.get()
                try:
                    for rid, sub in self._blocks(
                            batch, part.partition_ids_with_bounds(batch,
                                                                  bounds)):
                        self._park(blocks, rid, sub)
                finally:
                    h.unpin()
                self.manager.commit_task(shuffle_id, i, blocks)
                self.metrics.add("shuffleWriteRows",
                                 sum(n for *_, n in blocks))
            except BaseException:
                for _rid, bh, _n in blocks:
                    bh.close()
                raise
            finally:
                sem.release_if_necessary(task)

        with_task_retries(attempt, f"range pass2 {i}", self.runtime.retry)

    def _ensure_map_stage(self) -> int:
        with self._map_lock:
            if self._shuffle_id is None:
                self._released = set()
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

    def _concat(self, blocks: list[ColumnarBatch]) -> ColumnarBatch:
        """The blocks as one batch, spill-and-retried on an OOM."""
        return run_with_oom_retry(lambda: concat_batches(blocks),
                                  "exchange.read", policy=self.runtime.retry)

    def materialize_stats(self) -> list[tuple[int, int]]:
        """Run the map stage (once) and return each reduce partition's
        (bytes, rows): the query stage the adaptive join decides on."""
        sid = self._ensure_map_stage()
        return self.manager.partition_stats(sid, self.num_partitions)

    def block_counts(self) -> list[int]:
        """Each reduce partition's committed blocks."""
        sid = self._ensure_map_stage()
        return self.manager.block_counts(sid, self.num_partitions)

    def _map_stage_for_read(self, p: int) -> int:
        """The shuffle to read ``p`` from; a partition already released
        (read twice: a test's, never a query's) maps again."""
        with self._map_lock:
            if p in self._released:
                self.manager.unregister(self._shuffle_id)
                self._shuffle_id = None
        return self._ensure_map_stage()

    def _read(self, blocks: Iterator[ColumnarBatch]
              ) -> Iterator[ColumnarBatch]:
        """A partition's blocks as batches of up to ``batch_rows``
        rows."""
        pending: list[ColumnarBatch] = []
        rows = 0
        for block in blocks:
            if pending and rows + block.num_rows > self.batch_rows:
                yield self._concat(pending)
                pending, rows = [], 0
            pending.append(block)
            rows += block.num_rows
        if pending:
            yield self._concat(pending)

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        """Partition ``p``'s blocks as batches of up to ``batch_rows``
        rows.  Read to its end, the partition is released, so a query's
        shuffle data leaves the store as its reduce side reads it."""
        sid = self._map_stage_for_read(p)
        yield from self._read(self.manager.read(sid, p))
        with self._map_lock:
            if sid == self._shuffle_id:
                self.manager.release(sid, p)
                self._released.add(p)

    def execute_partition_keep(self, p: int, slice_index: int = 0,
                               slice_count: int = 1
                               ) -> Iterator[ColumnarBatch]:
        """Slice ``slice_index`` of ``slice_count`` of partition ``p``
        (the blocks whose place in map-task order is ``slice_index``
        modulo ``slice_count``), concatenated as ``execute_partition``
        does, leaving the blocks registered: a reader that visits the
        partition again finds them, and the map stage runs once."""
        sid = self._map_stage_for_read(p)
        yield from self._read(self.manager.read_keep(sid, p, slice_index,
                                                     slice_count))

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
    ctok = current_token()

    def worker() -> None:
        try:
            while True:
                with parts_lock:
                    p = next(parts, None)
                if p is None:
                    return
                task = object()
                try:
                    with attach_token(ctok), \
                            contextlib.closing(child.execute_partition(p)) as it:
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
