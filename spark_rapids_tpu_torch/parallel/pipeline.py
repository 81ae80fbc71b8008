"""Bounded background stages.

Counterpart of ``prefetch`` in ``spark_rapids_tpu/parallel/pipeline.py``:
a generator runs on a thread of its own behind a bounded channel, so
its host work (Parquet decode, host copies, the upload's enqueue, the
result fetch) overlaps its consumer's.  The contract is the JAX one:

- order is preserved;
- a producer's exception is raised at the consumer, after the items
  produced before it;
- closing the consumer (or leaving it by ``break`` or an exception)
  aborts the stage: the producer wakes from a blocked put, its
  generator is closed on the producer thread (its ``finally`` blocks
  run there), and the thread is joined;
- depth <= 0 runs the generator inline.

The JAX module's thread-local conf hop is not needed: the port's conf
belongs to its session, and the planner hands each exec what it reads.
Its deferred readbacks (``pipelined``, ``device_read*``,
``ReadbackFuture``, ``device_read_async``) are not ported: the port's
dynamic shapes sync inside ops (boolean masks, ``nonzero``, the
exchange's ``bincount(...).tolist()``), so a deferred readback would
have nothing to defer until those syncs are explicit.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Iterable, Iterator, Optional

from spark_rapids_tpu_torch import config as C

#: name prefix of every stage's producer thread
STAGE_THREAD_PREFIX = "srt-pipe-"


def stage_depth(conf: C.TorchConf) -> int:
    """Queue depth of a pipeline stage under ``conf``; 0 = inline."""
    if not conf.get(C.PIPELINE_ENABLED):
        return 0
    return conf.get(C.PIPELINE_DEPTH)


class StageMetrics:
    """Counters of one named stage, accumulated across queries: items,
    queue occupancy sampled at each consumer pop, and the time each
    side spent blocked on the other."""

    __slots__ = ("name", "depth", "items", "occupancy_sum", "samples",
                 "producer_wait_ns", "consumer_wait_ns", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.depth = 0
        self.items = 0
        self.occupancy_sum = 0
        self.samples = 0
        self.producer_wait_ns = 0
        self.consumer_wait_ns = 0
        self._lock = threading.Lock()

    def snapshot(self) -> dict:
        with self._lock:
            occ = self.occupancy_sum / self.samples if self.samples else 0.0
            return {"depth": self.depth, "items": self.items,
                    "avg_occupancy": occ,
                    "occupancy_fraction": occ / self.depth
                    if self.depth else 0.0,
                    "producer_wait_s": self.producer_wait_ns / 1e9,
                    "consumer_wait_s": self.consumer_wait_ns / 1e9}


_STAGES: dict[str, StageMetrics] = {}
_STAGES_LOCK = threading.Lock()


def _stage_metrics(name: str) -> StageMetrics:
    with _STAGES_LOCK:
        m = _STAGES.get(name)
        if m is None:
            m = _STAGES[name] = StageMetrics(name)
        return m


def stage_snapshot(prefix: Optional[str] = None) -> dict[str, dict]:
    """Each stage's counters so far (those whose name starts with
    ``prefix``)."""
    with _STAGES_LOCK:
        stages = list(_STAGES.values())
    return {m.name: m.snapshot() for m in stages
            if prefix is None or m.name.startswith(prefix)}


def reset_stage_counters() -> None:
    """Forget every stage's counters (between measured queries)."""
    with _STAGES_LOCK:
        _STAGES.clear()


def live_stage_threads() -> int:
    """Stage producer threads alive now: 0 once a query has unwound."""
    return sum(1 for t in threading.enumerate()
               if t.name.startswith(STAGE_THREAD_PREFIX))


class _Chan:
    """Bounded channel: the producer blocks in ``put`` while it is full,
    the consumer in ``pop`` while it is empty, and ``abort`` wakes
    both."""

    __slots__ = ("depth", "buf", "lock", "not_full", "not_empty", "done",
                 "aborted", "error")

    def __init__(self, depth: int):
        self.depth = depth
        self.buf: deque = deque()
        self.lock = threading.Lock()
        self.not_full = threading.Condition(self.lock)
        self.not_empty = threading.Condition(self.lock)
        self.done = False
        self.aborted = False
        # written under the lock in finish(); the consumer reads it only
        # after pop() returned (None, False), which orders the two
        self.error: Optional[BaseException] = None

    def put(self, item, m: StageMetrics) -> bool:
        """False once the consumer aborted: the producer stops."""
        with self.not_full:
            if len(self.buf) >= self.depth and not self.aborted:
                t0 = time.perf_counter_ns()
                while len(self.buf) >= self.depth and not self.aborted:
                    self.not_full.wait()
                with m._lock:
                    m.producer_wait_ns += time.perf_counter_ns() - t0
            if self.aborted:
                return False
            self.buf.append(item)
            self.not_empty.notify()
            return True

    def finish(self, error: Optional[BaseException]) -> None:
        with self.not_empty:
            self.error = self.error or error
            self.done = True
            self.not_empty.notify_all()

    def pop(self, m: StageMetrics):
        """(item, True), or (None, False) once the stream has ended."""
        with self.not_empty:
            # sampled before waiting, so a starved stage reads 0
            with m._lock:
                m.occupancy_sum += len(self.buf)
                m.samples += 1
            if not self.buf and not self.done:
                t0 = time.perf_counter_ns()
                while not self.buf and not self.done:
                    self.not_empty.wait()
                with m._lock:
                    m.consumer_wait_ns += time.perf_counter_ns() - t0
            if self.buf:
                with m._lock:
                    m.items += 1
                item = self.buf.popleft()
                self.not_full.notify()
                return item, True
            return None, False

    def abort(self) -> None:
        with self.lock:
            self.aborted = True
            self.buf.clear()
            self.not_full.notify_all()
            self.not_empty.notify_all()


def prefetch(gen: Iterable, depth: int, stage: str = "stage") -> Iterator:
    """Run ``gen`` on a background thread behind a channel of ``depth``
    items (one pipeline stage), under the contract in the module
    docstring.  ``depth`` <= 0 yields from ``gen`` inline."""
    if depth <= 0:
        yield from gen
        return
    m = _stage_metrics(stage)
    with m._lock:
        m.depth = max(m.depth, depth)
    chan = _Chan(depth)

    def produce() -> None:
        err: Optional[BaseException] = None
        try:
            try:
                for item in gen:
                    if not chan.put(item, m):
                        return
            except BaseException as e:  # noqa: BLE001 - raised at consumer
                err = e
        finally:
            close = getattr(gen, "close", None)
            if close is not None:
                try:
                    close()
                except BaseException as e:  # noqa: BLE001
                    err = err or e
            chan.finish(err)

    t = threading.Thread(target=produce, daemon=True,
                         name=f"{STAGE_THREAD_PREFIX}{stage}")
    t.start()
    try:
        while True:
            item, ok = chan.pop(m)
            if not ok:
                break
            yield item
        if chan.error is not None:
            raise chan.error
    finally:
        chan.abort()
        t.join()
