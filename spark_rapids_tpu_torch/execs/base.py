"""Physical operator contract, and what the execs share to run tasks.

Counterpart of ``spark_rapids_tpu/execs/base.py``'s ``TpuExec``: an
exec has a schema, a number of output partitions, and yields device
batches per partition.  An exchange's map tasks, a coalesce's
partitions and a scan task's files run on pools of host threads
(``run_tasks``, ``TaskRuntime``), as in the JAX package; every exec's
per-partition code may therefore run on several threads at once, and
what one partition writes that another reads is locked.  The batches
an exec holds between uses go through the session's buffer store, and
its stream loops run under the OOM ladder (``execs/retry.py``), both
reached through ``TaskRuntime.retry``.  No fusion, speculation or
buffer donation in this port.
"""

from __future__ import annotations

import dataclasses
import threading
from collections.abc import Mapping
from concurrent.futures import FIRST_EXCEPTION, ThreadPoolExecutor, wait
from typing import Callable, Iterator, Optional, TypeVar

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.execs.retry import DEFAULT_POLICY, RetryPolicy
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore

R = TypeVar("R")

#: name prefix of every pool thread (map tasks, coalesced partitions,
#: a scan task's file decodes)
POOL_THREAD_PREFIX = "srt-pool-"


@dataclasses.dataclass(frozen=True)
class TaskRuntime:
    """What one session's execs share to run tasks: the task semaphore,
    the pool sizes and stage depth read from its conf
    (``sql.taskThreads``, ``sql.scan.decodeThreads``,
    ``sql.pipeline.*``), the CUDA stream its scans upload on (None
    on the CPU), and its retry policy with its buffer store."""

    semaphore: TpuSemaphore
    task_threads: int = 1
    decode_threads: int = 1
    stage_depth: int = 0
    upload_stream: Optional[object] = None
    retry: RetryPolicy = DEFAULT_POLICY

    @property
    def store(self):
        """The buffer store the execs park batches in."""
        return self.retry.get_store()

    @classmethod
    def serial(cls) -> "TaskRuntime":
        """Everything on the caller's thread, one task at a time."""
        return cls(TpuSemaphore(1))


def run_tasks(fn: Callable[[int], R], n_tasks: int,
              threads: int) -> list[R]:
    """``fn(0) .. fn(n_tasks - 1)`` on a pool of ``threads`` host
    threads; their results in task order.  ``threads`` <= 1 or one task
    runs inline.  The first failure (the lowest task among those that
    failed before the rest were cancelled) is raised in the caller with
    its own type and traceback; tasks not yet started are cancelled;
    the pool's threads are joined before the call returns or raises.
    The caller's cancel token is attached on the pool threads, and each
    task starts at a checkpoint.  Counterpart of the JAX exchange's
    ``_run_tasks``."""
    from spark_rapids_tpu_torch.serving import cancel as _cancel

    if threads <= 1 or n_tasks <= 1:
        out = []
        for i in range(n_tasks):
            _cancel.check_point()
            out.append(fn(i))
        return out
    ctok = _cancel.current_token()

    def run(i: int) -> R:
        with _cancel.attach_token(ctok):
            _cancel.check_point()
            return fn(i)

    pool = ThreadPoolExecutor(max_workers=min(threads, n_tasks),
                              thread_name_prefix=POOL_THREAD_PREFIX + "task")
    try:
        futures = [pool.submit(run, i) for i in range(n_tasks)]
        wait(futures, return_when=FIRST_EXCEPTION)
        for f in futures:
            f.cancel()
        for f in futures:
            if f.done() and not f.cancelled() and f.exception() is not None:
                raise f.exception()
        return [f.result() for f in futures]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def live_pool_threads() -> int:
    """Pool threads alive now: 0 once a query has unwound."""
    return sum(1 for t in threading.enumerate()
               if t.name.startswith(POOL_THREAD_PREFIX))


class Metrics(Mapping):
    """An exec's named counters, each update atomic: tasks on several
    threads add to them at once.  Reads as a mapping."""

    def __init__(self, *names: str):
        self._lock = threading.Lock()
        self._values = dict.fromkeys(names, 0)
        #: name -> the Metrics of another exec that counts it
        self._adopted: dict[str, "Metrics"] = {}

    def add(self, name: str, n) -> None:
        with self._lock:
            self._values[name] += n

    def adopt(self, other: Mapping) -> None:
        """Read ``other``'s counters, those this one lacks, through this
        one too: live, as the exec that owns them goes on counting."""
        with self._lock:
            for name in other:
                if name not in self._values:
                    self._adopted[name] = other

    def __getitem__(self, name: str):
        with self._lock:
            if name not in self._values and name in self._adopted:
                source = self._adopted[name]
            else:
                return self._values[name]
        return source[name]

    def __iter__(self):
        with self._lock:
            return iter(list(self._values) + list(self._adopted))

    def __len__(self) -> int:
        with self._lock:
            return len(self._values) + len(self._adopted)

    def __repr__(self) -> str:
        with self._lock:
            return f"Metrics({self._values})"


class TpuExec:
    def __init__(self, *children: "TpuExec"):
        self.children: list[TpuExec] = list(children)

    @property
    def schema(self) -> T.Schema:
        raise NotImplementedError

    @property
    def num_partitions(self) -> int:
        return self.children[0].num_partitions

    @property
    def output_partitioning(self):
        """The hash distribution this exec's output satisfies (a
        ``HashPartitioning`` bound to its schema), or None: the planner
        skips an exchange a child already satisfies."""
        return None

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        raise NotImplementedError

    def execute(self) -> Iterator[ColumnarBatch]:
        for p in range(self.num_partitions):
            yield from self.execute_partition(p)

    def leaf_device(self) -> torch.device:
        """The device of the scan under this exec's first child chain:
        where an exec with no input batch makes its output."""
        node = self
        while node.children:
            node = node.children[0]
        return node.device

    @property
    def name(self) -> str:
        return type(self).__name__

    def node_desc(self) -> str:
        return self.name

    def tree_string(self, depth: int = 0) -> str:
        lines = ["  " * depth + self.node_desc()]
        lines += [c.tree_string(depth + 1) for c in self.children]
        return "\n".join(lines)

    def walk(self) -> Iterator["TpuExec"]:
        yield self
        for c in self.children:
            yield from c.walk()
