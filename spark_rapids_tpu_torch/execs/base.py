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
reached through ``TaskRuntime.retry``.  The join, aggregate and
exchange loops size their output speculatively under
``TaskRuntime.speculation`` (``parallel/speculation.py``).  No fusion
or buffer donation in this port.

Each exec's ``total_time`` (the JAX ``totalTime``) is timed by
:class:`MetricTimer` around its per-batch work.  While tracing or the
ledger is on, on CUDA, the timed region records an event at its end
and the metric reaper thread waits on it off the critical path, so the
time is device-settled (``spark.rapids.tpu.sql.metrics.deviceSync``,
synced at each query boundary); otherwise, or on the CPU, it is the
host's.  The region is also an
``exec.<op>`` trace span, and the reaper adds a ``metric.settle.<name>``
span.  ``run_tasks`` carries the submitting thread's trace context to
its pool threads.

Every exec counts the batches it yields and their rows
(``output_counts``: the JAX ``numOutputRows`` and ``numOutputBatches``,
which ``metric_values`` reports with ``totalTime`` and the exec's own
counters): each ``execute`` and ``execute_partition`` a subclass defines
is wrapped to count, once, the batches it hands its caller (a nested
call of the same exec on the same thread, as ``super()`` makes, does
not count them again).

Each metric has the JAX level of its name (``metric_level``):
``ESSENTIAL`` for the three every exec counts and for what a JAX exec's
``additional_metrics`` marks so, ``MODERATE`` for the JAX execs' other
counters, ``DEBUG`` for a counter only the port keeps.
``TpuExec.collect_metrics`` reports a tree's metrics up to
``spark.rapids.tpu.sql.metrics.level``; ``metric_values``, the history
and the event log read every metric, as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from collections import deque
from collections.abc import Mapping
from concurrent.futures import FIRST_EXCEPTION, ThreadPoolExecutor, wait
from typing import Callable, Iterator, Optional, TypeVar

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import trace as _trace
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.execs.retry import DEFAULT_POLICY, RetryPolicy
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.parallel.speculation import SpeculationPolicy
from spark_rapids_tpu_torch.trace import ledger as _ledger

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
    on the CPU), its retry policy with its buffer store, its
    speculation keys, and how its scans upload
    (``columnar/transfer.py::WirePolicy``; None: the plain path)."""

    semaphore: TpuSemaphore
    task_threads: int = 1
    decode_threads: int = 1
    stage_depth: int = 0
    upload_stream: Optional[object] = None
    retry: RetryPolicy = DEFAULT_POLICY
    speculation: SpeculationPolicy = SpeculationPolicy()
    wire: Optional[object] = None

    @property
    def lookahead(self) -> int:
        """Items a pipelined stream loop dispatches ahead of its
        readback (``parallel/pipeline.py::readback_lookahead``)."""
        return max(0, self.stage_depth - 1)

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
    tctx = _trace.current_context()

    def run(i: int) -> R:
        with _cancel.attach_token(ctok), _trace.attach_context(tctx):
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


# -- device-settled timing ------------------------------------------ #

_DEVICE_SYNC = [bool(C.DEFAULTS[C.METRICS_DEVICE_SYNC])]


def sync_metrics_conf(conf: C.TorchConf) -> None:
    """Align :class:`MetricTimer` with a session's
    ``sql.metrics.deviceSync`` at a query boundary (process-wide, last
    writer wins, as the semaphore's permits)."""
    _DEVICE_SYNC[0] = bool(conf.get(C.METRICS_DEVICE_SYNC))


class TimeMetric:
    """One named time counter (ns), added to from several threads."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def add(self, ns: int) -> None:
        with self._lock:
            self.value += ns

    def __repr__(self) -> str:
        return f"TimeMetric({self.name}={self.value})"


#: name of the metric reaper's thread
REAPER_THREAD = "srt-metric-reaper"


class _MetricReaper:
    """Waits on each timed region's end event off the critical path,
    then adds the region's elapsed time to its metric (a region on the
    CPU has no event: its time is added as it comes, as the JAX reaper
    does for an output that is already ready).  The thread is
    started by a submit and exits once it has found no work for
    ``LINGER_S``, so none stays behind an idle process.  A failed event
    is kept and raised by the next :meth:`submit` or :meth:`flush`."""

    LINGER_S = 0.25

    def __init__(self) -> None:
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._running = False
        self._unfinished = 0
        self.errors: list[BaseException] = []

    def submit(self, metric: TimeMetric, t0: int, event) -> None:
        if self.errors:  # a failed event surfaces on the path
            raise self.errors.pop(0)
        ctx = _trace.current_context() if _trace.TRACER.enabled else None
        with self._cv:
            self._q.append((metric, t0, event, ctx))
            self._unfinished += 1
            if not self._running:
                self._running = True
                threading.Thread(target=self._run, name=REAPER_THREAD,
                                 daemon=True).start()
            self._cv.notify_all()

    def flush(self) -> None:
        """Wait until every submitted region is timed; raise what the
        thread met."""
        with self._cv:
            while self._unfinished:
                self._cv.wait()
        if self.errors:
            err = self.errors[0]
            self.errors = []
            raise err

    def _run(self) -> None:
        while True:
            with self._cv:
                if not self._q:
                    self._cv.wait(self.LINGER_S)
                if not self._q:
                    self._running = False
                    return
                metric, t0, event, ctx = self._q.popleft()
            try:
                w0 = time.perf_counter_ns()
                if event is not None:
                    event.synchronize()
                now = time.perf_counter_ns()
                metric.add(now - t0)
                if _trace.TRACER.enabled:
                    with _trace.attach_context(ctx):
                        _trace.record_complete(
                            f"metric.settle.{metric.name}", w0, now - w0,
                            metric=metric.name)
            except Exception as e:  # noqa: BLE001 - raised by flush()
                self.errors.append(e)
            finally:
                with self._cv:
                    self._unfinished -= 1
                    self._cv.notify_all()


REAPER = _MetricReaper()


class MetricTimer:
    """Context manager adding a region's elapsed time to a metric (JAX
    ``MetricTimer``, the NVTX-with-metric pattern).  ``observe(out)``
    registers the region's output: with ``deviceSync`` on and tracing
    or the ledger on, the reaper adds the time, and when the output
    lives on a CUDA device the region's end is an event recorded on the
    current stream that the reaper waits on first.  Otherwise the time
    is the host's, added as the region ends: with every observability
    key off a region records no event and wakes no thread.  With ``op``
    set and tracing on, the region is also an ``exec.<op>`` span (its
    host side)."""

    __slots__ = ("metric", "op", "_device", "t0")

    def __init__(self, metric: Optional[TimeMetric],
                 op: Optional[str] = None):
        self.metric = metric
        self.op = op
        self._device = None

    def observe(self, out):
        """Register the region's output; returns it."""
        dev = getattr(out, "device", None)
        if isinstance(dev, torch.device):
            self._device = dev
        return out

    def __enter__(self) -> "MetricTimer":
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.op is not None and _trace.TRACER.enabled:
            _trace.record_complete(f"exec.{self.op}", self.t0,
                                   time.perf_counter_ns() - self.t0,
                                   op=self.op)
        if self.metric is None:
            return False
        if self._device is not None and exc[0] is None \
                and _DEVICE_SYNC[0] \
                and (_trace.TRACER.enabled or _ledger.LEDGER.enabled):
            ev = None  # a CPU tensor's work is done when the call returns
            if self._device.type == "cuda":
                # blocking: the reaper sleeps in its wait, no core spins
                ev = torch.cuda.Event(blocking=True)
                ev.record(torch.cuda.current_stream(self._device))
            REAPER.submit(self.metric, self.t0, ev)
        else:
            self.metric.add(time.perf_counter_ns() - self.t0)
        return False


class OutputCounts:
    """An exec's output rows and batches, added to from several
    threads."""

    __slots__ = ("rows", "batches", "_lock")

    def __init__(self) -> None:
        self.rows = 0
        self.batches = 0
        self._lock = threading.Lock()

    def add(self, rows: int) -> None:
        with self._lock:
            self.rows += rows
            self.batches += 1


#: per thread, the ids of the execs whose counting wrapper is advancing
#: its body there (a nested wrapper of the same exec does not count)
_COUNTING = threading.local()


def _counted(node: "TpuExec", src) -> Iterator[ColumnarBatch]:
    key = id(node)
    it = iter(src)
    try:
        while True:
            # the advancing thread's set: a generator may move between
            # threads (a stage thread drains what another made)
            active = _COUNTING.__dict__.setdefault("ids", set())
            mine = key not in active
            if mine:
                active.add(key)
            try:
                batch = next(it)
            except StopIteration:
                return
            finally:
                if mine:
                    active.discard(key)
            if mine:
                node.output_counts.add(batch.num_rows)
            yield batch
    finally:
        close = getattr(src, "close", None)
        if close is not None:
            close()


def _counting(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        return _counted(self, fn(self, *args, **kwargs))

    wrapper.counts_output = True
    return wrapper


#: metric names a JAX exec reports at ESSENTIAL ...
ESSENTIAL_METRICS = frozenset({
    "numOutputRows", "numOutputBatches", "totalTime", "adaptiveBroadcasts",
    "skewSplits", "cacheHits", "cacheWrites", "shuffleWriteRows",
    "rfBuildTime", "pythonBatches", "filesPruned", "rowGroupsPruned",
    "hostFilteredRows", "rfPrunedRows", "rfRowGroupsPruned", "numFiles",
    "numOutputBytes"})
#: ... and at MODERATE
MODERATE_METRICS = frozenset({
    "coalescedPartitions", "numMerges", "specHits", "specOverflows",
    "numInputRows", "numInputBatches", "numConcats", "concatTime",
    "fetchWaitTime", "buildRows", "probeBatches", "mapTasks", "rfKeys",
    "candidateRows", "sortBuckets", "oocRows", "scanTime", "writeTime"})


def metric_level(name: str) -> str:
    """``name``'s level: its JAX exec's, ``DEBUG`` for a port-only one."""
    if name in ESSENTIAL_METRICS:
        return "ESSENTIAL"
    return "MODERATE" if name in MODERATE_METRICS else "DEBUG"


def metric_values(node: "TpuExec") -> dict:
    """An exec's metrics as numbers: ``numOutputRows``,
    ``numOutputBatches``, ``totalTime`` (ns), then its own counters."""
    out = node.output_counts
    values = {"numOutputRows": out.rows, "numOutputBatches": out.batches,
              "totalTime": node.total_time.value}
    for name, v in (getattr(node, "metrics", None) or {}).items():
        values.setdefault(name, v)
    return values


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

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for name in ("execute", "execute_partition"):
            fn = cls.__dict__.get(name)
            if fn is not None and not getattr(fn, "counts_output", False):
                setattr(cls, name, _counting(fn))

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

    @property
    def total_time(self) -> TimeMetric:
        """The exec's ``totalTime`` (ns, device-settled on CUDA), made
        on first use."""
        m = self.__dict__.get("_total_time")
        if m is None:
            m = self.__dict__.setdefault("_total_time",
                                         TimeMetric("totalTime"))
        return m

    @property
    def output_counts(self) -> OutputCounts:
        """The rows and batches this exec has yielded, made on first
        use."""
        m = self.__dict__.get("_output_counts")
        if m is None:
            m = self.__dict__.setdefault("_output_counts", OutputCounts())
        return m

    def program(self, tag: str, key: Callable[[], tuple],
                fn: Callable) -> Callable:
        """``fn``, this exec's per-batch device program.  With the
        ledger off it is ``fn`` itself and ``key`` is not called.  On,
        ``fn`` dispatches under the ledger entry of the structural key
        ``(tag, *key())`` (``execs/jit_cache.py``), which execs of an
        equal key share; ``key()`` must hold everything ``fn`` reads of
        the exec."""
        if not _ledger.LEDGER.enabled:
            return fn
        from spark_rapids_tpu_torch.execs.jit_cache import cached_program

        return cached_program((tag,) + tuple(key()), fn, op=self.name)

    def collect_metrics(self, level: Optional[str] = None
                        ) -> dict[str, dict]:
        """Each exec's metrics at or under ``level`` (None: the
        ``spark.rapids.tpu.sql.metrics.level`` of the conf that planned
        the tree), by exec name; execs of one name merge, as in JAX.
        Timed regions in flight settle first."""
        REAPER.flush()
        level = level or getattr(self, "metrics_level",
                                 C.DEFAULTS[C.METRICS_LEVEL])
        rank = C.METRIC_LEVELS.index(level)
        out: dict[str, dict] = {}
        for node in self.walk():
            out.setdefault(node.name, {}).update(
                (k, v) for k, v in metric_values(node).items()
                if C.METRIC_LEVELS.index(metric_level(k)) <= rank)
        return out

    def timer(self) -> MetricTimer:
        """A :class:`MetricTimer` on ``total_time``, recording an
        ``exec.<name>`` span."""
        return MetricTimer(self.total_time, op=self.name)
