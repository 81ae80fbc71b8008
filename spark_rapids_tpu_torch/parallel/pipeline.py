"""Bounded background stages and deferred device-to-host readbacks.

Counterpart of ``spark_rapids_tpu/parallel/pipeline.py``.  ``prefetch``
runs a generator on a thread of its own behind a bounded channel, so
its host work (Parquet decode, host copies, the upload's enqueue, the
result fetch) overlaps its consumer's.  The contract is the JAX one:

- order is preserved;
- a producer's exception is raised at the consumer, after the items
  produced before it;
- closing the consumer (or leaving it by ``break`` or an exception)
  aborts the stage: the producer wakes from a blocked put, its
  generator is closed on the producer thread (its ``finally`` blocks
  run there), and the thread is joined;
- depth <= 0 runs the generator inline;
- the query's cancel token (``serving/cancel.py``) is captured where
  the stage starts and attached on the producer thread; the channel's
  waits are bounded and check it, and the producer checks it before
  each put, so a cancelled query unwinds from either side (JAX
  ``_Chan.put`` / ``pop`` and the producer loop).

- the trace context (``trace.current_context``) makes the same hop,
  so the producer's spans carry the query's id; the producer records
  ``pipe.<stage>.run``, and the channel ``pipe.<stage>.wait_full`` /
  ``wait_empty`` spans and ``enqueue`` / ``dequeue`` events.

The JAX module's thread-local conf hop is not needed: the port's conf
belongs to its session, and the planner hands each exec what it reads.

The readbacks are the sanctioned syncs of a stream loop:

- :func:`device_read` blocks (``.cpu()``) and returns numpy;
- :func:`device_read_many` makes one device-to-host copy of many
  values (one per dtype among them);
- :func:`device_read_async` starts a ``non_blocking`` copy into pinned
  memory on the current stream and records an event;
  :class:`ReadbackFuture`'s ``done()`` queries the event and
  ``result()`` synchronizes on it;
- :func:`pipelined` dispatches item k+1 before item k retires (JAX's
  order), so a retire's readback overlaps the next dispatch's device
  work.

With a ``tag``, each readback counts in that stage's
``StageMetrics.readbacks`` (``async_readbacks`` for the async form,
and ``late_readbacks`` too when its result had to wait) and
records a ``pipe.readback`` span; :func:`trace_events` captures the
(dispatch | readback, tag) sequence for tests, with the speculation's
outcomes.  On a CPU tensor each reads directly.

``device_read_async`` is what the speculative sizing
(``parallel/speculation.py``) reads its counts with.  The JAX module
runs a harvester thread that resolves futures within a grace window;
here the future is an event, so ``result()`` costs nothing once the
copy has landed and no thread is needed.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import trace as _tr
from spark_rapids_tpu_torch.robustness.lock_tracker import tracked_lock
from spark_rapids_tpu_torch.serving import cancel as _cancel

#: name prefix of every stage's producer thread
STAGE_THREAD_PREFIX = "srt-pipe-"


def stage_depth(conf: C.TorchConf) -> int:
    """Queue depth of a pipeline stage under ``conf``; 0 = inline."""
    if not conf.get(C.PIPELINE_ENABLED):
        return 0
    return conf.get(C.PIPELINE_DEPTH)


def readback_lookahead(conf: Optional[C.TorchConf] = None) -> int:
    """How many items a stream loop dispatches ahead of its blocking
    readback (0: retire at once, the unpipelined order): the stage
    depth less one, from ``conf`` (the defaults when None)."""
    return max(0, stage_depth(conf or C.TorchConf()) - 1)


class StageMetrics:
    """Counters of one named stage, accumulated across queries: items,
    queue occupancy sampled at each consumer pop, the time each side
    spent blocked on the other, and the readbacks tagged with its
    name."""

    __slots__ = ("name", "depth", "items", "occupancy_sum", "samples",
                 "producer_wait_ns", "consumer_wait_ns", "readbacks",
                 "async_readbacks", "late_readbacks", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.depth = 0
        self.items = 0
        self.occupancy_sum = 0
        self.samples = 0
        self.producer_wait_ns = 0
        self.consumer_wait_ns = 0
        self.readbacks = 0
        self.async_readbacks = 0
        #: async readbacks whose copy had not landed when their result
        #: was asked for (each also counts in ``readbacks``)
        self.late_readbacks = 0
        self._lock = threading.Lock()

    def snapshot(self) -> dict:
        with self._lock:
            occ = self.occupancy_sum / self.samples if self.samples else 0.0
            return {"depth": self.depth, "items": self.items,
                    "avg_occupancy": occ,
                    "occupancy_fraction": occ / self.depth
                    if self.depth else 0.0,
                    "producer_wait_s": self.producer_wait_ns / 1e9,
                    "consumer_wait_s": self.consumer_wait_ns / 1e9,
                    "readbacks": self.readbacks,
                    "async_readbacks": self.async_readbacks,
                    "late_readbacks": self.late_readbacks}


_STAGES: dict[str, StageMetrics] = {}
_STAGES_LOCK = tracked_lock("pipeline.stages")


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
        """False once the consumer aborted: the producer stops.  The
        wait for room is bounded and checks the query's token."""
        with self.not_full:
            if len(self.buf) >= self.depth and not self.aborted:
                t0 = time.perf_counter_ns()
                tok = _cancel.current_token()
                while len(self.buf) >= self.depth and not self.aborted:
                    self.not_full.wait(_cancel.poll_timeout(tok))
                    if tok is not None:
                        tok.check()
                dt = time.perf_counter_ns() - t0
                with m._lock:
                    m.producer_wait_ns += dt
                if _tr.TRACER.enabled:  # the wait already timed
                    _tr.record_complete(f"pipe.{m.name}.wait_full",
                                        t0, dt, stage=m.name)
            if self.aborted:
                return False
            self.buf.append(item)
            if _tr.TRACER.enabled:
                _tr.event(f"pipe.{m.name}.enqueue", stage=m.name,
                          qlen=len(self.buf))
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
                tok = _cancel.current_token()
                while not self.buf and not self.done:
                    # bounded and token-checked: a cancelled consumer
                    # raises here, and prefetch's finally then aborts
                    # the stage and joins the producer
                    self.not_empty.wait(_cancel.poll_timeout(tok))
                    if tok is not None:
                        tok.check()
                dt = time.perf_counter_ns() - t0
                with m._lock:
                    m.consumer_wait_ns += dt
                if _tr.TRACER.enabled:
                    _tr.record_complete(f"pipe.{m.name}.wait_empty",
                                        t0, dt, stage=m.name)
            if self.buf:
                with m._lock:
                    m.items += 1
                item = self.buf.popleft()
                if _tr.TRACER.enabled:
                    _tr.event(f"pipe.{m.name}.dequeue", stage=m.name,
                              qlen=len(self.buf))
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
    ctok = _cancel.current_token()
    tctx = _tr.current_context()

    def produce() -> None:
        err: Optional[BaseException] = None
        try:
            try:
                with _cancel.attach_token(ctok), _tr.attach_context(tctx), \
                        _tr.span(f"pipe.{stage}.run", stage=stage):
                    for item in gen:
                        _cancel.check_point()
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


# ------------------------------------------------------------------ #
# Readback tracing (test instrumentation)
# ------------------------------------------------------------------ #

_TRACE: Optional[list] = None
_TRACE_LOCK = threading.Lock()


@contextmanager
def trace_events():
    """Capture ("dispatch" | "readback" | "readback_async" | "spec_hit"
    | "spec_overflow" | "spec_disabled", tag) events from
    :func:`pipelined`, the readbacks and the speculation's outcomes
    (``parallel/speculation.py``): the test hook showing that item
    k+1's dispatch precedes item k's readback, and which sizing reads
    blocked."""
    global _TRACE
    events: list[tuple[str, Optional[str]]] = []
    with _TRACE_LOCK:
        prev, _TRACE = _TRACE, events
    try:
        yield events
    finally:
        with _TRACE_LOCK:
            _TRACE = prev


def _trace(kind: str, tag: Optional[str]) -> None:
    t = _TRACE
    if t is not None:
        with _TRACE_LOCK:
            if _TRACE is t:
                t.append((kind, tag))


def _count(tag: Optional[str], field: str = "readbacks") -> None:
    if tag is not None:
        m = _stage_metrics(tag)
        with m._lock:
            setattr(m, field, getattr(m, field) + 1)


# ------------------------------------------------------------------ #
# Deferred readbacks (the sanctioned sync points)
# ------------------------------------------------------------------ #

_HOST_SCALARS = (int, float, bool)


def _to_host(x) -> np.ndarray:
    """A tensor's values as numpy (a host array as it is)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def device_read(x, tag: Optional[str] = None):
    """THE blocking device-to-host readback: a tensor as numpy (a 0-d
    tensor as a 0-d array).  Host values pass through free.  A stream
    loop should not call it inline per batch: :func:`pipelined` puts
    the next batch's dispatch in flight first."""
    if isinstance(x, _HOST_SCALARS):
        return x
    _trace("readback", tag)
    _count(tag)
    if _tr.TRACER.enabled:
        with _tr.span("pipe.readback", tag=tag or ""):
            return _to_host(x)
    return _to_host(x)


def device_read_int(x, tag: Optional[str] = None) -> int:
    v = device_read(x, tag)
    return v if isinstance(v, int) else int(v)


def _read_many(xs: list) -> list:
    """One copy per dtype: the device tensors of each dtype flattened
    into one, read back, and split into their shapes."""
    out: list = list(xs)
    groups: dict = {}
    for i, x in enumerate(xs):
        if isinstance(x, torch.Tensor):
            groups.setdefault((x.dtype, x.device), []).append(i)
    for idx in groups.values():
        ts = [xs[i] for i in idx]
        flat = torch.cat([t.detach().reshape(-1) for t in ts]) \
            if len(ts) > 1 else ts[0].detach().reshape(-1)
        host = _to_host(flat)
        off = 0
        for i, t in zip(idx, ts):
            n = t.numel()
            out[i] = host[off:off + n].reshape(tuple(t.shape))
            off += n
    return out


def device_read_many(xs: Sequence, tag: Optional[str] = None) -> list:
    """Read MANY device values in ONE transfer round (one copy per dtype
    among them); host values pass through.  Each tensor comes back as a
    numpy array of its shape."""
    xs = list(xs)
    if all(isinstance(x, _HOST_SCALARS) for x in xs):
        return xs
    _trace("readback", tag)
    _count(tag)
    if _tr.TRACER.enabled:
        with _tr.span("pipe.readback", tag=tag or "", n=len(xs)):
            return _read_many(xs)
    return _read_many(xs)


class ReadbackFuture:
    """A device-to-host copy in flight: ``non_blocking`` into pinned
    memory on the current stream, with an event recorded after it.
    ``done()`` queries the event; ``result()`` synchronizes on it, and
    counts as a blocking readback (trace event, stage counter,
    ``pipe.readback`` span) only when the copy had not finished.  A CPU
    tensor, or a host value, is read at once."""

    __slots__ = ("_host", "_event", "_tag", "_value", "_resolved")

    def __init__(self, host, event, tag: Optional[str], value=None):
        self._host = host
        self._event = event
        self._tag = tag
        self._value = value
        self._resolved = event is None

    def done(self) -> bool:
        return self._resolved or self._event.query()

    def result(self):
        if self._resolved:
            return self._value
        ev = self._event
        if not ev.query():
            _trace("readback", self._tag)
            _count(self._tag)
            _count(self._tag, "late_readbacks")
            if _tr.TRACER.enabled:
                with _tr.span("pipe.readback", tag=self._tag or "",
                              blocking=True):
                    ev.synchronize()
            else:
                ev.synchronize()
        self._value = self._host.numpy()
        self._resolved = True
        self._host = self._event = None
        return self._value


def device_read_async(x, tag: Optional[str] = None) -> ReadbackFuture:
    """Start a readback and return its :class:`ReadbackFuture`: the
    future-style sibling of :func:`device_read` for a loop that can use
    the value one batch later."""
    if isinstance(x, _HOST_SCALARS):
        return ReadbackFuture(None, None, tag, value=x)
    _trace("readback_async", tag)
    _count(tag, "async_readbacks")
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        return ReadbackFuture(None, None, tag, value=_to_host(x))
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x.detach(), non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(x.device))
    return ReadbackFuture(host, ev, tag)


def pipelined(items: Iterable, dispatch: Callable[[Any], Any],
              retire: Callable[[Any], Optional[Iterable]],
              depth: Optional[int] = None,
              tag: Optional[str] = None) -> Iterator:
    """Software-pipeline a stream loop: ``dispatch(item)`` launches the
    item's device work and returns its in-flight state; ``retire`` does
    the blocking readback and the output of the OLDEST state.  With
    depth >= 1, item k+1 is dispatched before item k retires.  retire
    may return an iterable of outputs (yielded in stream order) or
    None.  depth defaults to :func:`readback_lookahead` of the
    defaults; 0 is the serial dispatch-then-retire order."""
    if depth is None:
        depth = readback_lookahead()
    depth = max(0, int(depth))
    pending: deque = deque()
    for item in items:
        pending.append(dispatch(item))
        _trace("dispatch", tag)
        while len(pending) > depth:
            out = retire(pending.popleft())
            if out is not None:
                yield from out
    while pending:
        out = retire(pending.popleft())
        if out is not None:
            yield from out
