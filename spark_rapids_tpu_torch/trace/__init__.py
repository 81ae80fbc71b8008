"""Structured tracing: one correlated timeline across threads.

Counterpart of ``spark_rapids_tpu/trace/__init__.py``, with its names
and its contract.  The port runs work on several thread families: the
session's thread, the pipeline stages' producers (``srt-pipe-*``), the
task pools (``srt-pool-*``), the metric reaper and the ledger's settle
worker.  This module records, per thread:

- :func:`span`: a named interval (a context manager);
- :func:`event`: an instant;
- :func:`record_complete`: an interval the caller already timed;

and carries correlation attributes (``query_id``, stage, task) across
thread hops with :func:`trace_context` / :func:`current_context` /
:func:`attach_context`: the submitting thread captures its context and
the executing thread attaches it (``parallel/pipeline.py::prefetch``,
``execs/base.py::run_tasks``).  Each thread writes to its own bounded
ring (``spark.rapids.tpu.trace.bufferSize`` events; the oldest are
evicted), without a lock; the ring of a finished thread stays readable
by :func:`snapshot`.  With tracing off an instrumented site costs one
attribute read (``TRACER.enabled``).

The names recorded are the JAX package's:
``query.plan`` / ``.tag`` / ``.lower`` / ``.execute`` /
``.fetch.batch``, ``exec.<op>``, ``metric.settle.<op>``,
``exchange.task``, ``pipe.<stage>.run`` / ``.enqueue`` / ``.dequeue``
/ ``.wait_full`` / ``.wait_empty``, ``pipe.readback``, ``rf.build``,
``rf.apply``, ``spill.device_to_host`` / ``.host_to_disk`` /
``.restore``, ``shuffle.block.send`` / ``.recv``, ``wire.compress`` (a
component through the codec chooser, ``columnar/transfer.py``) and
``wire.decompress`` (a compressed batch's decode),
``speculation.hit`` / ``.overflow`` / ``.disabled``, ``jit.cache_miss``,
``fault.inject`` / ``.recovered``, and the serving tier's
``serve.*``, ``cancel.*`` and ``breaker.*``.  The device ledger keys
the wire decode ``("wire.decode", ...)``, op ``WireDecode``.

Export is in :mod:`spark_rapids_tpu_torch.trace.export` (Chrome Trace
JSON, ``TorchSession.export_trace``); the per-program device time is in
:mod:`.ledger`, the gauge sampler in :mod:`.telemetry`.  The port's
conf belongs to its session, so :func:`sync_conf` takes it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
import weakref
from typing import Any, Iterator, Optional

from spark_rapids_tpu_torch import config as C


@dataclasses.dataclass(slots=True)
class TraceEvent:
    """One recorded span ("X") or instant ("i")."""

    name: str
    ph: str  # "X" complete span | "i" instant
    ts_ns: int  # perf_counter_ns at span start / instant time
    dur_ns: int  # 0 for instants
    tid: int
    thread_name: str
    attrs: dict

    @property
    def end_ns(self) -> int:
        return self.ts_ns + self.dur_ns


#: process-unique track ids for rings.  NOT the OS thread ident:
#: CPython recycles idents after thread death, and per-query pipeline /
#: pool threads would then merge onto one mislabeled Perfetto track.
_RING_IDS = itertools.count(1)

#: dead-thread rings (owner exited, events still current) retained for
#: export; oldest beyond this are dropped so a long-running traced
#: process stays bounded even across many short-lived stage threads
_MAX_DEAD_RINGS = 256


class _Ring:
    """Per-thread fixed-capacity event ring.  STRICTLY single-writer:
    only the owning thread ever mutates buf/pos (appends are lock-free;
    a clear()/resize from another thread only bumps the tracer's
    generation, and the owner lazily resets on its next append —
    cross-thread mutation of buf would race `buf[pos] = ev`).  Readers
    snapshot under the tracer lock and skip stale-generation rings,
    which is fine for a diagnostics buffer."""

    __slots__ = ("cap", "buf", "pos", "dropped", "tid", "thread_name",
                 "gen", "owner")

    def __init__(self, cap: int, thread: threading.Thread, gen: int):
        self.cap = cap
        self.buf: list[TraceEvent] = []
        self.pos = 0
        self.dropped = 0
        self.tid = next(_RING_IDS)
        self.thread_name = thread.name
        self.gen = gen
        #: weakref so the ring never keeps a finished Thread alive;
        #: a dead owner can no longer append, which makes pruning safe
        self.owner = weakref.ref(thread)

    def append(self, ev: TraceEvent) -> None:
        if len(self.buf) < self.cap:
            self.buf.append(ev)
        else:
            self.buf[self.pos] = ev
            self.pos = (self.pos + 1) % self.cap
            self.dropped += 1

    def ordered(self) -> list[TraceEvent]:
        return self.buf[self.pos:] + self.buf[:self.pos]

    def reset(self, cap: Optional[int] = None) -> None:
        """Owner-thread only (see class doc)."""
        if cap is not None:
            self.cap = cap
        self.buf = []
        self.pos = 0
        self.dropped = 0


class Tracer:
    """Process-wide trace collector.

    ``enabled`` is THE fast-path guard: every instrumentation site
    reads this one attribute and does nothing else when tracing is
    off.  ``forced`` marks a programmatic :func:`enable` (tests,
    chip_smoke) that :func:`sync_conf` must not override."""

    def __init__(self) -> None:
        self.enabled = False
        self.forced = False
        self.buffer_size = C.DEFAULTS[C.TRACE_BUFFER_SIZE]
        #: bumped by clear()/resize; rings lazily self-reset when their
        #: gen falls behind, so only the OWNER thread mutates a ring
        self._gen = 0
        #: perf_counter_ns of the last clear()/resize: any event whose
        #: interval STARTED before it belongs to the discarded capture
        #: (covers spans and caller-timed record_complete alike)
        self._gen_ts = 0
        #: weakref to the conf that last enabled via sync_conf — only
        #: that conf's "off" may disable (another session's conf must
        #: not kill a concurrent session's capture mid-query; a
        #: weakref, not id(), because a recycled address would hand the
        #: kill switch to an unrelated conf)
        self._enabled_by: Optional[weakref.ref] = None
        self._rings: list[_Ring] = []
        self._lock = threading.Lock()
        self._tls = threading.local()

    # -- recording (hot path) ------------------------------------------ #

    def _ring(self) -> _Ring:
        ring = getattr(self._tls, "ring", None)
        if ring is None:
            ring = _Ring(self.buffer_size, threading.current_thread(),
                         self._gen)
            with self._lock:
                self._rings.append(ring)
                self._prune_locked()
            self._tls.ring = ring
        elif ring.gen != self._gen:
            # a clear()/resize happened since this thread last wrote:
            # apply it here, on the owning thread
            ring.reset(self.buffer_size)
            ring.gen = self._gen
        return ring

    def record(self, name: str, ts_ns: int, dur_ns: int,
               attrs: Optional[dict], ph: str = "X") -> None:
        if not self.enabled:
            return  # a span may outlive a disable(): drop, don't bleed
        if ts_ns < self._gen_ts:
            return  # interval predates a clear(): that capture was
            # discarded — applies to spans and pre-timed
            # record_complete (reaper settle, pipeline waits) alike
        ring = self._ring()
        ctx = getattr(self._tls, "ctx", None)
        if ctx:
            attrs = {**ctx, **attrs} if attrs else dict(ctx)
        ring.append(TraceEvent(name, ph, ts_ns, dur_ns, ring.tid,
                               ring.thread_name, attrs or {}))

    # -- lifecycle ------------------------------------------------------ #

    def enable(self, buffer_size: Optional[int] = None,
               forced: bool = True) -> None:
        with self._lock:
            if buffer_size is not None \
                    and int(buffer_size) != self.buffer_size:
                # an actual RESIZE resets (lazily per owner); a mere
                # re-enable at the same size preserves prior events
                self.buffer_size = int(buffer_size)
                self._gen += 1
                self._gen_ts = time.perf_counter_ns()
            self.enabled = True
            self.forced = forced

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            self.forced = False
            self._enabled_by = None

    def clear(self) -> None:
        with self._lock:
            self._gen += 1
            self._gen_ts = time.perf_counter_ns()
            self._prune_locked()

    def _prune_locked(self) -> None:
        """Drop rings no snapshot can ever use again: dead-owner rings
        whose content is stale (owner can't lazily reset them), and the
        oldest dead-but-current rings past _MAX_DEAD_RINGS.  A dead
        owner cannot append, so dropping its ring is race-free; live
        rings are never touched from here."""
        kept: list[_Ring] = []
        dead_current: list[_Ring] = []
        for r in self._rings:
            o = r.owner()
            if o is not None and o.is_alive():
                kept.append(r)
            elif r.gen == self._gen:
                dead_current.append(r)  # events still exportable
            # dead + stale generation: unreferenced garbage — drop
        if len(dead_current) > _MAX_DEAD_RINGS:
            dead_current = dead_current[-_MAX_DEAD_RINGS:]
        self._rings = kept + dead_current

    def _live_rings(self) -> list[_Ring]:
        """Rings whose content survives the latest clear/resize (a
        stale ring's owner has not written since, so its buffered
        events predate the clear)."""
        return [r for r in self._rings if r.gen == self._gen]

    def snapshot(self) -> list[TraceEvent]:
        with self._lock:
            out: list[TraceEvent] = []
            for r in self._live_rings():
                out.extend(r.ordered())
        out.sort(key=lambda e: e.ts_ns)
        return out

    def dropped(self) -> int:
        with self._lock:
            return sum(r.dropped for r in self._live_rings())


#: THE process-wide tracer; instrumentation guards on ``TRACER.enabled``
TRACER = Tracer()


def is_enabled() -> bool:
    return TRACER.enabled


def enable(buffer_size: Optional[int] = None) -> None:
    """Force tracing on (tests, chip_smoke): survives the
    :func:`sync_conf` calls made at each query boundary."""
    TRACER.enable(buffer_size, forced=True)


def disable() -> None:
    TRACER.disable()


def clear() -> None:
    TRACER.clear()


def snapshot() -> list[TraceEvent]:
    """All recorded events (every thread), in timestamp order."""
    return TRACER.snapshot()


def sync_conf(conf: "C.TorchConf") -> None:
    """Align the tracer with a session's conf at a query boundary (the
    tracer is process-global).  A programmatic :func:`enable` wins over
    the conf, and only the conf that ENABLED tracing may turn it off:
    another session whose conf merely defaults to off must not kill a
    concurrently tracing session's capture mid-query."""
    if TRACER.forced:
        return
    want = bool(conf.get(C.TRACE_ENABLED))
    if want:
        if not TRACER.enabled:
            TRACER.enable(int(conf.get(C.TRACE_BUFFER_SIZE)),
                          forced=False)
        TRACER._enabled_by = weakref.ref(conf)
    elif TRACER.enabled and TRACER._enabled_by is not None \
            and TRACER._enabled_by() is conf:
        TRACER.disable()


# ------------------------------------------------------------------ #
# Span / event API
# ------------------------------------------------------------------ #


class _NoopSpan:
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "attrs", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        # a clear() between enter and exit discards this span: record()
        # drops any interval starting before the clear stamp
        TRACER.record(self.name, self.t0,
                      time.perf_counter_ns() - self.t0, self.attrs)
        return False


def span(name: str, **attrs: Any):
    """Context manager recording a named interval on this thread; the
    thread's correlation context (query_id, ...) merges into `attrs`.
    A single shared no-op object when tracing is off."""
    if not TRACER.enabled:
        return _NOOP
    return _Span(name, attrs)


def event(name: str, **attrs: Any) -> None:
    """Record an instant marker."""
    if not TRACER.enabled:
        return
    TRACER.record(name, time.perf_counter_ns(), 0, attrs, ph="i")


def record_complete(name: str, t0_ns: int, dur_ns: int,
                    **attrs: Any) -> None:
    """Record a span whose interval the caller already measured (sites
    like MetricTimer and the pipeline wait counters, which time their
    region anyway — no second clock read)."""
    if not TRACER.enabled:
        return
    TRACER.record(name, t0_ns, dur_ns, attrs)


# ------------------------------------------------------------------ #
# Cross-thread correlation context
# ------------------------------------------------------------------ #


@contextlib.contextmanager
def trace_context(**attrs: Any) -> Iterator[None]:
    """Push correlation attributes onto this thread's context; every
    span/event recorded inside carries them."""
    tls = TRACER._tls
    prev = getattr(tls, "ctx", None)
    tls.ctx = {**prev, **attrs} if prev else attrs
    try:
        yield
    finally:
        tls.ctx = prev


def current_context() -> dict:
    """Snapshot of this thread's correlation context — capture it where
    work is dispatched, and :func:`attach_context` it on the thread
    that executes (thread-locals do not cross the hop)."""
    ctx = getattr(TRACER._tls, "ctx", None)
    return dict(ctx) if ctx else {}


@contextlib.contextmanager
def attach_context(ctx: Optional[dict]) -> Iterator[None]:
    """Install a captured context on the current (receiving) thread for
    the duration of the block."""
    tls = TRACER._tls
    prev = getattr(tls, "ctx", None)
    tls.ctx = dict(ctx) if ctx else None
    try:
        yield
    finally:
        tls.ctx = prev
