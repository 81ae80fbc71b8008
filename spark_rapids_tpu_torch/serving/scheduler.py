"""Admission control: weighted-fair, priority-aware query scheduling.

Counterpart of ``spark_rapids_tpu/serving/scheduler.py``.  The task
semaphore answers how many tasks may hold device batches; a serving
tier must also answer which query runs next when more sessions arrive
than the card should run at once.  :class:`QueryScheduler` does so by
start-time weighted fair queuing across tenants: each tenant carries a
virtual clock that advances ``1/priority`` per queued query, and the
waiting entry with the smallest virtual start time is granted next
(FIFO within ties), so a priority-4 tenant gets 4x the admission share
of a priority-1 tenant under contention and no tenant starves.

The limit is ``min(serving.maxConcurrent, process semaphore permits)``:
admission rides the budget that caps device residency, and a semaphore
resize (``TpuSemaphore.sync_conf``) re-sizes admission at the next
grant.  The scheduler never holds a permit across a query; admitted
queries still acquire per-task permits inside their execs.

A query arriving while ``serving.queueDepth`` others wait is rejected
(:class:`AdmissionRejected`).  Admission is re-entrant per thread: a
nested collect on an admitted thread (a scalar subquery's run) passes
through.  Every admission records its wait in a bounded ring
(``scheduler_stats``: ``wait_p50_ms`` / ``wait_p99_ms``) and in the
serving context.  Admission-aware batching (``serving.batching.enabled``)
grants a queued query whose template group is already running first.

The scheduler is one per process; :func:`get_scheduler` applies the
admitting conf's ``maxConcurrent`` / ``queueDepth`` /
``defaultPriority`` / batching when they differ from the live values
(last writer wins, as in JAX); :func:`reset` drops it for tests.  Each
admission records a ``serve.admit`` span of its wait.  The JAX
module's mesh budget is not ported.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import trace as _tr
from spark_rapids_tpu_torch.robustness.lock_tracker import tracked_lock
from spark_rapids_tpu_torch.serving import (
    clear_serving_context,
    current_serving_context,
    update_serving_context,
)


class AdmissionRejected(RuntimeError):
    """The admission queue is full (serving.queueDepth): the serving
    tier sheds this query instead of queuing it unboundedly.  Callers
    should retry with backoff or route to another replica."""


class _Tenant:
    __slots__ = ("name", "vtime")

    def __init__(self, name: str):
        self.name = name
        self.vtime = 0.0


class _Entry:
    __slots__ = ("tenant", "priority", "vtime", "seq", "granted",
                 "group")

    def __init__(self, tenant: str, priority: int, vtime: float,
                 seq: int, group: Optional[str] = None):
        self.tenant = tenant
        self.priority = priority
        self.vtime = vtime
        self.seq = seq
        self.granted = False
        #: template-group key for admission-aware batching
        #: (serving/work_share.py): queued entries sharing a group with
        #: a RUNNING query are granted preferentially, so compatible
        #: plans overlap and their scans dedup in flight
        self.group = group


class QueryScheduler:
    """One device's admission scheduler (see module doc)."""

    def __init__(self, max_concurrent: int, queue_depth: int,
                 default_priority: int = 1, batching: bool = True):
        self.max_concurrent = int(max_concurrent)
        self.queue_depth = int(queue_depth)
        self.default_priority = int(default_priority)
        self.batching = bool(batching)
        self._cv = threading.Condition()
        self._running = 0                        # guard: _cv
        self._waiting: list[_Entry] = []         # guard: _cv
        self._tenants: dict[str, _Tenant] = {}   # guard: _cv
        #: group -> count of RUNNING queries carrying it (the
        #: batching preference's membership test)
        self._running_groups: dict[str, int] = {}  # guard: _cv
        self._vclock = 0.0                       # guard: _cv
        self._seq = 0                            # guard: _cv
        # stats (under _cv): totals + a bounded ring of recent waits so
        # p50/p99 stay O(1) memory on a long-lived server
        self._admitted = 0                       # guard: _cv
        self._rejected = 0                       # guard: _cv
        self._coalesced = 0                      # guard: _cv
        #: queued entries unwound by cancellation/deadline before grant
        #: (or after an unconsumed grant) — the admission queue's share
        #: of the cancellation story (serving/cancel.py)
        self._shed = 0                           # guard: _cv
        self._total_wait_ms = 0.0                # guard: _cv
        self._waits_ms: deque = deque(maxlen=4096)  # guard: _cv
        #: per-tenant wait rings and admit totals (a bounded ring a
        #: tenant, so a long-lived server stays O(1) memory)
        self._tenant_waits: dict[str, deque] = {}   # guard: _cv
        self._tenant_admitted: dict[str, int] = {}  # guard: _cv

    # -- limit ------------------------------------------------------- #

    def _limit(self) -> int:
        """``serving.maxConcurrent`` clamped to the process semaphore's
        permits."""
        from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore

        return max(1, min(self.max_concurrent, TpuSemaphore.get().permits))

    # -- core -------------------------------------------------------- #

    def _pump_locked(self) -> None:
        """Grant waiting entries while capacity remains: smallest
        virtual start time first (WFQ), FIFO within ties.  Virtual
        times were assigned at ENQUEUE (each tenant's clock advances
        1/priority per queued request), so a burst from one tenant
        interleaves with other tenants' queued work instead of
        draining FIFO.

        Admission-aware batching (serving.batching.enabled): a
        waiting entry whose template group is already RUNNING is
        granted ahead of strict WFQ order — compatible plans then
        execute together and the work-sharing tier dedups their scans
        in flight (serving/work_share.py).  Bounded unfairness: the
        preference only ever reorders against live groups, and each
        coalesced grant still consumes a slot, so ungrouped tenants
        advance as slots free."""
        limit = self._limit()
        while self._running < limit and self._waiting:
            nxt = None
            if self.batching and self._running_groups:
                cands = [e for e in self._waiting
                         if e.group and e.group in self._running_groups]
                if cands:
                    nxt = min(cands, key=lambda e: (e.vtime, e.seq))
                    self._coalesced += 1
            if nxt is None:
                nxt = min(self._waiting,
                          key=lambda e: (e.vtime, e.seq))
            self._waiting.remove(nxt)
            nxt.granted = True
            self._running += 1
            if nxt.group:
                self._running_groups[nxt.group] = \
                    self._running_groups.get(nxt.group, 0) + 1
            self._vclock = max(self._vclock, nxt.vtime)
        self._cv.notify_all()

    def _drop_running_locked(self, entry: _Entry) -> None:
        self._running -= 1
        if entry.group:
            n = self._running_groups.get(entry.group, 0) - 1
            if n <= 0:
                self._running_groups.pop(entry.group, None)
            else:
                self._running_groups[entry.group] = n

    def admit(self, tenant: str = "default",
              priority: Optional[int] = None,
              group: Optional[str] = None, token=None) -> _Entry:
        """Block until this query is admitted (or raise
        :class:`AdmissionRejected` when the queue is full).  Returns
        the ticket to hand back to :meth:`release`.  `group` is the
        optional template-group key batching coalesces on.

        ``token`` (a serving/cancel CancelToken) makes the admission
        wait INTERRUPTIBLE: the wait polls on the cancel cadence
        bounded by the token's remaining deadline, so a query whose
        deadline expires (or that is cancelled) WHILE QUEUED is shed
        here — entry removed, no device work ever dispatched — with
        QueryCancelled raised to the caller.  An already-expired
        deadline sheds before the entry is even enqueued."""
        from spark_rapids_tpu_torch.serving.cancel import poll_timeout

        prio = int(priority) if priority is not None \
            else self.default_priority
        t0 = time.perf_counter_ns()
        with self._cv:
            if token is not None:
                # expired-before-admission: shed with zero queue time
                # (the zero-device-work contract starts here)
                token.check()
            te = self._tenants.get(tenant)
            if te is None:
                te = self._tenants[tenant] = _Tenant(tenant)
                # a brand-new tenant starts at the current virtual
                # clock, not 0 — joining late must not grant it a
                # catch-up burst over tenants that queued all along
                te.vtime = self._vclock
            if self._running >= self._limit() \
                    and len(self._waiting) >= self.queue_depth:
                self._rejected += 1
                raise AdmissionRejected(
                    f"admission queue full ({len(self._waiting)} "
                    f"waiting >= serving.queueDepth="
                    f"{self.queue_depth}, {self._running} running); "
                    f"tenant={tenant!r}")
            self._seq += 1
            entry = _Entry(tenant, prio,
                           max(te.vtime, self._vclock), self._seq,
                           group=group)
            # advance the tenant clock AT ENQUEUE: its next request
            # starts 1/priority later in virtual time, which is what
            # spaces a burst out against other tenants' queued work
            te.vtime = entry.vtime + 1.0 / max(1, prio)
            self._waiting.append(entry)
            self._pump_locked()
            waited = not entry.granted
            try:
                while not entry.granted:
                    # bounded wait (every serving-path wait is
                    # interruptible): grants still arrive via notify;
                    # the timeout only bounds cancel/deadline response
                    # latency
                    self._cv.wait(poll_timeout(token))
                    if token is not None and not entry.granted:
                        token.check()
            except BaseException:
                # interrupted wait (cancellation/deadline shed,
                # KeyboardInterrupt, injected test abort): unwind the
                # entry, or the pump would later grant a slot nobody
                # will ever release and admission wedges for the
                # process lifetime
                self._shed += 1
                if entry in self._waiting:
                    self._waiting.remove(entry)
                elif entry.granted:
                    self._drop_running_locked(entry)
                    self._pump_locked()
                raise
            dt_ns = (time.perf_counter_ns() - t0) if waited else 0
            wait_ms = dt_ns / 1e6
            self._admitted += 1
            self._total_wait_ms += wait_ms
            self._waits_ms.append(wait_ms)
            ring = self._tenant_waits.get(tenant)
            if ring is None:
                ring = self._tenant_waits[tenant] = deque(maxlen=512)
            ring.append(wait_ms)
            self._tenant_admitted[tenant] = \
                self._tenant_admitted.get(tenant, 0) + 1
        if _tr.TRACER.enabled:
            # the admission wait as a span on the timeline (zero-length
            # for an immediate grant)
            _tr.record_complete("serve.admit", t0, dt_ns,
                                tenant=tenant, priority=prio)
        update_serving_context(tenant=tenant, priority=prio,
                               admit_wait_ms=round(wait_ms, 3))
        return entry

    def release(self, entry: _Entry) -> None:
        with self._cv:
            self._drop_running_locked(entry)
            self._pump_locked()

    # -- stats ------------------------------------------------------- #

    @staticmethod
    def _quantile(xs: list, q: float) -> float:
        if not xs:
            return 0.0
        xs = sorted(xs)
        i = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
        return xs[i]

    def stats(self) -> dict:
        with self._cv:
            waits = list(self._waits_ms)
            out = {
                "admitted": self._admitted,
                "rejected": self._rejected,
                "coalesced": self._coalesced,
                "shed": self._shed,
                "running": self._running,
                "waiting": len(self._waiting),
                "total_wait_ms": round(self._total_wait_ms, 3),
            }
        out["wait_p50_ms"] = round(self._quantile(waits, 0.50), 3)
        out["wait_p99_ms"] = round(self._quantile(waits, 0.99), 3)
        return out

    def tenant_stats(self) -> dict:
        """Per-tenant admission waits: {tenant: {wait_p50_ms,
        wait_p99_ms, admitted}}: what the weighted-fair share gives each
        tenant."""
        with self._cv:
            rings = {t: list(r) for t, r in self._tenant_waits.items()}
            admitted = dict(self._tenant_admitted)
        return {t: {
            "wait_p50_ms": round(self._quantile(w, 0.50), 3),
            "wait_p99_ms": round(self._quantile(w, 0.99), 3),
            "admitted": admitted.get(t, 0),
        } for t, w in rings.items()}


# ------------------------------------------------------------------ #
# Process-global instance (tracer/faults ownership discipline)
# ------------------------------------------------------------------ #

_SCHED: Optional[QueryScheduler] = None
_LOCK = tracked_lock("scheduler.registry")


def get_scheduler(conf: C.TorchConf) -> QueryScheduler:
    """The process scheduler, created (and re-configured) from the
    given conf.  Conf changes apply in place — live waiters see the new
    limits at the next grant decision."""
    global _SCHED
    want_max = int(conf.get(C.SERVING_MAX_CONCURRENT))
    want_depth = int(conf.get(C.SERVING_QUEUE_DEPTH))
    want_prio = int(conf.get(C.SERVING_DEFAULT_PRIORITY))
    want_batch = bool(conf.get(C.SERVING_BATCHING))
    with _LOCK:
        if _SCHED is None:
            _SCHED = QueryScheduler(want_max, want_depth, want_prio,
                                    batching=want_batch)
            return _SCHED
        s = _SCHED
    if (s.max_concurrent, s.queue_depth, s.default_priority,
            s.batching) != (want_max, want_depth, want_prio,
                            want_batch):
        with s._cv:
            s.max_concurrent = want_max
            s.queue_depth = want_depth
            s.default_priority = want_prio
            s.batching = want_batch
            s._pump_locked()
    return s


def queue_gauges() -> dict:
    """Admission occupancy now (running, waiting), without making a
    scheduler: the telemetry sampler's gauge."""
    with _LOCK:
        s = _SCHED
    if s is None:
        return {"running": 0, "waiting": 0}
    with s._cv:
        return {"running": s._running, "waiting": len(s._waiting)}


def scheduler_stats() -> dict:
    with _LOCK:
        s = _SCHED
    return s.stats() if s is not None else {
        "admitted": 0, "rejected": 0, "coalesced": 0, "shed": 0,
        "running": 0, "waiting": 0, "total_wait_ms": 0.0,
        "wait_p50_ms": 0.0, "wait_p99_ms": 0.0}


def tenant_wait_stats() -> dict:
    """Per-tenant admission-wait stats without making a scheduler ({}
    while the tier is off)."""
    with _LOCK:
        s = _SCHED
    return s.tenant_stats() if s is not None else {}


def reset() -> None:
    """Drop the process scheduler (tests).  In-flight tickets release
    against the old instance harmlessly."""
    global _SCHED
    with _LOCK:
        _SCHED = None


@contextmanager
def admission(conf, tenant: str = "default",
              priority: Optional[int] = None,
              group: Optional[str] = None, token=None):
    """The query-boundary hook: a no-op single conf read when serving
    admission is disabled (maxConcurrent <= 0); otherwise admit through
    the process scheduler for the duration of the block.  Re-entrant
    per thread — a nested collect on an admitted thread (scalar
    subquery's run) passes straight through instead of deadlocking against itself.
    `group` (optional, the prepared template's binding-independent
    key) feeds admission-aware batching.

    ``token`` threads the query's CancelToken into the admission wait
    (deadline/cancel shed while queued — serving/cancel.py) and this
    block reports the ADMITTED query's outcome to the tenant's circuit
    breaker: success heals, a crash or deadline_exceeded counts toward
    serving.breaker.failureThreshold, an explicit user cancel is
    neutral.  A quarantined tenant is shed BEFORE taking a WFQ slot
    (TenantQuarantined)."""
    if int(conf.get(C.SERVING_MAX_CONCURRENT)) <= 0:
        try:
            yield None
        finally:
            # a prepared query's plan-cache verdict was deposited
            # inside this block; drop it so it cannot leak into a
            # later query's facts.  Conditional:
            # the common plain-collect path never touched the context
            if current_serving_context() is not None:
                clear_serving_context()
        return
    tl = _ADMITTED_TL
    if getattr(tl, "depth", 0) > 0:
        # nested query on an admitted thread: pass through, but stash
        # the OUTER query's serving context for the duration — the
        # nested query must not report the outer
        # admission wait / tenant / plan-cache verdict as its own
        outer_ctx = current_serving_context()
        clear_serving_context()
        tl.depth += 1
        try:
            yield None
        finally:
            tl.depth -= 1
            clear_serving_context()
            if outer_ctx:
                update_serving_context(**outer_ctx)
        return
    from spark_rapids_tpu_torch.serving import cancel as _cancel

    _cancel.breaker_admit(conf, tenant)  # may raise TenantQuarantined
    sched = get_scheduler(conf)
    try:
        ticket = sched.admit(tenant, priority, group=group,
                             token=token)
    except BaseException:
        # shed before admission (queue full, deadline expired while
        # queued, interrupt): if breaker_admit claimed the half-open
        # probe for this query, release it — a lost probe must not
        # leave the tenant quarantined forever
        _cancel.breaker_release(conf, tenant)
        raise
    tl.depth = 1
    outcome = "failure"
    try:
        yield ticket
        outcome = "success"
    except _cancel.QueryCancelled as e:
        # deadline mid-flight = the hang signature (counts toward the
        # breaker); an explicit user cancel says nothing about the
        # query's health
        outcome = "failure" if e.reason == "deadline_exceeded" \
            else "neutral"
        raise
    except GeneratorExit:
        # a stream consumer closing early (the documented early-close
        # pattern) is not a query failure — breaker-neutral
        outcome = "neutral"
        raise
    finally:
        tl.depth = 0
        sched.release(ticket)
        clear_serving_context()
        if outcome != "neutral":
            _cancel.breaker_result(conf, tenant,
                                   ok=outcome == "success")
        else:
            # neutral exits still release a claimed half-open probe
            _cancel.breaker_release(conf, tenant)


_ADMITTED_TL = threading.local()
