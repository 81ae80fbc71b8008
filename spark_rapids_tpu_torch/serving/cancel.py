"""Cooperative query cancellation: tokens, deadlines, and the
per-tenant circuit breaker.

Counterpart of ``spark_rapids_tpu/serving/cancel.py``.  Nothing is
killed mid-kernel: the engine's blocking seams poll.

- :class:`CancelToken`: one per query in flight, carried across thread
  hops by capture and attach (:func:`current_token` on the dispatching
  thread, :func:`attach_token` on the receiving one), so the pipeline's
  stage producers, the exchange's map tasks and the coalesce workers
  see the query's token.  It is cancelled by ``session.cancel()`` /
  ``PreparedQuery.cancel()``, or by its deadline
  (``spark.rapids.tpu.serving.deadlineMs``, enforced from the admission
  queue on, so a query whose deadline passes while it waits is shed
  with no device work).
- :func:`check_point`: the cooperative checkpoint, in the pipeline's
  channel waits and producer loop, the admission wait, the map-task
  pool, the retry loop and the session's fetch loop.  With no token
  attached it is one thread-local read.  It is also the
  ``cancel.check`` fault site: an injected hit cancels the current
  token, so a schedule drives the real unwind.
- a per-tenant circuit breaker (``serving.breaker.*``): a tenant whose
  admitted queries keep failing (an error, or a deadline) is
  quarantined at admission (:class:`TenantQuarantined`) for the
  cooldown; then one probe query is admitted (half open), and its
  outcome closes or re-opens the breaker.  Explicit cancels are
  neutral.

A :class:`QueryCancelled` raised at a checkpoint unwinds by the paths a
failure takes: the admission entry and slot released, pipeline
producers closed and joined, exec trees closed (shuffle blocks and
parked batches freed), semaphore permits given back, shared-scan
leaderships aborted.  ``serving.cancellation.enabled`` off makes
:func:`begin` one conf read returning None.  With tracing on, a cancel
records ``cancel.request``, the checkpoint that raises
``cancel.unwind``, and the breaker ``breaker.trip`` /
``breaker.quarantined``, as the JAX module does.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, Optional

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import trace as _tr
from spark_rapids_tpu_torch.robustness.lock_tracker import tracked_lock
from spark_rapids_tpu_torch.serving.scheduler import AdmissionRejected

#: poll granularity for interruptible waits (every wait on the serving
#: path is bounded); grants and publishes still wake waiters by notify,
#: so this bounds only the cancel/deadline response latency
WAIT_POLL_S = 0.05


class QueryCancelled(RuntimeError):
    """The query was cancelled (``reason="cancelled"``) or its deadline
    expired (``reason="deadline_exceeded"``).  Never retryable: the
    retry ladder fails fast on it (``execs/retry.is_retryable``)."""

    def __init__(self, reason: str, detail: str = "",
                 query_id: Optional[int] = None):
        msg = reason if not detail else f"{reason}: {detail}"
        if query_id is not None:
            msg += f" (query_id={query_id})"
        super().__init__(msg)
        self.reason = reason
        self.detail = detail
        self.query_id = query_id
        #: the query's history / event-log record is written (a
        #: mid-flight unwind records its partial metrics; one shed
        #: before it started is recorded by the session's handler)
        self.recorded = False


class TenantQuarantined(AdmissionRejected):
    """This tenant's circuit breaker is OPEN (its queries kept dying):
    the serving tier sheds the query at admission instead of letting a
    poison query consume another WFQ slot.  Subclasses
    AdmissionRejected so load-shedding callers handle both alike;
    retry after serving.breaker.cooldownMs."""


class CancelToken:
    """One query's cancellation state.  Thread-safe; crossed between
    threads by capture/attach (see module doc).  ``cancel()`` is
    first-writer-wins: the first reason sticks."""

    __slots__ = ("tenant", "deadline_ns", "query_id", "reason",
                 "detail", "_mu")

    def __init__(self, tenant: str = "default",
                 deadline_ms: Optional[float] = None):
        self.tenant = tenant
        self.deadline_ns = (
            time.monotonic_ns() + int(deadline_ms * 1e6)
            if deadline_ms else None)
        self.query_id: Optional[int] = None
        self.reason: Optional[str] = None
        self.detail = ""
        self._mu = threading.Lock()

    def cancel(self, reason: str = "cancelled",
               detail: str = "") -> bool:
        """Request cancellation; False if already cancelled (the first
        reason sticks).  Wakes nothing by itself — the query's blocked
        seams poll on the WAIT_POLL_S cadence."""
        with self._mu:
            if self.reason is not None:
                return False
            self.reason = reason
            self.detail = detail
        if _tr.TRACER.enabled:
            _tr.event("cancel.request", reason=reason,
                      query_id=self.query_id, tenant=self.tenant)
        return True

    @property
    def cancelled(self) -> bool:
        return self.reason is not None

    def expired(self) -> bool:
        return self.deadline_ns is not None \
            and time.monotonic_ns() >= self.deadline_ns

    def remaining_s(self) -> Optional[float]:
        if self.deadline_ns is None:
            return None
        return (self.deadline_ns - time.monotonic_ns()) / 1e9

    def check(self) -> None:
        """Raise :class:`QueryCancelled` if cancelled or past
        deadline; otherwise return (two attribute reads)."""
        r = self.reason
        if r is None and self.deadline_ns is not None \
                and time.monotonic_ns() >= self.deadline_ns:
            self.cancel("deadline_exceeded",
                        detail="per-query deadline "
                               "(serving.deadlineMs) exceeded")
            r = self.reason
        if r is not None:
            if _tr.TRACER.enabled:
                _tr.event("cancel.unwind", reason=r,
                          query_id=self.query_id)
            raise QueryCancelled(r, self.detail, self.query_id)


def describe_token(tok: CancelToken) -> dict:
    """A token's state as JSON (the ops plane's ``/queries`` column)."""
    return {
        "tenant": tok.tenant,
        "query_id": tok.query_id,
        "reason": tok.reason,
        "detail": tok.detail or None,
        "deadline_remaining_s": (
            round(tok.remaining_s(), 3)
            if tok.deadline_ns is not None else None),
    }


class TokenSet:
    """A lock-protected set of live tokens — the session's (and each
    PreparedQuery's) handle for ``cancel()``."""

    def __init__(self):
        self._mu = threading.Lock()
        self._toks: set = set()  # guard: _mu

    def add(self, tok: Optional[CancelToken]) -> None:
        if tok is None:
            return
        with self._mu:
            self._toks.add(tok)

    def discard(self, tok: Optional[CancelToken]) -> None:
        if tok is None:
            return
        with self._mu:
            self._toks.discard(tok)

    def __len__(self) -> int:
        with self._mu:
            return len(self._toks)

    def cancel(self, query_id: Optional[int] = None,
               reason: str = "cancelled") -> int:
        """Cancel every tracked in-flight query (or just ``query_id``);
        returns how many tokens this call newly cancelled.  Queries
        still in the admission queue have no query id yet and are only
        matched by the cancel-all form."""
        with self._mu:
            toks = list(self._toks)
        n = 0
        for t in toks:
            if query_id is None or t.query_id == query_id:
                if t.cancel(reason):
                    n += 1
        return n


# ------------------------------------------------------------------ #
# Thread-local carry
# ------------------------------------------------------------------ #

_TL = threading.local()

#: process-wide live-token gauge
_ACTIVE = 0
_ACTIVE_MU = tracked_lock("cancel.active")


def current_token() -> Optional[CancelToken]:
    """This thread's token (capture on the dispatching side before a
    thread hop, :func:`attach_token` on the receiving side — exactly
    the hop the JAX tracer's context makes)."""
    return getattr(_TL, "token", None)


@contextlib.contextmanager
def attach_token(tok: Optional[CancelToken]) -> Iterator[None]:
    """Install a token on the current thread for the block (a nested
    query's token shadows the outer one; the outer is restored on
    exit)."""
    prev = getattr(_TL, "token", None)
    _TL.token = tok
    try:
        yield
    finally:
        _TL.token = prev


def check_point() -> None:
    """THE cooperative cancellation checkpoint (and the
    ``cancel.check`` fault seam): no token attached = one thread-local
    read.  An armed injected hit cancels the CURRENT token and unwinds
    through the real cancellation path — chaos runs exercise the
    production teardown, not a test-only shortcut."""
    tok = getattr(_TL, "token", None)
    if tok is None:
        return
    from spark_rapids_tpu_torch.robustness import faults as _faults

    try:
        _faults.fault_point("cancel.check")
    except _faults.InjectedFault as e:
        tok.cancel("cancelled", detail=str(e))
    tok.check()


def poll_timeout(tok: Optional[CancelToken],
                 default: float = WAIT_POLL_S) -> float:
    """Bound for one blocking-wait slice: the poll cadence, clipped to
    the token's remaining deadline so expiry is observed promptly."""
    if tok is None:
        return default
    rem = tok.remaining_s()
    if rem is None:
        return default
    return max(0.0, min(default, rem))


# ------------------------------------------------------------------ #
# Per-query lifecycle (session.py's prologue/epilogue hooks)
# ------------------------------------------------------------------ #


def begin(conf, tenant: str = "default") -> Optional[CancelToken]:
    """The query-boundary hook: None after ONE conf read when
    cancellation is disabled; otherwise a fresh token carrying the
    conf deadline (serving.deadlineMs, 0 = none)."""
    global _ACTIVE
    if not conf.get(C.CANCEL_ENABLED):
        return None
    dl = float(conf.get(C.DEADLINE_MS))
    tok = CancelToken(tenant, deadline_ms=dl if dl > 0 else None)
    with _ACTIVE_MU:
        _ACTIVE += 1
    return tok


def end(tok: Optional[CancelToken]) -> None:
    global _ACTIVE
    if tok is None:
        return
    with _ACTIVE_MU:
        _ACTIVE -= 1


def active_count() -> int:
    with _ACTIVE_MU:
        return _ACTIVE


# ------------------------------------------------------------------ #
# Outcome counters
# ------------------------------------------------------------------ #

_STATS_MU = threading.Lock()
_STATS = {"cancelled": 0, "deadline_exceeded": 0, "breaker_trips": 0,
          "quarantined": 0}


def tick_outcome(reason: str) -> None:
    """Count one unwound query by reason (the session's cancellation
    epilogue calls this exactly once per cancelled query)."""
    key = "deadline_exceeded" if reason == "deadline_exceeded" \
        else "cancelled"
    with _STATS_MU:
        _STATS[key] += 1


def stats() -> dict:
    with _STATS_MU:
        return dict(_STATS)


def reset_stats() -> None:
    with _STATS_MU:
        for k in _STATS:
            _STATS[k] = 0


# ------------------------------------------------------------------ #
# Per-tenant circuit breaker
# ------------------------------------------------------------------ #


class _Breaker:
    __slots__ = ("failures", "state", "open_until_ns", "probing")

    def __init__(self):
        # every _Breaker lives in _BREAKERS and is mutated only under
        # the module-level registry lock (a per-instance lock would
        # add nothing: admit/result always resolve tenant -> breaker
        # under _BREAKERS_MU anyway)
        self.failures = 0           # guard: _BREAKERS_MU
        self.state = "closed"       # guard: _BREAKERS_MU
        self.open_until_ns = 0      # guard: _BREAKERS_MU
        self.probing = False        # guard: _BREAKERS_MU


_BREAKERS: dict[str, _Breaker] = {}
_BREAKERS_MU = tracked_lock("cancel.breakers")


def breaker_admit(conf, tenant: str) -> None:
    """Admission-time gate: raise :class:`TenantQuarantined` while the
    tenant's breaker is open (or while its half-open probe is still in
    flight).  Disabled (failureThreshold <= 0, the default) this is
    one conf read."""
    thr = int(conf.get(C.BREAKER_THRESHOLD))
    if thr <= 0:
        return
    now = time.monotonic_ns()
    with _BREAKERS_MU:
        b = _BREAKERS.get(tenant)
        if b is None:
            b = _BREAKERS[tenant] = _Breaker()
        if b.state == "open":
            if now < b.open_until_ns:
                quarantine = True
            else:
                b.state = "half_open"
                b.probing = True  # this query is the probe
                quarantine = False
        elif b.state == "half_open":
            quarantine = b.probing  # one probe at a time
            if not quarantine:
                b.probing = True
        else:
            quarantine = False
        if quarantine:
            remain_ms = max(0.0, (b.open_until_ns - now) / 1e6) \
                if b.state == "open" else 0.0
    if quarantine:
        with _STATS_MU:
            _STATS["quarantined"] += 1
        if _tr.TRACER.enabled:
            _tr.event("breaker.quarantined", tenant=tenant)
        raise TenantQuarantined(
            f"tenant {tenant!r} is quarantined (circuit breaker "
            f"open after repeated failures; retry in "
            f"~{remain_ms:.0f}ms or after a successful probe)")


def breaker_release(conf, tenant: str) -> None:
    """Release a claimed half-open probe WITHOUT counting an outcome:
    the probe query exited through a breaker-neutral path — explicit
    user cancel, abandoned stream, or it never got admitted at all
    (queue full, deadline expired while queued).  The breaker stays
    half-open and the NEXT query becomes the probe; without this, a
    lost probe would leave ``probing`` set forever and quarantine the
    tenant with no escape.  No-op for closed/open breakers and when
    the breaker is disabled."""
    if int(conf.get(C.BREAKER_THRESHOLD)) <= 0:
        return
    with _BREAKERS_MU:
        b = _BREAKERS.get(tenant)
        if b is not None and b.state == "half_open":
            b.probing = False


def breaker_result(conf, tenant: str, ok: bool) -> None:
    """Outcome hook for an ADMITTED query: success closes/heals, a
    failure (crash or deadline_exceeded — explicit cancels never reach
    here) counts toward the threshold; a failed half-open probe
    re-opens for another cooldown."""
    thr = int(conf.get(C.BREAKER_THRESHOLD))
    if thr <= 0:
        return
    cooldown_ns = int(float(conf.get(C.BREAKER_COOLDOWN_MS)) * 1e6)
    tripped = False
    with _BREAKERS_MU:
        b = _BREAKERS.get(tenant)
        if b is None:
            b = _BREAKERS[tenant] = _Breaker()
        if b.state == "half_open":
            b.probing = False
            if ok:
                b.state = "closed"
                b.failures = 0
            else:
                b.state = "open"
                b.open_until_ns = time.monotonic_ns() + cooldown_ns
                tripped = True
        elif ok:
            b.failures = 0
        else:
            b.failures += 1
            if b.failures >= thr:
                b.state = "open"
                b.open_until_ns = time.monotonic_ns() + cooldown_ns
                b.failures = 0
                tripped = True
    if tripped:
        with _STATS_MU:
            _STATS["breaker_trips"] += 1
        if _tr.TRACER.enabled:
            _tr.event("breaker.trip", tenant=tenant)


def breaker_state(tenant: str) -> str:
    """'closed' | 'open' | 'half_open' (tests/observability)."""
    with _BREAKERS_MU:
        b = _BREAKERS.get(tenant)
        return b.state if b is not None else "closed"


def reset_breakers() -> None:
    with _BREAKERS_MU:
        _BREAKERS.clear()


def reset() -> None:
    """Test isolation: breakers + outcome counters (live tokens are
    owned by their queries and left alone)."""
    reset_breakers()
    reset_stats()
