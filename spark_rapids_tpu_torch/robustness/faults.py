"""Deterministic fault injection at the memory runtime's seams.

Counterpart of ``spark_rapids_tpu/robustness/faults.py`` for the four
sites this port has:

- ``alloc.device``: ``memory/device_manager.device_alloc_checkpoint``,
  which ``BufferStore.reserve`` calls before it admits a device
  reservation;
- ``transfer.upload``: ``columnar/transfer.py::upload_staged``, in front
  of the wire path's one copy of a batch; a retryable failure spills
  what the store can and re-issues the copy from the staged buffer;
- ``exec.batch``: ``execs/retry.with_split_retry``, once per attempt of
  a guarded batch in the join, aggregate, sort and exchange loops;
- ``cancel.check``: ``serving/cancel.check_point``, once per
  cooperative cancellation checkpoint while a query's token is
  attached; an injected hit cancels that token, so a schedule drives
  the real unwind.

They let the CPU tests force what a card does under pressure: a
retryable failure at an exact call, which the store's spill-and-retry
and the split ladder must absorb.  The policies, their spelling
(``site:nth=N,times=K;...``) and the default error texts are the JAX
module's.  The registry is process-global, as there: a fault point runs
on pool threads.  A session whose conf sets
``spark.rapids.tpu.robustness.faults.enabled`` arms its schedule for
each of its queries (``query_scope``); ``install(spec, forced=True)``
arms it for whatever runs until ``disarm()``.  Disarmed, a fault point
is one global read.  With tracing on, an injection records a
``fault.inject`` event and a credited recovery a ``fault.recovered``
one, as in the JAX module.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
import zlib
from typing import Iterator, Optional

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import trace as _tr

#: the ported sites (parse_spec refuses any other)
SITES = ("alloc.device", "transfer.upload", "exec.batch", "cancel.check")

#: default error text per site: each carries a marker that
#: ``execs/retry.is_retryable`` classifies as retryable
_DEFAULT_MARKERS = {
    "alloc.device":
        "RESOURCE_EXHAUSTED: injected device allocation failure",
    "transfer.upload":
        "UNAVAILABLE: injected H2D transfer fault",
    "exec.batch":
        "RESOURCE_EXHAUSTED: injected batch processing fault",
    # no retryable marker: check_point turns the hit into a real token
    # cancel, which fails fast through the ladder like a user's
    "cancel.check":
        "injected cancellation at a cancel.check checkpoint",
}


class InjectedFault(RuntimeError):
    """The error a fault point raises; it carries its site, so a
    recovery can credit it (``note_recovered``)."""

    def __init__(self, site: str, message: str):
        super().__init__(message)
        self.site = site


class _SiteState:
    __slots__ = ("site", "nth", "times", "every", "prob", "latency_s",
                 "marker", "rng", "calls", "injected", "recovered",
                 "lock")

    def __init__(self, site: str, nth: int = 0, times: int = 1,
                 every: int = 0, prob: float = 0.0, seed: int = 0,
                 latency_s: float = 0.0, marker: Optional[str] = None):
        self.site = site
        self.nth = nth
        self.times = max(1, times)
        self.every = every
        self.prob = prob
        self.latency_s = latency_s
        self.marker = marker or _DEFAULT_MARKERS[site]
        # crc32, not hash(): string hashes are salted per process
        self.rng = random.Random(zlib.crc32(site.encode()) ^ seed)
        self.calls = 0
        self.injected = 0
        self.recovered = 0
        self.lock = threading.Lock()

    def snapshot(self) -> dict:
        with self.lock:
            return {"calls": self.calls, "injected": self.injected,
                    "recovered": self.recovered}


def parse_spec(spec: str) -> dict[str, _SiteState]:
    """``'site:nth=3,times=2;site2:prob=0.5,seed=7'`` -> site states.
    Keys: nth (fail the Nth call, 1-based), times (with nth: K calls in
    a row), every, prob, seed, latency (ms), marker (the error text).
    A malformed entry or an unknown site raises ValueError: a schedule
    that silently matched nothing would report recoveries that never
    ran."""
    out: dict[str, _SiteState] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(f"fault spec entry {part!r} missing ':'")
        site, _, body = part.partition(":")
        site = site.strip()
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; sites: {SITES}")
        kw: dict = {}
        for item in body.split(","):
            item = item.strip()
            if not item:
                continue
            k, _, v = item.partition("=")
            k, v = k.strip(), v.strip()
            if k in ("nth", "times", "every", "seed"):
                kw[k] = int(v)
            elif k == "prob":
                kw["prob"] = float(v)
            elif k == "latency":
                kw["latency_s"] = float(v) / 1e3
            elif k == "marker":
                kw["marker"] = v
            else:
                raise ValueError(
                    f"unknown fault policy key {k!r} for site {site!r}")
        out[site] = _SiteState(site, **kw)
    return out


_ARMED = False
_FORCED = False
_SITES_STATE: dict[str, _SiteState] = {}
_LOCK = threading.Lock()


def install(spec: str, forced: bool = False) -> None:
    """Arm the registry with a schedule and fresh counters.  A
    ``forced`` install stays armed across queries until ``disarm``."""
    global _ARMED, _FORCED, _SITES_STATE
    states = parse_spec(spec)
    with _LOCK:
        _SITES_STATE = states
        _ARMED = True
        _FORCED = forced


def disarm() -> None:
    global _ARMED, _FORCED, _SITES_STATE
    with _LOCK:
        _ARMED = False
        _FORCED = False
        _SITES_STATE = {}


@contextlib.contextmanager
def query_scope(conf: C.TorchConf) -> Iterator[None]:
    """Arm ``conf``'s schedule, fresh, for one query and disarm it after
    (a forced install wins and stays)."""
    if _FORCED or not conf.get(C.FAULTS_ENABLED):
        yield
        return
    install(conf.get(C.FAULTS_SPEC))
    try:
        yield
    finally:
        if not _FORCED:
            disarm()


def fault_point(site: str, **ctx) -> None:
    """The injection checkpoint.  Disarmed: one global read.  Armed:
    the site's policy may sleep, and may raise an InjectedFault whose
    text carries a retryable marker."""
    if not _ARMED:
        return
    st = _SITES_STATE.get(site)
    if st is None:
        return
    with st.lock:
        st.calls += 1
        call_no = st.calls
        fire = bool(st.nth and st.nth <= call_no < st.nth + st.times) \
            or bool(st.every and call_no % st.every == 0) \
            or bool(st.prob and st.rng.random() < st.prob)
        if fire:
            st.injected += 1
        latency = st.latency_s
    if latency:
        time.sleep(latency)
    if fire:
        if _tr.TRACER.enabled:
            _tr.event("fault.inject", site=site, call=call_no, **ctx)
        raise InjectedFault(site, f"{st.marker} (site={site}, "
                                  f"call #{call_no})")


def _injected_in_chain(exc: BaseException) -> Optional[InjectedFault]:
    e: Optional[BaseException] = exc
    for _ in range(16):
        if e is None:
            return None
        if isinstance(e, InjectedFault):
            return e
        e = e.__cause__ or e.__context__
    return None


def note_recovered(exc: BaseException, action: str = "") -> None:
    """A recovery absorbed ``exc``: credit the site of an InjectedFault
    in its cause chain.  Real failures pass (``execs/retry.py``'s
    ``retry_stats`` counts their recoveries)."""
    if not _ARMED:
        return
    inj = _injected_in_chain(exc)
    st = None if inj is None else _SITES_STATE.get(inj.site)
    if st is not None:
        with st.lock:
            st.recovered += 1
        if _tr.TRACER.enabled:
            _tr.event("fault.recovered", site=inj.site, action=action)


def fault_stats() -> dict[str, dict]:
    """{site: {calls, injected, recovered}} of the armed schedule."""
    with _LOCK:
        states = list(_SITES_STATE.values())
    return {st.site: st.snapshot() for st in states}


def injected_total() -> int:
    return sum(s["injected"] for s in fault_stats().values())


def recovered_total() -> int:
    return sum(s["recovered"] for s in fault_stats().values())


def reset_stats() -> None:
    """Zero every site's counters; the schedule stays armed."""
    with _LOCK:
        states = list(_SITES_STATE.values())
    for st in states:
        with st.lock:
            st.calls = st.injected = st.recovered = 0
