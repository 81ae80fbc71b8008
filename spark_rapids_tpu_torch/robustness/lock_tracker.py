"""Runtime lock-order tracker.

Counterpart of ``spark_rapids_tpu/robustness/lock_tracker.py``: engine
locks made through :func:`tracked_lock` carry a name, and, when the
tracker is armed, every acquisition records the thread's holding stack,
feeds a process-wide lock-order graph, and raises
:class:`LockCycleError` the moment an acquisition would close a cycle:
the deadlock is reported before it hangs.  Per-name counters
(acquisitions, contention waits, longest hold) read through
:func:`lock_stats` and :func:`aggregate_stats`.

Arming follows ``robustness/faults.py``: a conf with
``spark.rapids.tpu.robustness.lockTracker.enabled`` arms it at a query
boundary (:func:`sync_conf`) and owns it; only the owning conf disarms;
a forced :func:`install` (tests) survives ``sync_conf``.  Disarmed, the
default, a tracked lock is one module-global read plus the plain
acquire.

What is tracked: the registry and cache mutexes of the serving tier
(plan cache, result cache, scan-share registry, breaker registry,
scheduler registry, active-token gauge) and the pipeline's stage-metrics
map.  Condition variables stay plain ``threading.Condition``: their
``wait()`` releases the lock, which a holding-stack model would misread
as a held edge.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Optional

from spark_rapids_tpu_torch import config as C


class LockCycleError(RuntimeError):
    """Acquiring this lock would close a cycle in the runtime
    lock-order graph — the acquisition that would deadlock, caught at
    formation time.  Carries the offending edge and the established
    path it contradicts."""

    def __init__(self, message: str, edge: tuple[str, str],
                 path: list[str]):
        super().__init__(message)
        self.edge = edge
        self.path = list(path)


class _NameStats:
    """Aggregated per-NAME counters (all instances constructed under
    one name — e.g. every session's PlanCache mutex — pool here)."""

    __slots__ = ("acquisitions", "contention_waits", "max_hold_ns")

    def __init__(self):
        self.acquisitions = 0
        self.contention_waits = 0
        self.max_hold_ns = 0


# process-global armed state (faults.py ownership discipline: arming
# is per process — tracked locks are process singletons' locks, and
# acquisition runs on worker threads holding conf SNAPSHOTS)
_ARMED = False
_FORCED = False
_OWNER: Optional["weakref.ref"] = None
_MU = threading.Lock()
#: name -> aggregated stats (under _MU)
_STATS: dict[str, _NameStats] = {}
#: runtime lock-order graph: edge a -> b means "held a while
#: acquiring b" was OBSERVED (under _MU)
_EDGES: dict[str, set[str]] = {}
#: cycle formations detected (under _MU); nonzero after a
#: LockCycleError was raised
_CYCLES = 0

_TLS = threading.local()


def _held_stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def _reaches(src: str, dst: str) -> Optional[list[str]]:
    """Path src -> ... -> dst in _EDGES (caller holds _MU), or None."""
    if src == dst:
        return [src]
    seen = {src}
    stack = [(src, [src])]
    while stack:
        node, path = stack.pop()
        for nxt in _EDGES.get(node, ()):
            if nxt == dst:
                return path + [dst]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


class TrackedLock:
    """A named mutex: plain ``threading.Lock``/``RLock`` semantics,
    plus (armed-only) order tracking and contention/hold accounting.
    Construct through :func:`tracked_lock`."""

    __slots__ = ("name", "reentrant", "_inner")

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant \
            else threading.Lock()
        # no stats seeding here: lock_stats() lists names ACQUIRED
        # while armed, not every lock the process ever constructed

    # -- armed path --------------------------------------------------- #

    def _depths(self) -> dict:
        d = getattr(_TLS, "depths", None)
        if d is None:
            d = _TLS.depths = {}
        return d

    def _acquire_tracked(self) -> None:
        stack = _held_stack()
        if self.reentrant:
            depths = self._depths()
            if depths.get(id(self), 0) > 0:
                # re-entry on the owning thread: no new edge, no new
                # stack frame — the outermost acquisition owns both
                self._inner.acquire()
                depths[id(self)] = depths.get(id(self), 0) + 1
                return
        held = [name for name, _t0, _lk in stack]
        if held:
            with _MU:
                global _CYCLES
                for h in held:
                    if h == self.name:
                        continue
                    path = _reaches(self.name, h)
                    if path is not None:
                        _CYCLES += 1
                        raise LockCycleError(
                            f"lock-order cycle: acquiring "
                            f"{self.name!r} while holding {h!r} "
                            f"contradicts the established order "
                            f"{' -> '.join(path)} (this acquisition "
                            "WOULD deadlock under the right "
                            "interleaving)",
                            edge=(h, self.name), path=path)
                for h in held:
                    if h != self.name:
                        _EDGES.setdefault(h, set()).add(self.name)
        contended = False
        if not self._inner.acquire(blocking=False):
            contended = True
            self._inner.acquire()
        with _MU:
            st = _STATS.setdefault(self.name, _NameStats())
            st.acquisitions += 1
            if contended:
                st.contention_waits += 1
        stack.append((self.name, time.monotonic_ns(), self))
        if self.reentrant:
            self._depths()[id(self)] = 1

    def _release_tracked(self) -> None:
        if self.reentrant:
            depths = self._depths()
            n = depths.get(id(self), 0)
            if n > 1:
                depths[id(self)] = n - 1
                self._inner.release()
                return
            depths.pop(id(self), None)
        stack = _held_stack()
        # tolerate an arm/disarm flip between acquire and release:
        # only account frames this tracker actually pushed
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][2] is self:
                _name, t0, _lk = stack.pop(i)
                held_ns = time.monotonic_ns() - t0
                with _MU:
                    st = _STATS.setdefault(self.name, _NameStats())
                    if held_ns > st.max_hold_ns:
                        st.max_hold_ns = held_ns
                break
        self._inner.release()

    # -- public Lock interface ---------------------------------------- #

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        if not _ARMED:
            return self._inner.acquire(blocking, timeout)
        if not blocking or timeout != -1:
            # non-blocking/timed acquires cannot deadlock-by-waiting;
            # count them, skip order edges (they give up instead of
            # blocking, so they are not a cycle hazard)
            ok = self._inner.acquire(blocking, timeout)
            if ok:
                with _MU:
                    st = _STATS.setdefault(self.name, _NameStats())
                    st.acquisitions += 1
                _held_stack().append(
                    (self.name, time.monotonic_ns(), self))
                if self.reentrant:
                    d = self._depths()
                    d[id(self)] = d.get(id(self), 0) + 1
            return ok
        self._acquire_tracked()
        return True

    def release(self) -> None:
        if not _ARMED:
            # still pop any frame a previously-armed acquire pushed,
            # or a later armed window would see a stale "held" lock
            stack = getattr(_TLS, "stack", None)
            if stack:
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i][2] is self:
                        stack.pop(i)
                        break
            self._inner.release()
            return
        self._release_tracked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        inner = self._inner
        return inner.locked() if hasattr(inner, "locked") else False


def tracked_lock(name: str, reentrant: bool = False) -> TrackedLock:
    """A named engine lock (see module doc).  `name` is the stats and
    graph identity — instances sharing a name pool their counters and
    their order constraints (they guard the same KIND of state)."""
    return TrackedLock(name, reentrant=reentrant)


# ------------------------------------------------------------------ #
# Arming (faults.py ownership idiom)
# ------------------------------------------------------------------ #


def install(forced: bool = False) -> None:
    """Arm the tracker (fresh graph + counters).  ``forced`` installs
    (tests, bench storms) survive sync_conf."""
    global _ARMED, _FORCED
    with _MU:
        _reset_locked()
        _ARMED = True
        _FORCED = forced


def disarm() -> None:
    global _ARMED, _FORCED, _OWNER
    with _MU:
        _ARMED = False
        _FORCED = False
        _OWNER = None


def sync_conf(conf: C.TorchConf) -> None:
    """Align the process tracker with the session conf at a query
    boundary: an enabling conf arms and owns it; only the owner's
    disable disarms; a programmatic forced install wins."""
    global _OWNER
    if _FORCED:
        return
    want = bool(conf.get(C.LOCK_TRACKER_ENABLED))
    if want:
        if not _ARMED:
            install()
        with _MU:
            _OWNER = weakref.ref(conf)
    elif _ARMED and _OWNER is not None and _OWNER() is conf:
        disarm()


def tracker_armed() -> bool:
    return _ARMED


# ------------------------------------------------------------------ #
# Reading
# ------------------------------------------------------------------ #


def _reset_locked() -> None:
    global _CYCLES
    _STATS.clear()
    _EDGES.clear()
    _CYCLES = 0


def reset_stats() -> None:
    """Zero counters and the order graph (armed state unchanged) —
    bench/test phase boundaries."""
    with _MU:
        _reset_locked()


def lock_stats() -> dict[str, dict]:
    """{name: {acquisitions, contention_waits, max_hold_ms}} for every
    lock name seen since arming."""
    with _MU:
        return {
            name: {
                "acquisitions": st.acquisitions,
                "contention_waits": st.contention_waits,
                "max_hold_ms": round(st.max_hold_ns / 1e6, 3),
            }
            for name, st in sorted(_STATS.items())
        }


def aggregate_stats() -> dict:
    """Process totals: monotonic
    ``acquisitions``/``contention_waits``/``cycles``, plus the
    ``max_hold_ms`` high-water gauge across every tracked lock."""
    with _MU:
        return {
            "acquisitions": sum(s.acquisitions
                                for s in _STATS.values()),
            "contention_waits": sum(s.contention_waits
                                    for s in _STATS.values()),
            "max_hold_ms": round(
                max((s.max_hold_ns for s in _STATS.values()),
                    default=0) / 1e6, 3),
            "cycles": _CYCLES,
        }


def cycle_count() -> int:
    with _MU:
        return _CYCLES


def order_graph() -> dict[str, list[str]]:
    """The observed runtime acquisition order (name -> successors) —
    tests assert against it; operators can dump it when diagnosing."""
    with _MU:
        return {a: sorted(bs) for a, bs in sorted(_EDGES.items())}
