"""Speculative output sizing: predict a stream loop's data-dependent
output counts so that its dispatch half never waits on a sizing
readback.

Counterpart of ``spark_rapids_tpu/parallel/speculation.py``.  Three
loops size their output from a count that lives on the device: the
join's pair count (tag ``join.probe``), the aggregate's partial group
count (``agg.size``) and the exchange's split counts
(``exchange.split``).  Read blocking, each count stops the host from
queuing the next batch's kernels.  With speculation on (the default):

- the join dispatches its expansion at the bucket a
  :class:`SizePredictor` predicts, and the aggregate its update at the
  batch's rows (a group-by never has more groups), in the dispatch
  half, with no sync (``ops/groupby.py::groupby_aggregate_at_capacity``);
- the count is read by ``parallel/pipeline.py::device_read_async``: a
  pinned ``non_blocking`` copy and a CUDA event.  The JAX package's
  harvester thread, and its grace window, have no counterpart:
  ``ReadbackFuture.result()`` is free once the event has completed;
- the loop's retire half reconciles: a batch at its speculated capacity
  is cut to its live rows by ``slice_prefix`` (views, no device work)
  before anything downstream sees it, so no batch with a pending count
  ever leaves the exec.  An undershoot of the join continues from
  ``offset=cap`` to the blocking path's chunk boundary; nothing is
  rolled back.  The join's speculated chunks in flight hold at most
  :data:`MAX_INFLIGHT_BYTES`; past it a batch reads its count blocking.

A :class:`SizePredictor` is an EWMA (alpha 0.4) of one program key's
observed counts, scaled by ``safetyFactor`` and bucketed by
``columnar/column.py::pad_capacity``; it speculates after
``warmupBatches`` observations (the warm-up batches pay the blocking
read).  Predictors are keyed by the exec's program key
(``execs/jit_cache.py``), process-wide and thread-safe.

The kill switch (``adaptive.minHitRate`` > 0): a tag whose hit rate
over its last ``adaptive.window`` outcomes falls below the floor is
disabled until :func:`reset_stats`; its execs then pay the blocking
read.  A conviction shows in :func:`disabled_tags`, counts in
:func:`disabled_total` (which survives ``reset_stats``) and records a
``speculation.disabled`` trace instant, beside ``speculation.hit`` and
``speculation.overflow``; :func:`parallel.pipeline.trace_events` sees
``spec_hit`` / ``spec_overflow`` / ``spec_disabled``.

The JAX module reads its keys from its process conf; here a session's
keys travel to its execs as a :class:`SpeculationPolicy`
(``execs/base.py::TaskRuntime.speculation``).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Optional

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import trace as _tr
from spark_rapids_tpu_torch.columnar.column import pad_capacity
from spark_rapids_tpu_torch.parallel import pipeline as _P

#: EWMA step: about four batches of memory
_EWMA_ALPHA = 0.4

#: the device bytes that join chunks dispatched at a speculated capacity
#: may hold at once, process-wide.  Such a chunk is made a batch ahead,
#: while the batch before it is still downstream, and the buffer store
#: does not see it: on TPC-DS q72 (four pool threads, a chain of wide
#: joins, a chunk in flight in each) they raised the allocator's peak
#: from 34 to 50 GB on an H100 80GB HBM3 at 700 W (PERF.md §6).  A dispatch
#: that would pass it reads its count blocking instead (``declined``).
MAX_INFLIGHT_BYTES = 1 << 30
_INFLIGHT = 0
_INFLIGHT_LOCK = threading.Lock()


def reserve_inflight(nbytes: int) -> bool:
    """Take ``nbytes`` of the in-flight budget; False (nothing taken)
    when it would pass :data:`MAX_INFLIGHT_BYTES`."""
    global _INFLIGHT
    with _INFLIGHT_LOCK:
        if _INFLIGHT + nbytes > MAX_INFLIGHT_BYTES:
            return False
        _INFLIGHT += nbytes
        return True


def release_inflight(nbytes: int) -> None:
    """Give back what :func:`reserve_inflight` took."""
    global _INFLIGHT
    with _INFLIGHT_LOCK:
        _INFLIGHT -= nbytes


def inflight_bytes() -> int:
    """Bytes of speculated chunks dispatched and not yet retired."""
    with _INFLIGHT_LOCK:
        return _INFLIGHT


@dataclasses.dataclass(frozen=True)
class SpeculationPolicy:
    """A session's speculation keys (``sql.speculation.*``)."""

    enabled: bool = C.DEFAULTS[C.SPECULATION_ENABLED]
    safety_factor: float = C.DEFAULTS[C.SPECULATION_SAFETY_FACTOR]
    warmup_batches: int = C.DEFAULTS[C.SPECULATION_WARMUP_BATCHES]
    force_capacity: int = C.DEFAULTS[C.SPECULATION_TEST_FORCE_CAPACITY]
    min_hit_rate: float = C.DEFAULTS[C.SPECULATION_MIN_HIT_RATE]
    window: int = C.DEFAULTS[C.SPECULATION_WINDOW]

    @classmethod
    def from_conf(cls, conf: C.TorchConf) -> "SpeculationPolicy":
        return cls(conf.get(C.SPECULATION_ENABLED),
                   conf.get(C.SPECULATION_SAFETY_FACTOR),
                   conf.get(C.SPECULATION_WARMUP_BATCHES),
                   conf.get(C.SPECULATION_TEST_FORCE_CAPACITY),
                   conf.get(C.SPECULATION_MIN_HIT_RATE),
                   conf.get(C.SPECULATION_WINDOW))


DEFAULT_POLICY = SpeculationPolicy()


class SizePredictor:
    """EWMA of one program key's observed output counts.  Thread-safe:
    pooled map tasks and partition-wise joins observe at once."""

    __slots__ = ("key", "ewma", "observations", "_lock")

    def __init__(self, key):
        self.key = key
        self.ewma = 0.0
        self.observations = 0
        self._lock = threading.Lock()

    def observe(self, n: int) -> None:
        with self._lock:
            self.observations += 1
            if self.observations == 1:
                self.ewma = float(n)
            else:
                self.ewma += _EWMA_ALPHA * (float(n) - self.ewma)

    def predict(self, policy: SpeculationPolicy = DEFAULT_POLICY,
                cap_ceiling: Optional[int] = None) -> Optional[int]:
        """The speculated capacity bucket, or None during warm-up (the
        caller then pays the blocking read).  ``cap_ceiling`` clamps
        it."""
        with self._lock:
            obs, ewma = self.observations, self.ewma
        if obs < policy.warmup_batches:
            return None
        if policy.force_capacity > 0:
            cap = pad_capacity(policy.force_capacity)
        else:
            cap = pad_capacity(max(1, int(ewma * policy.safety_factor)))
        if cap_ceiling is not None:
            cap = min(cap, cap_ceiling)
        return cap


#: an LRU, as the program keys are: a long-lived process serving many
#: query shapes must not keep a predictor per key forever
_PREDICTORS: "collections.OrderedDict" = collections.OrderedDict()
MAX_PREDICTORS = 512
_PRED_LOCK = threading.Lock()


def predictor(key) -> SizePredictor:
    """The process-wide predictor of a structural program key, made on
    first use: two execs of equal keys size alike and share one."""
    with _PRED_LOCK:
        p = _PREDICTORS.get(key)
        if p is None:
            p = _PREDICTORS[key] = SizePredictor(key)
            while len(_PREDICTORS) > MAX_PREDICTORS:
                _PREDICTORS.popitem(last=False)
        else:
            _PREDICTORS.move_to_end(key)
        return p


def reset_predictors() -> None:
    """Drop every predictor (test isolation)."""
    with _PRED_LOCK:
        _PREDICTORS.clear()


# ------------------------------------------------------------------ #
# Hits, overflows and the kill switch
# ------------------------------------------------------------------ #

_STATS: dict[str, dict] = {}
_STATS_LOCK = threading.Lock()
#: per tag, the rolling window of outcomes (True: a hit)
_WINDOWS: dict[str, "collections.deque"] = {}
_DISABLED: set[str] = set()
_DISABLED_TOTAL = 0


def _stat(tag: str) -> dict:
    s = _STATS.get(tag)
    if s is None:
        s = _STATS[tag] = {"hits": 0, "overflows": 0, "synced": 0,
                           "declined": 0}
    return s


def _observe_outcome_locked(tag: str, hit: bool,
                            policy: SpeculationPolicy) -> bool:
    """Feed the tag's window; True when this outcome convicted it (the
    caller records the events outside the lock)."""
    global _DISABLED_TOTAL
    if policy.min_hit_rate <= 0.0 or tag in _DISABLED:
        return False
    w = _WINDOWS.get(tag)
    if w is None or w.maxlen != policy.window:
        w = _WINDOWS[tag] = collections.deque(w or (), maxlen=policy.window)
    w.append(hit)
    if len(w) < policy.window:
        return False
    if sum(w) / float(policy.window) >= policy.min_hit_rate:
        return False
    _DISABLED.add(tag)
    _DISABLED_TOTAL += 1
    return True


def _note_disabled(tag: str) -> None:
    _P._trace("spec_disabled", tag)
    if _tr.TRACER.enabled:
        _tr.event("speculation.disabled", tag=tag, hit_rate=hit_rate((tag,)))


def _record(tag: str, hit: bool, cap: int, actual: int,
            policy: SpeculationPolicy) -> None:
    with _STATS_LOCK:
        _stat(tag)["hits" if hit else "overflows"] += 1
        tripped = _observe_outcome_locked(tag, hit, policy)
    _P._trace("spec_hit" if hit else "spec_overflow", tag)
    if _tr.TRACER.enabled:
        _tr.event("speculation.hit" if hit else "speculation.overflow",
                  tag=tag, cap=cap, actual=actual)
    if tripped:
        _note_disabled(tag)


def record_hit(tag: str, cap: int = 0, actual: int = 0,
               policy: SpeculationPolicy = DEFAULT_POLICY) -> None:
    """The speculated capacity covered the true count: the batch was
    sized with no blocking readback."""
    _record(tag, True, cap, actual, policy)


def record_overflow(tag: str, cap: int = 0, actual: int = 0,
                    policy: SpeculationPolicy = DEFAULT_POLICY) -> None:
    """An undershoot: the speculated chunk went out and the exec went on
    from ``offset=cap``."""
    _record(tag, False, cap, actual, policy)


def record_sync(tag: str) -> None:
    """A warm-up batch paid the blocking read."""
    with _STATS_LOCK:
        _stat(tag)["synced"] += 1


def record_declined(tag: str) -> None:
    """A warmed batch paid the blocking read because its chunk would
    have passed the in-flight budget (:data:`MAX_INFLIGHT_BYTES`)."""
    with _STATS_LOCK:
        _stat(tag)["declined"] += 1


def tag_enabled(tag: str) -> bool:
    """False once the kill switch convicted ``tag``: its execs make no
    predictor and pay the blocking read."""
    with _STATS_LOCK:
        return tag not in _DISABLED


def disabled_tags() -> list[str]:
    """The tags the kill switch has disabled, sorted."""
    with _STATS_LOCK:
        return sorted(_DISABLED)


def disabled_total() -> int:
    """Kill-switch trips in this process; monotonic (``reset_stats``
    keeps it, so a per-query delta names the query that tripped it)."""
    with _STATS_LOCK:
        return _DISABLED_TOTAL


def stats() -> dict[str, dict]:
    """Per tag, ``{hits, overflows, synced, declined}`` since the last
    reset."""
    with _STATS_LOCK:
        return {k: dict(v) for k, v in _STATS.items()}


def reset_stats() -> None:
    """Zero the counters and re-arm the kill switch (its windows and
    convictions), so one query's conviction does not carry into the
    next measurement; ``disabled_total`` stays."""
    with _STATS_LOCK:
        _STATS.clear()
        _WINDOWS.clear()
        _DISABLED.clear()


def hit_rate(tags=None) -> float:
    """Hits over speculated dispatches (hits + overflows) of ``tags``
    (default: all), rounded to 3 places; 0.0 when none."""
    hits = ovf = 0
    for tag, s in stats().items():
        if tags is not None and tag not in tags:
            continue
        hits += s["hits"]
        ovf += s["overflows"]
    total = hits + ovf
    return round(hits / total, 3) if total else 0.0
