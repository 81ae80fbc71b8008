"""Prepared-plan cache: lowered exec trees keyed by structural plan
identity, so a repeated query template is not planned again.

Counterpart of ``spark_rapids_tpu/serving/plan_cache.py``.  The cached
object is the whole lowered exec tree, keyed by

- the structural plan key: the logical plan serialized as node class
  names plus every attribute, expressions by ``exprs/base.expr_key``
  (ordinals, types, literal values), in-memory tables by their content
  digest (a key by address could alias a recycled address onto other
  data);
- the conf fingerprint (``eventlog.conf_fingerprint``): lowering reads
  the conf, so two conf epochs never share a tree;
- for SQL templates, the parameter binding: bound values are literals
  in the lowered plan, so each binding is its own entry.

A hit drains the cached tree again: every exec returns to its
pre-execute state on ``close()`` (join builds, shuffle registrations,
adaptive decisions, runtime filters), which ``tests/test_torch_serving.py``
asserts.  Operator metrics on a cached tree accumulate across
executions.  Eviction is LRU, bounded by
``spark.rapids.tpu.serving.planCache.capacity``; an evicted tree is
closed.  The hit, miss and eviction counters are process-wide
(:func:`stats`).  The JAX cache's disk tier (``persist.py``) is not
ported.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
from typing import Any, Optional

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.robustness.lock_tracker import tracked_lock

# ------------------------------------------------------------------ #
# Structural keys
# ------------------------------------------------------------------ #


def _value_key(v: Any, seen: dict) -> str:
    """Serialize one logical-plan attribute value deterministically.
    Correctness rule: two plans that could EXECUTE differently must
    never share a key — when in doubt, serialize more, not less."""
    import pyarrow as pa

    from spark_rapids_tpu_torch.exprs.aggregates import (
        AggregateFunction,
        NamedAgg,
    )
    from spark_rapids_tpu_torch.exprs.base import Expression, expr_key
    from spark_rapids_tpu_torch.plan.logical import LogicalPlan

    if isinstance(v, Expression):
        try:
            return expr_key(v)
        except TypeError:
            return repr(v)

    if isinstance(v, NamedAgg):
        return (f"NamedAgg({_value_key(v.fn, seen)},"
                f"{v.out_name!r})")
    if isinstance(v, AggregateFunction) or (
            dataclasses.is_dataclass(v) and not isinstance(v, type)):
        # an address-based repr would mint a fresh key per plan
        # instance and defeat every structural-identity consumer (the
        # prepared-plan cache across template objects, the result
        # cache): serialize class + attributes instead
        parts = [f"{k}={_value_key(x, seen)}"
                 for k, x in sorted(vars(v).items())]
        return f"{type(v).__name__}({','.join(parts)})"
    if isinstance(v, LogicalPlan):
        return plan_structural_key(v, seen)
    if isinstance(v, pa.Table):
        # content digest, not id(): a recycled address must not alias
        # a dead table's key onto different data
        from spark_rapids_tpu_torch.eventlog import table_digest

        return f"table:{table_digest(v)}"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_value_key(x, seen) for x in v) + "]"
    if isinstance(v, (set, frozenset)):
        return "{" + ",".join(sorted(_value_key(x, seen)
                                     for x in v)) + "}"
    if isinstance(v, dict):
        return "{" + ",".join(
            f"{_value_key(k, seen)}:{_value_key(x, seen)}"
            for k, x in sorted(v.items(), key=lambda kv: repr(kv[0]))
        ) + "}"
    if callable(v):
        # UDFs and pandas functions have no structural form; identity
        # keys them (the PreparedQuery holds the plan alive, so the id
        # cannot be recycled while the entry is reachable via its key
        # holder — see PreparedQuery, which keeps the DataFrame)
        return f"fn:{getattr(v, '__qualname__', '?')}@{id(v)}"
    return repr(v)


def plan_structural_key(plan, seen: Optional[dict] = None) -> str:
    """Deterministic structural serialization of a LOGICAL plan tree:
    class names + every instance attribute (expressions via
    ``expr_key``), recursing into children.
    A node visited twice (a DAG: `a.union(b).union(a)` shares `a`)
    serializes as ``ref:N`` — its first-visit ordinal, assigned in
    deterministic traversal order — so WHICH node repeats is part of
    the key; a class-name-only marker would collide plans that share
    different subtrees of one class."""
    if seen is None:
        seen = {}
    import pyarrow as pa

    ref = seen.get(id(plan))
    if ref is not None:
        return f"ref:{ref}"
    seen[id(plan)] = len(seen)
    digester = getattr(plan, "content_digest", None)
    parts = [type(plan).__name__]
    for k, v in sorted(vars(plan).items()):
        if k.startswith("_") and k != "_schema":
            continue
        if isinstance(v, pa.Table) and digester is not None:
            # the node memoizes its own content digest
            # (InMemoryRelation.content_digest): same digest-keyed
            # identity as _value_key's table branch, hashed once per
            # relation instead of once per prepare()
            parts.append(f"{k}=table:{digester()}")
            continue
        parts.append(f"{k}={_value_key(v, seen)}")
    return f"{parts[0]}[{','.join(parts[1:])}]"


def template_key(plan, conf) -> str:
    """The cache key of a DataFrame template: structural plan key x
    conf fingerprint, hashed."""
    from spark_rapids_tpu_torch.eventlog import conf_fingerprint

    payload = plan_structural_key(plan) + "|" + conf_fingerprint(conf)
    return hashlib.sha256(payload.encode()).hexdigest()[:24]


def _normalize_sql(text: str) -> str:
    """Whitespace-normalize a SQL template WITHOUT reaching inside
    string literals: token texts joined by one space.  A naive
    ``" ".join(text.split())`` would collapse ``'a  b'`` and ``'a b'``
    onto one key — a stale hit answering the wrong query.  Templates
    the tokenizer rejects key on their raw text (the parse error
    surfaces at lowering, never as a wrong cache hit)."""
    from spark_rapids_tpu_torch.frontends.sql import SqlError, _tokenize

    try:
        return " ".join(tok[1] for tok in _tokenize(text))
    except SqlError:
        return text


def binding_key(params: Optional[dict]) -> str:
    """Canonical serialization of one parameter binding — THE single
    definition (the PreparedQuery key memo and sql_template_key must
    agree to the bit, or a memoized key could alias a different
    binding onto one entry)."""
    if not params:
        return ""
    return repr(sorted((str(k), repr(v)) for k, v in params.items()))


def sql_template_key(text: str, conf,
                     params: Optional[dict] = None) -> str:
    """The cache key of a SQL template: normalized text x conf
    fingerprint x the parameter binding (each binding is its own
    entry)."""
    from spark_rapids_tpu_torch.eventlog import conf_fingerprint

    payload = (_normalize_sql(text) + "|" + conf_fingerprint(conf)
               + "|" + binding_key(params))
    return hashlib.sha256(payload.encode()).hexdigest()[:24]


# ------------------------------------------------------------------ #
# Process-global counters (per-cache caches, one counter surface)
# ------------------------------------------------------------------ #

_STATS_LOCK = threading.Lock()
_HITS = 0
_MISSES = 0
_EVICTIONS = 0


def stats() -> dict:
    """Cumulative process-wide plan-cache counters {hits, misses,
    evictions, hit_rate} (every session's cache ticks them; diff two
    reads for a window)."""
    with _STATS_LOCK:
        total = _HITS + _MISSES
        return {
            "hits": _HITS,
            "misses": _MISSES,
            "evictions": _EVICTIONS,
            "hit_rate": round(_HITS / total, 3) if total else 0.0,
        }


def reset_stats() -> None:
    global _HITS, _MISSES, _EVICTIONS
    with _STATS_LOCK:
        _HITS = 0
        _MISSES = 0
        _EVICTIONS = 0


# ------------------------------------------------------------------ #
# The cache
# ------------------------------------------------------------------ #


class DrainLock:
    """Non-reentrant drain mutex with same-thread deadlock DETECTION.

    A partially consumed ``execute_stream()`` holds its entry's drain
    lock across yields ON THE CONSUMER THREAD; if that thread then
    re-executes the same template, a plain Lock would block forever
    with no diagnostic.  Re-entry by the owning thread raises
    immediately instead — drain or close the open stream first.
    Cross-thread acquisition blocks normally (that is the serializing
    contract).  The owner check is race-free: another thread's ident
    never equals ours, and our own owner writes happen-before our own
    reads."""

    __slots__ = ("_lock", "_owner")

    def __init__(self):
        self._lock = threading.Lock()
        self._owner = None

    def acquire(self, blocking: bool = True) -> bool:
        if self._owner == threading.get_ident():
            raise RuntimeError(
                "this prepared template is still draining on this "
                "thread (an execute_stream() not yet drained or "
                "closed?); finish or close() the open stream before "
                "re-executing it")
        ok = self._lock.acquire(blocking)
        if ok:
            self._owner = threading.get_ident()
        return ok

    def release(self) -> None:
        self._owner = None
        self._lock.release()

    def __enter__(self) -> "DrainLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class CacheEntry:
    """One cached lowered plan, the tagged tree it came from, and the
    DataFrame that lowered to it (the structural key's identity-keyed
    parts need the logical plan kept alive).  ``lock`` serializes
    re-drains of the shared exec tree: one template executed from two
    threads must not interleave two drains of one tree."""

    __slots__ = ("exec_", "meta", "plan_hash", "df", "lock")

    def __init__(self, exec_, meta, plan_hash: str, df=None):
        self.exec_ = exec_
        self.meta = meta
        self.plan_hash = plan_hash
        self.df = df
        self.lock = DrainLock()


class PlanCache:
    """Per-session LRU of :class:`CacheEntry` (see module doc)."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = C.DEFAULTS[C.PLAN_CACHE_CAPACITY]
        self.capacity = max(1, int(capacity))
        # guard: _mu
        self._entries: "collections.OrderedDict[str, CacheEntry]" = \
            collections.OrderedDict()
        self._mu = tracked_lock("planCache.mu")

    def lookup(self, key: str) -> Optional[CacheEntry]:
        """Get-and-touch; ticks the global hit/miss counters."""
        global _HITS, _MISSES
        with self._mu:
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
        with _STATS_LOCK:
            if e is None:
                _MISSES += 1
            else:
                _HITS += 1
        return e

    def insert(self, key: str, entry: CacheEntry) -> CacheEntry:
        """Insert (first writer wins under a race) and evict past
        capacity; evicted exec trees are close()d so they release any
        held resources."""
        global _EVICTIONS
        evicted: list[CacheEntry] = []
        with self._mu:
            cur = self._entries.get(key)
            if cur is not None:
                self._entries.move_to_end(key)
                return cur
            self._entries[key] = entry
            while len(self._entries) > self.capacity:
                _k, old = self._entries.popitem(last=False)
                evicted.append(old)
        if evicted:
            with _STATS_LOCK:
                _EVICTIONS += len(evicted)
            for old in evicted:
                self._close_entry(old)
        return entry

    @staticmethod
    def _close_entry(old: CacheEntry) -> None:
        """Best-effort teardown of an evicted entry: only under its
        drain lock (closing during a drain tears state out from under
        the iterator), and only if the lock is free: an in-flight
        drain closes its own tree when it finishes, and blocking (or
        raising, if the evicting thread itself holds the lock through
        an open stream) would stall an innocent prepare()."""
        try:
            if not old.lock.acquire(blocking=False):
                return
        except RuntimeError:
            return  # this thread's own open stream owns the drain
        from spark_rapids_tpu_torch.plan.planner import close_tree

        try:
            close_tree(old.exec_)
        except Exception:
            pass
        finally:
            old.lock.release()

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

