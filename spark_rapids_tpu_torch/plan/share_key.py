"""The identities cross-tenant work sharing keys by.

Counterpart of ``spark_rapids_tpu/plan/share_key.py``
(``serving/work_share.py`` uses them):

- :func:`plan_share_key`: the result-cache key of a logical plan, its
  structural serialization (``serving/plan_cache.plan_structural_key``:
  node classes and every attribute, expressions by ``expr_key``,
  in-memory tables by content digest) crossed with the conf
  fingerprint, hashed; None when the plan is not shareable.
- :func:`plan_is_shareable`: only plans built from pure relational
  nodes over pure expressions share results.  Partition-aware
  expressions (rand, monotonically_increasing_id, spark_partition_id),
  Python callables (UDFs, the Arrow and pandas nodes: their key is by
  identity and says nothing of what they compute) and the mutable
  ``Cached`` slot never share.
- :func:`plan_source_digests`: ``(path, size, mtime_ns)`` of every file
  a plan reads: the token a cached result is checked against at lookup,
  so a changed input invalidates it (in-memory tables need none: their
  digest is in the key).
- :func:`scan_share_key`: the in-flight dedup key of one scan task:
  the exec's class, the files (with their stat triples), the columns
  read, the batch rows, the files' Hive partition values and the
  partition fields, the pushed filter's structural key and the
  prefilter mode,
  crossed with the conf fingerprint.  Two scans with one key produce
  the same unit stream, so the second may ride the first's decode.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

from spark_rapids_tpu_torch.plan import logical as L


def _source_stat(path: str) -> tuple[str, int, int]:
    st = os.stat(path)
    return (path, st.st_size, st.st_mtime_ns)


def plan_source_digests(plan: L.LogicalPlan) -> list[tuple]:
    """(path, size, mtime_ns) for every file the plan reads, sorted.
    Raises OSError when a file vanished (callers treat that as
    unshareable)."""
    out: list[tuple] = []

    def walk(p: L.LogicalPlan) -> None:
        if isinstance(p, L.FileRelation):
            for path in p.paths:
                out.append(_source_stat(path))
        for c in p.children:
            walk(c)

    walk(plan)
    return sorted(out)


#: logical nodes whose result is a pure function of (inputs, conf)
_PURE_NODES = (
    L.InMemoryRelation, L.Scan, L.OrcRelation, L.CsvRelation, L.RangeRel,
    L.Project, L.Filter,
    L.Aggregate, L.Sort, L.Limit, L.Join, L.Union, L.Window, L.Expand,
    L.Generate,
)


def _node_exprs(p: L.LogicalPlan) -> list:
    if isinstance(p, L.Project):
        return list(p.exprs)
    if isinstance(p, L.Filter):
        return [p.condition]
    if isinstance(p, L.Aggregate):
        out = list(p.groups)
        for na in p.aggs:
            out.extend(na.fn.inputs())
        return out
    if isinstance(p, L.Sort):
        return [k.expr for k in p.keys]
    if isinstance(p, L.Join):
        out = list(p.left_keys) + list(p.right_keys)
        if p.condition is not None:
            out.append(p.condition)
        return out
    if isinstance(p, L.Window):
        return [we for we, _n in p.window_exprs]
    if isinstance(p, L.Expand):
        return [e for proj in p.projections for e in proj]
    if isinstance(p, L.Generate):
        return [p.generator]
    return []


def _expr_is_pure(e) -> bool:
    from spark_rapids_tpu_torch.exprs.nondeterministic import (
        tree_is_partition_aware,
    )
    from spark_rapids_tpu_torch.exprs.subquery import ScalarSubquery

    if tree_is_partition_aware(e):
        return False
    stack = [e]
    while stack:
        x = stack.pop()
        # Python callables key by identity: a recycled id could alias a
        # cached result onto another function
        if type(x).__module__.endswith("udf.exprs"):
            return False
        if isinstance(x, ScalarSubquery) and not plan_is_shareable(x.plan):
            return False
        stack.extend(x.children)
    return True


def plan_is_shareable(plan: L.LogicalPlan) -> bool:
    """True when the plan's result is a pure function of its inputs'
    content and the conf (module docstring)."""
    if not isinstance(plan, _PURE_NODES):
        return False
    if not all(_expr_is_pure(e) for e in _node_exprs(plan)):
        return False
    return all(plan_is_shareable(c) for c in plan.children)


def _digest(payload: str) -> str:
    return hashlib.sha256(payload.encode()).hexdigest()[:24]


def plan_share_key(plan: L.LogicalPlan, conf) -> Optional[str]:
    """The result-cache key: structural plan identity x conf fingerprint
    (None when the plan is not shareable).  File content is not in the
    key: it is the invalidation token (:func:`plan_source_digests`),
    checked at lookup, so a changed input invalidates the stale entry
    instead of orphaning it under a new key."""
    if not plan_is_shareable(plan):
        return None
    from spark_rapids_tpu_torch.eventlog import conf_fingerprint
    from spark_rapids_tpu_torch.serving.plan_cache import plan_structural_key

    try:
        structural = plan_structural_key(plan)
    except Exception:
        return None  # an attribute with no serialization: never guess
    return _digest(structural + "|" + conf_fingerprint(conf))


def scan_share_key(scan, task: int, conf) -> Optional[str]:
    """The in-flight dedup key of one file scan task (module
    docstring).  None when its unit stream is not provably the same
    across queries: a runtime filter applies (its publication time is
    the query's), or the pushed filter has no structural key."""
    if getattr(scan, "runtime_filters", None):
        return None
    from spark_rapids_tpu_torch.eventlog import conf_fingerprint
    from spark_rapids_tpu_torch.exprs.base import expr_key

    parts: list[str] = [type(scan).__name__, str(task)]
    try:
        for p in scan.task_paths(task):
            parts.append(repr(_source_stat(p)))
    except OSError:
        return None
    parts.append(repr(scan.columns))
    parts.append(repr(scan.batch_rows))
    # two directories never share a scan: each file's partition values
    values = getattr(scan, "task_partition_values", None)
    parts.append(repr(values(task) if values is not None else []))
    parts.append(repr([(f.name, f.dtype.name)
                       for f in getattr(scan, "partition_fields", ())]))
    parts.append(repr(bool(getattr(scan, "input_files", False))))
    pushed = getattr(scan, "pushed_filter", None)
    if pushed is not None:
        try:
            parts.append(expr_key(pushed))
        except Exception:
            return None  # no structural form: never guess
    else:
        parts.append("-")
    parts.append(repr(bool(getattr(scan, "exact_prefilter", False))))
    parts.append(repr(scan.device))
    parts.append(conf_fingerprint(conf))
    return _digest("|".join(parts))
