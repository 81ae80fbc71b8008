"""The port's front door: a pyspark-shaped session and DataFrame.

Counterpart of ``spark_rapids_tpu/session.py`` for the slices ported so
far: ``TorchSession.read_parquet / create_dataframe / range`` and
``DataFrame.where / select / with_column / group_by(...).agg / rollup /
cube / grouping_sets / agg / join / union / order_by / limit /
collect``, with ``col``, ``lit``, ``sum_``, ``avg``, ``count``,
``count_star``, ``count_distinct``, ``min_``, ``max_``, ``first`` and
``last``.  ``select`` takes window expressions (``rank()``,
``row_number()``, ``dense_rank()``, ``lead``, ``lag`` or an aggregate,
``.over(Window.partition_by(...).order_by(...))``) anywhere in its
list: they are extracted into ``Window`` plan nodes under the
projection, one per (partition_by, order_by) group.

As there, grouping sets (rollup, cube) become an Expand that nulls
each set's dropped keys and tags its rows with ``__gid``, an aggregate
over the keys and ``__gid``, and a projection that drops ``__gid``;
``count_distinct`` becomes a two-level aggregate; ``union`` widens its
members' column types (INT < LONG < DOUBLE, NULL to anything) with a
cast, or raises TypeError.  ``grouping()`` / ``grouping_id()``, and
``count_distinct`` beside other aggregates or over grouping sets, are
not in the JAX package and not here.

A session runs on one device, ``cuda`` unless the caller asks for the
CPU.  Asking for CUDA on a host without it raises: nothing falls back
to the CPU.  It owns its shuffle manager, its task semaphore (sized by
``sql.concurrentTpuTasks`` when it is made) and, on CUDA, the side
stream its scans upload on.  ``collect`` runs the plan on a
``result.fetch`` stage and converts each batch as it comes, as the JAX
package's ``stream_exec`` does.  ``config.SERIAL`` holds the keys that
run a query serially.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Union

import pyarrow as pa
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import TorchConf
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.execs.sort import SortKey
from spark_rapids_tpu_torch.exprs.aggregates import (
    AggregateFunction,
    Average,
    Count,
    CountDistinct,
    CountStar,
    First,
    Last,
    Max,
    Min,
    NamedAgg,
    Sum,
)
from spark_rapids_tpu_torch.exprs.base import (
    BoundReference,
    ColumnReference,
    Expression,
    Literal,
    _column,
    _expr,
    col,
    lit,
)
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.window import WindowExpression
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.planner import Planner, collect_exec
from spark_rapids_tpu_torch.plan.runtime_filter import render_runtime_filters
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager

__all__ = ["TorchSession", "DataFrame", "col", "lit", "sum_", "avg",
           "count", "count_star", "count_distinct", "min_", "max_",
           "first", "last"]

AggLike = Union[NamedAgg, AggregateFunction, tuple]


def sum_(e) -> Sum:
    return Sum(_column(e))


def avg(e) -> Average:
    return Average(_column(e))


def count(e) -> Count:
    return Count(_column(e))


def count_star() -> CountStar:
    return CountStar()


def min_(e) -> Min:
    return Min(_column(e))


def max_(e) -> Max:
    return Max(_column(e))


def count_distinct(e) -> CountDistinct:
    return CountDistinct(_column(e))


def first(e, ignore_nulls: bool = False) -> First:
    return First(_column(e), ignore_nulls)


def last(e, ignore_nulls: bool = False) -> Last:
    return Last(_column(e), ignore_nulls)


def _coerce_union_member(plan: L.LogicalPlan,
                         widened: Sequence[Optional[T.DataType]]
                         ) -> L.LogicalPlan:
    """A union member projected onto the widened column types; the
    member itself when nothing changes.  Columns are read by name, or by
    position where a name occurs twice."""
    fields = plan.schema.fields
    if all(ct is None or ct == f.dtype for f, ct in zip(fields, widened)):
        return plan
    unique = len(set(plan.schema.names)) == len(fields)
    exprs: list[Expression] = []
    for i, (f, ct) in enumerate(zip(fields, widened)):
        ref = ColumnReference(f.name) if unique \
            else BoundReference(i, f.dtype, f.nullable, f.name)
        exprs.append(ref if ct is None or ct == f.dtype
                     else Cast(ref, ct).alias(f.name))
    return L.Project(exprs, plan)


def _extract_windows(e: Expression, acc: list) -> Expression:
    """``e`` with every window expression replaced by a reference to a
    generated column ``__w<i>``; the expressions and names go to
    ``acc``."""
    if isinstance(e, WindowExpression):
        name = f"__w{len(acc)}"
        acc.append((e, name))
        return ColumnReference(name)
    kids = e.children
    new = [_extract_windows(c, acc) for c in kids]
    if all(n is o for n, o in zip(new, kids)):
        return e
    return e.with_children(new)


class TorchSession:
    def __init__(self, conf: Optional[Union[TorchConf, dict]] = None,
                 device: Union[str, torch.device] = "cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchSession(device='cuda') needs a CUDA device and "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "to run on the CPU")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        self.device = device
        self.conf = conf if isinstance(conf, TorchConf) else TorchConf(conf)
        self.shuffle_manager = ShuffleManager()
        self.semaphore = TpuSemaphore(self.conf.get(C.CONCURRENT_TASKS))
        self.upload_stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None

    def read_parquet(self, *paths: str) -> "DataFrame":
        return DataFrame(L.Scan(list(paths)), self)

    def create_dataframe(self, data: Union[pa.Table, dict]) -> "DataFrame":
        """A host Arrow table (or a dict of columns) as a DataFrame; its
        batches upload to the session's device."""
        table = data if isinstance(data, pa.Table) else pa.table(data)
        return DataFrame(L.InMemoryRelation(table), self)

    def range(self, start: int, end: Optional[int] = None,
              step: int = 1) -> "DataFrame":
        """``id`` (LONG) from ``start`` to ``end`` (exclusive), or from
        0 to ``start`` when ``end`` is None."""
        if end is None:
            start, end = 0, start
        return DataFrame(L.RangeRel(start, end, step), self)


class GroupedData:
    """A grouped frame; ``grouping_sets`` (each the set of key names it
    keeps) makes an Expand-based aggregate of every set."""

    def __init__(self, df: "DataFrame", keys: list[Expression],
                 grouping_sets: Optional[list[frozenset]] = None):
        self._df = df
        self._keys = keys
        self._sets = grouping_sets

    def agg(self, *aggs: AggLike) -> "DataFrame":
        named = []
        for i, a in enumerate(aggs):
            if isinstance(a, NamedAgg):
                named.append(a)
            elif isinstance(a, tuple):
                named.append(NamedAgg(*a))
            else:
                named.append(NamedAgg(a, f"{a.name}_{i}"))
        if any(isinstance(na.fn, CountDistinct) for na in named):
            return self._agg_distinct(named)
        if self._sets is not None:
            return self._agg_grouping_sets(named)
        return DataFrame(L.Aggregate(self._keys, named, self._df._plan),
                         self._df._session)

    def _agg_distinct(self, named: list[NamedAgg]) -> "DataFrame":
        """count(DISTINCT x) as two aggregates: group by (keys, x) to
        drop repeats, then count x per key group (Spark's
        RewriteDistinctAggregates for a single distinct)."""
        if self._sets is not None:
            raise ValueError("count_distinct over grouping sets is not "
                             "supported")
        if not all(isinstance(na.fn, CountDistinct) for na in named):
            raise ValueError("count_distinct beside other aggregates is "
                             "not supported")
        x = named[0].fn.child
        if any(na.fn.child != x for na in named[1:]):
            raise ValueError("count_distinct over different expressions "
                             "is not supported")
        inner = L.Aggregate(self._keys + [x.alias("__dist")], [],
                            self._df._plan)
        key_names = inner.schema.names[: len(self._keys)]
        outer = L.Aggregate(
            [ColumnReference(n) for n in key_names],
            [NamedAgg(Count(ColumnReference("__dist")), na.out_name)
             for na in named], inner)
        return DataFrame(outer, self._df._session)

    def _agg_grouping_sets(self, named: list[NamedAgg]) -> "DataFrame":
        """Expand (a projection a set: the child's columns with the
        set's dropped keys NULL, and ``__gid``, the set's index), an
        aggregate over the keys and ``__gid``, then the keys and the
        aggregates without ``__gid``."""
        child = self._df._plan
        key_names = []
        for k in self._keys:
            if not isinstance(k, ColumnReference):
                raise ValueError("grouping-set keys must be plain columns")
            key_names.append(k.col_name)
        fields = child.schema.fields
        projections = [
            [Literal(None, f.dtype)
             if f.name in key_names and f.name not in included
             else ColumnReference(f.name) for f in fields]
            + [Literal.of(gid)]
            for gid, included in enumerate(self._sets)]
        expand = L.Expand(projections, [f.name for f in fields] + ["__gid"],
                          child)
        agg = L.Aggregate(list(self._keys) + [ColumnReference("__gid")],
                          named, expand)
        return DataFrame(L.Project(
            [ColumnReference(n)
             for n in key_names + [na.out_name for na in named]], agg),
            self._df._session)


class DataFrame:
    def __init__(self, plan: L.LogicalPlan, session: TorchSession):
        self._plan = plan
        self._session = session

    @property
    def schema(self) -> T.Schema:
        return self._plan.schema

    def select(self, *exprs) -> "DataFrame":
        """Projection of expressions or column names; window expressions
        in it become ``Window`` nodes under it, one per (partition_by,
        order_by) group, as Spark's ExtractWindowExpressions rule does."""
        acc: list = []
        rewritten = [_extract_windows(_column(e), acc) for e in exprs]
        groups: list[tuple[tuple, list]] = []
        for we, name in acc:
            key = (we.spec.partition_by, we.spec.order_by)
            for k, members in groups:
                if k == key:
                    members.append((we, name))
                    break
            else:
                groups.append((key, [(we, name)]))
        plan = self._plan
        for _, members in groups:
            plan = L.Window(members, plan)
        return DataFrame(L.Project(rewritten, plan), self._session)

    def where(self, cond: Expression) -> "DataFrame":
        return DataFrame(L.Filter(cond, self._plan), self._session)

    filter = where

    def with_column(self, name: str, e: Expression) -> "DataFrame":
        """Every other column, then ``e`` as ``name`` (replacing a column
        of that name)."""
        return self.select(*[ColumnReference(n) for n in self.schema.names
                             if n != name], e.alias(name))

    def group_by(self, *keys) -> GroupedData:
        return GroupedData(self, [_expr(k) for k in keys])

    def rollup(self, *keys: str) -> GroupedData:
        """GROUP BY ROLLUP: (a, b, c) -> the sets (a, b, c), (a, b), (a)
        and ()."""
        return GroupedData(self, [_column(k) for k in keys], [
            frozenset(keys[:i]) for i in range(len(keys), -1, -1)])

    def cube(self, *keys: str) -> GroupedData:
        """GROUP BY CUBE: every subset of the keys, largest first."""
        return GroupedData(self, [_column(k) for k in keys], [
            frozenset(c) for r in range(len(keys), -1, -1)
            for c in itertools.combinations(keys, r)])

    def grouping_sets(self, sets: Sequence[Sequence[str]],
                      keys: Sequence[str]) -> GroupedData:
        """GROUP BY GROUPING SETS: ``sets`` of the key names in ``keys``."""
        return GroupedData(self, [_column(k) for k in keys],
                           [frozenset(st) for st in sets])

    def agg(self, *aggs: AggLike) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def join(self, other: "DataFrame",
             on: Union[str, Sequence[str], None] = None, how: str = "inner",
             left_on: Optional[Sequence] = None,
             right_on: Optional[Sequence] = None,
             condition: Optional[Expression] = None) -> "DataFrame":
        """Equi-join on ``on`` (column names both sides share) or on
        ``left_on`` / ``right_on``; the output is left ++ right columns.
        ``condition`` (inner joins only) is a residual predicate over
        them; ``how="cross"``, or an inner join with no keys, pairs every
        row with every row."""
        if on is not None:
            names = [on] if isinstance(on, str) else list(on)
            lk = [ColumnReference(n) for n in names]
            rk = [ColumnReference(n) for n in names]
        else:
            lk = [_expr(e) for e in (left_on or [])]
            rk = [_expr(e) for e in (right_on or [])]
        return DataFrame(L.Join(self._plan, other._plan, lk, rk, how,
                                condition), self._session)

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL by position: each column of the two members widened
        to their common type (Spark's WidenSetOperationTypes), or
        TypeError; the output names are this frame's."""
        lf, rf = self.schema.fields, other.schema.fields
        if len(lf) != len(rf):
            raise TypeError(f"union members have {len(lf)} and {len(rf)} "
                            "columns")
        widened: list[Optional[T.DataType]] = []
        for i, (a, b) in enumerate(zip(lf, rf)):
            ct = T.common_type(a.dtype, b.dtype)
            if ct is None:
                raise TypeError(f"union column {i + 1} ({a.name!r}) has "
                                f"incompatible types {a.dtype} and "
                                f"{b.dtype}")
            widened.append(None if a.dtype == b.dtype else ct)
        return DataFrame(L.Union([
            _coerce_union_member(self._plan, widened),
            _coerce_union_member(other._plan, widened)]), self._session)

    def order_by(self, *keys, desc: bool = False) -> "DataFrame":
        """Sort by ``keys`` (expressions or SortKeys); ``desc`` sorts
        descending with NULLs last, as Spark does."""
        sks = [k if isinstance(k, SortKey)
               else SortKey(_expr(k), descending=desc, nulls_last=desc)
               for k in keys]
        return DataFrame(L.Sort(sks, self._plan), self._session)

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(L.Limit(n, self._plan), self._session)

    def physical_plan(self) -> TpuExec:
        s = self._session
        return Planner(s.conf, s.device, s.shuffle_manager, s.semaphore,
                       s.upload_stream).plan(self._plan)

    def explain(self) -> str:
        """The physical plan, then a line for each runtime filter's build
        site and each scan that applies one."""
        plan = self.physical_plan()
        return "\n".join([plan.tree_string(),
                          *render_runtime_filters(plan)])

    def collect(self) -> pa.Table:
        """Run the query on the session's device; the result as Arrow.
        The stage and the exec tree are closed on every exit."""
        return collect_exec(self.physical_plan(), self._session.conf)
