"""The port's front door: a pyspark-shaped session and DataFrame.

Counterpart of ``spark_rapids_tpu/session.py`` for the slices ported so
far: ``TorchSession.read_parquet`` and ``DataFrame.where / select /
group_by(...).agg / agg / join / order_by / limit / collect``, with
``col``, ``lit``, ``sum_``, ``avg``, ``count``, ``count_star``, ``min_``
and ``max_``.  ``select`` takes window expressions (``rank()``,
``row_number()``, ``dense_rank()``, ``lead``, ``lag`` or an aggregate,
``.over(Window.partition_by(...).order_by(...))``) anywhere in its
list: they are extracted into ``Window`` plan nodes under the
projection, one per (partition_by, order_by) group.

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

from typing import Optional, Sequence, Union

import pyarrow as pa
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import batches_to_arrow
from spark_rapids_tpu_torch.config import TorchConf
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.execs.sort import SortKey
from spark_rapids_tpu_torch.exprs.aggregates import (
    AggregateFunction,
    Average,
    Count,
    CountStar,
    Max,
    Min,
    NamedAgg,
    Sum,
)
from spark_rapids_tpu_torch.exprs.base import (
    ColumnReference,
    Expression,
    _column,
    _expr,
    col,
    lit,
)
from spark_rapids_tpu_torch.exprs.window import WindowExpression
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.parallel.pipeline import prefetch, stage_depth
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.planner import Planner
from spark_rapids_tpu_torch.plan.runtime_filter import render_runtime_filters
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager

__all__ = ["TorchSession", "DataFrame", "col", "lit", "sum_", "avg",
           "count", "count_star", "min_", "max_"]

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


class GroupedData:
    def __init__(self, df: "DataFrame", keys: list[Expression]):
        self._df = df
        self._keys = keys

    def agg(self, *aggs: AggLike) -> "DataFrame":
        named = []
        for i, a in enumerate(aggs):
            if isinstance(a, NamedAgg):
                named.append(a)
            elif isinstance(a, tuple):
                named.append(NamedAgg(*a))
            else:
                named.append(NamedAgg(a, f"{a.name}_{i}"))
        return DataFrame(L.Aggregate(self._keys, named, self._df._plan),
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

    def group_by(self, *keys) -> GroupedData:
        return GroupedData(self, [_expr(k) for k in keys])

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
        exec_ = self.physical_plan()
        fetch = prefetch(exec_.execute(), stage_depth(self._session.conf),
                         "result.fetch")
        try:
            return batches_to_arrow(fetch, exec_.schema)
        finally:
            fetch.close()
            for node in exec_.walk():
                if hasattr(node, "close"):
                    node.close()
