"""The port's front door: a pyspark-shaped session and DataFrame.

Counterpart of ``spark_rapids_tpu/session.py`` for the slice:
``TorchSession.read_parquet`` and ``DataFrame.where / select /
group_by(...).agg / agg / collect``, with ``col``, ``lit``, ``sum_``,
``avg`` and ``count_star``.

A session runs on one device, ``cuda`` unless the caller asks for the
CPU.  Asking for CUDA on a host without it raises: nothing falls back
to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import pyarrow as pa
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import batches_to_arrow
from spark_rapids_tpu_torch.config import TorchConf
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.exprs.aggregates import (
    AggregateFunction,
    Average,
    CountStar,
    NamedAgg,
    Sum,
)
from spark_rapids_tpu_torch.exprs.base import Expression, _expr, col, lit
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.planner import Planner
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager

__all__ = ["TorchSession", "DataFrame", "col", "lit", "sum_", "avg",
           "count_star"]

AggLike = Union[NamedAgg, AggregateFunction, tuple]


def sum_(e) -> Sum:
    return Sum(_expr(e))


def avg(e) -> Average:
    return Average(_expr(e))


def count_star() -> CountStar:
    return CountStar()


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
        return DataFrame(L.Project([_expr(e) for e in exprs], self._plan),
                         self._session)

    def where(self, cond: Expression) -> "DataFrame":
        return DataFrame(L.Filter(cond, self._plan), self._session)

    filter = where

    def group_by(self, *keys) -> GroupedData:
        return GroupedData(self, [_expr(k) for k in keys])

    def agg(self, *aggs: AggLike) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def physical_plan(self) -> TpuExec:
        s = self._session
        return Planner(s.conf, s.device, s.shuffle_manager).plan(self._plan)

    def explain(self) -> str:
        return self.physical_plan().tree_string()

    def collect(self) -> pa.Table:
        """Run the query on the session's device; the result as Arrow."""
        exec_ = self.physical_plan()
        try:
            batches = list(exec_.execute())
        finally:
            for node in exec_.walk():
                if hasattr(node, "close"):
                    node.close()
        return batches_to_arrow(batches, exec_.schema)
