"""Logical plan nodes: Scan, Filter, Project, Aggregate.

Counterpart of the matching nodes of ``spark_rapids_tpu/plan/logical.py``.
Nodes keep their expressions by column name; the planner binds them to
the physical child, after it has pruned the scan's columns.
"""

from __future__ import annotations

from typing import Sequence

import pyarrow.parquet as pq

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import schema_from_arrow
from spark_rapids_tpu_torch.exprs.aggregates import NamedAgg
from spark_rapids_tpu_torch.exprs.base import (
    Expression,
    bind_references,
    output_field,
)


class LogicalPlan:
    children: list["LogicalPlan"]

    @property
    def schema(self) -> T.Schema:
        raise NotImplementedError


class Scan(LogicalPlan):
    """Parquet files of one schema (the first file's)."""

    def __init__(self, paths: Sequence[str]):
        if not paths:
            raise ValueError("read_parquet needs at least one path")
        self.children = []
        self.paths = list(paths)
        self._schema = schema_from_arrow(pq.read_schema(self.paths[0]))

    @property
    def schema(self) -> T.Schema:
        return self._schema


class Filter(LogicalPlan):
    def __init__(self, condition: Expression, child: LogicalPlan):
        self.children = [child]
        self.condition = condition
        bind_references(condition, child.schema)  # resolve names now

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema


class Project(LogicalPlan):
    def __init__(self, exprs: Sequence[Expression], child: LogicalPlan):
        self.children = [child]
        self.exprs = list(exprs)
        bound = [bind_references(e, child.schema) for e in self.exprs]
        self._schema = T.Schema([output_field(e, i)
                                 for i, e in enumerate(bound)])

    @property
    def schema(self) -> T.Schema:
        return self._schema


class Aggregate(LogicalPlan):
    def __init__(self, groups: Sequence[Expression],
                 aggs: Sequence[NamedAgg], child: LogicalPlan):
        self.children = [child]
        self.groups = list(groups)
        self.aggs = list(aggs)
        cs = child.schema
        keys = [output_field(bind_references(g, cs), i)
                for i, g in enumerate(self.groups)]
        outs = [NamedAgg(na.fn.bind(cs), na.out_name).output_field()
                for na in self.aggs]
        self._schema = T.Schema(keys + outs)

    @property
    def schema(self) -> T.Schema:
        return self._schema
