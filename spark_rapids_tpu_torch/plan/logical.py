"""Logical plan nodes: Scan, Filter, Project, Aggregate, Join, Window,
Sort and Limit.

Counterpart of the matching nodes of ``spark_rapids_tpu/plan/logical.py``.
Nodes keep their expressions by column name; the planner binds them to
the physical child, after it has pruned the scan's columns.
"""

from __future__ import annotations

from typing import Optional, Sequence

import pyarrow.parquet as pq

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import schema_from_arrow
from spark_rapids_tpu_torch.execs.join import JOIN_TYPES, joined_schema
from spark_rapids_tpu_torch.execs.sort import SortKey
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


class Join(LogicalPlan):
    """An equi-join; ``condition`` is a residual predicate over the
    joined row (the planner refuses it, as it refuses cross and keyless
    joins)."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: str,
                 condition: Optional[Expression] = None):
        if join_type not in JOIN_TYPES:
            raise ValueError(f"unknown join type {join_type!r}")
        if len(left_keys) != len(right_keys):
            raise ValueError(f"{len(left_keys)} left keys against "
                             f"{len(right_keys)} right keys")
        self.children = [left, right]
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.condition = condition
        # resolve names now; the key types must compare
        for lk, rk in zip(self.left_keys, self.right_keys):
            lt = bind_references(lk, left.schema).dtype
            rt = bind_references(rk, right.schema).dtype
            if T.common_type(lt, rt) is None:
                raise TypeError(f"join keys {lk.name} ({lt}) and "
                                f"{rk.name} ({rt}) do not compare")
        self._schema = joined_schema(left.schema, right.schema, join_type)
        if condition is not None:
            bind_references(condition, T.Schema(
                list(left.schema.fields) + list(right.schema.fields)))

    @property
    def schema(self) -> T.Schema:
        return self._schema


class Window(LogicalPlan):
    """One (partition_by, order_by) group of window expressions, their
    columns appended to the child's (``DataFrame.select`` chains one
    node per group)."""

    def __init__(self, window_exprs, child: LogicalPlan):
        self.children = [child]
        self.window_exprs = list(window_exprs)  # of (expression, name)
        bound = [(we.bind(child.schema), name)
                 for we, name in self.window_exprs]
        self._schema = T.Schema(
            list(child.schema.fields)
            + [T.Field(name, we.dtype, we.nullable) for we, name in bound])

    @property
    def schema(self) -> T.Schema:
        return self._schema


class Sort(LogicalPlan):
    def __init__(self, keys: Sequence[SortKey], child: LogicalPlan):
        self.children = [child]
        self.keys = list(keys)
        for k in self.keys:
            bind_references(k.expr, child.schema)

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema


class Limit(LogicalPlan):
    def __init__(self, n: int, child: LogicalPlan):
        if n < 0:
            raise ValueError(f"limit of {n} rows")
        self.children = [child]
        self.n = n

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema
