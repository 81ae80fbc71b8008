"""Logical plan nodes: Scan, InMemoryRelation, RangeRel, Filter,
Project, Aggregate, Expand, Join, Window, Sort, Limit and Union.

Counterpart of the matching nodes of ``spark_rapids_tpu/plan/logical.py``.
Nodes keep their expressions by column name; the planner binds them to
the physical child, after it has pruned the scan's columns.

Every node estimates an upper bound on its rows and bytes, as there,
for the planner's broadcast choice: a scan counts its files' footer
rows, an in-memory table its rows, a range its values, a node with one
child passes the child's bound on (a filter can only shrink), a grand
aggregate makes one row, a LIMIT at most its n, a join at most the sum
of its sides (the JAX estimate), an Expand its child's rows times its
projections and a Union the sum of its members.  Bytes are rows times
``row_width_bytes`` of the node's schema.
"""

from __future__ import annotations

from typing import Optional, Sequence

import pyarrow as pa
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

    def estimated_rows(self) -> Optional[int]:
        """An upper bound on the node's rows; None when unknown."""
        if len(self.children) == 1:
            return self.children[0].estimated_rows()
        return None

    def estimated_bytes(self) -> Optional[int]:
        n = self.estimated_rows()
        return None if n is None else n * row_width_bytes(self.schema)


def row_width_bytes(schema: T.Schema) -> int:
    """Bytes per row: each fixed-width value's size, 32 chars and a
    4-byte length for a string, and a validity byte per column."""
    total = 0
    for f in schema.fields:
        if isinstance(f.dtype, T.StringType):
            total += 32 + 4
        else:
            total += T.to_torch_dtype(f.dtype).itemsize
        total += 1
    return max(total, 1)


class Scan(LogicalPlan):
    """Parquet files of one schema (the first file's)."""

    def __init__(self, paths: Sequence[str]):
        if not paths:
            raise ValueError("read_parquet needs at least one path")
        self.children = []
        self.paths = list(paths)
        self._schema = schema_from_arrow(pq.read_schema(self.paths[0]))
        self._est_rows: Optional[int] = None

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def estimated_rows(self) -> Optional[int]:
        """The files' footer row counts, read once, on demand."""
        if self._est_rows is None:
            try:
                self._est_rows = sum(pq.read_metadata(p).num_rows
                                     for p in self.paths)
            except OSError:
                return None
        return self._est_rows


class InMemoryRelation(LogicalPlan):
    """A host Arrow table (``TorchSession.create_dataframe``)."""

    def __init__(self, table: pa.Table):
        self.children = []
        self.table = table
        self._schema = schema_from_arrow(table.schema)

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def estimated_rows(self) -> Optional[int]:
        return self.table.num_rows


class RangeRel(LogicalPlan):
    """``id`` from ``start`` (inclusive) to ``end`` (exclusive) by
    ``step`` (``TorchSession.range``)."""

    def __init__(self, start: int, end: int, step: int = 1):
        if step == 0:
            raise ValueError("range step must not be 0")
        self.children = []
        self.start, self.end, self.step = start, end, step
        self._schema = T.Schema([T.Field("id", T.LONG, False)])

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def estimated_rows(self) -> Optional[int]:
        return max(0, -(-(self.end - self.start) // self.step))


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

    def estimated_rows(self) -> Optional[int]:
        if not self.groups:
            return 1  # a grand aggregate makes one row
        return self.children[0].estimated_rows()


class Expand(LogicalPlan):
    """Each input row once per projection list (rollup, cube and
    grouping sets build on it).  A column's type is that of its first
    projection whose expression is not of the NULL type."""

    def __init__(self, projections: Sequence[Sequence[Expression]],
                 names: Sequence[str], child: LogicalPlan):
        if not projections or any(len(p) != len(names)
                                  for p in projections):
            raise ValueError("every Expand projection needs one "
                             "expression per name")
        self.children = [child]
        self.projections = [list(p) for p in projections]
        self.names = list(names)
        bound = [[bind_references(e, child.schema) for e in p]
                 for p in self.projections]
        fields = []
        for i, name in enumerate(self.names):
            dt = next((p[i].dtype for p in bound
                       if not isinstance(p[i].dtype, T.NullType)), T.NULL)
            fields.append(T.Field(name, dt, True))
        self._schema = T.Schema(fields)

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def estimated_rows(self) -> Optional[int]:
        n = self.children[0].estimated_rows()
        return None if n is None else n * len(self.projections)


class Join(LogicalPlan):
    """An equi-join; ``condition`` is a residual predicate over the
    joined row (left ++ right columns).  A cross join, or an inner join
    with no keys, pairs every row with every row."""

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

    def estimated_rows(self) -> Optional[int]:
        sides = [c.estimated_rows() for c in self.children]
        return None if None in sides else sum(sides)


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

    def estimated_rows(self) -> Optional[int]:
        c = self.children[0].estimated_rows()
        return self.n if c is None else min(self.n, c)


class Union(LogicalPlan):
    """UNION ALL of members with the same column types, by position
    (``DataFrame.union`` widens them first); the output names are the
    first member's."""

    def __init__(self, children: Sequence[LogicalPlan]):
        if not children:
            raise ValueError("a union needs at least one member")
        self.children = list(children)
        first = self.children[0].schema
        for c in self.children[1:]:
            if [f.dtype for f in c.schema.fields] != [
                    f.dtype for f in first.fields]:
                raise TypeError(f"union members {first} and {c.schema} "
                                "differ; DataFrame.union widens them")
        self._schema = T.Schema([
            T.Field(f.name, f.dtype, any(c.schema.fields[i].nullable
                                         for c in self.children))
            for i, f in enumerate(first.fields)])

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def estimated_rows(self) -> Optional[int]:
        rows = [c.estimated_rows() for c in self.children]
        return None if None in rows else sum(rows)
