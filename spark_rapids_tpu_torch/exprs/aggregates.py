"""Declarative aggregate functions.

Counterpart of ``spark_rapids_tpu/exprs/aggregates.py``: each SQL
aggregate decomposes into *update* ops (per input batch), *merge* ops
(over partial results, e.g. after a shuffle) and a *finalize*
expression over the partial columns.  Sum, Count, CountStar, Average,
Min, Max, First and Last group-aggregate: the ops they name run in
``ops/groupby.py``; Sum, Count, CountStar, Average, Min and Max also
serve window frames (``exprs/window.py``).  ``CountDistinct`` is a
marker the session rewrites into a two-level aggregate
(``session.py::GroupedData._agg_distinct``); it never runs itself.
``CollectList`` and ``CollectSet`` run in their own exec
(``execs/collect_agg.py``), never beside other aggregates on the
device.  ``PivotFirst`` and ``GroupedData.pivot`` expand into one masked
aggregate per pivot value (``expand_pivot_aggs``) before planning.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import Expression, Literal
from spark_rapids_tpu_torch.ops.groupby import AggSpec, agg_output_dtype


@dataclasses.dataclass(repr=False)
class AggregateFunction:
    child: Optional[Expression]

    @property
    def name(self) -> str:
        return type(self).__name__.lower()

    def bind(self, schema: T.Schema) -> "AggregateFunction":
        if self.child is None:
            return self
        from spark_rapids_tpu_torch.exprs.base import bind_references

        return type(self)(bind_references(self.child, schema))

    def inputs(self) -> list[Expression]:
        return [self.child] if self.child is not None else []

    def update_ops(self) -> list[str]:
        raise NotImplementedError

    def merge_ops(self) -> list[str]:
        raise NotImplementedError

    def partial_dtypes(self) -> list[T.DataType]:
        in_dt = self.child.dtype if self.child is not None else None
        return [agg_output_dtype(AggSpec(op, 0), in_dt)
                for op in self.update_ops()]

    def finalize_expr(self, partial_refs: list[Expression]) -> Expression:
        return partial_refs[0]

    @property
    def dtype(self) -> T.DataType:
        return self.partial_dtypes()[0]

    @property
    def nullable(self) -> bool:
        return True

    def over(self, spec):
        """This aggregate over a window: ``sum_(col("v")).over(w)``."""
        from spark_rapids_tpu_torch.exprs.window import WindowAgg

        return WindowAgg(self).over(spec)


class Sum(AggregateFunction):
    def update_ops(self):
        return ["sum"]

    def merge_ops(self):
        return ["sum"]


class Count(AggregateFunction):
    """count(expr): the non-NULL rows."""

    def update_ops(self):
        return ["count"]

    def merge_ops(self):
        return ["sum"]

    @property
    def nullable(self) -> bool:
        return False

    def finalize_expr(self, partial_refs):
        from spark_rapids_tpu_torch.exprs.predicates import Coalesce

        return Coalesce(partial_refs[0], Literal.of(0))


class _Extremum(AggregateFunction):
    op = ""

    def update_ops(self):
        return [self.op]

    def merge_ops(self):
        return [self.op]

    def partial_dtypes(self):
        return [self.child.dtype]


class Min(_Extremum):
    op = "min"


class Max(_Extremum):
    op = "max"


@dataclasses.dataclass(repr=False)
class First(_Extremum):
    """first(expr[, ignoreNulls]): the group's first row in input order
    (ignoreNulls = false, Spark's default: that row's value, NULL or
    not) or its first non-NULL value.  Deterministic only after an
    ORDER BY, as in Spark; the port keeps map-task order through the
    exchange, so a pooled run picks what a serial one does."""

    ignore_nulls: bool = False

    def bind(self, schema: T.Schema) -> "First":
        from spark_rapids_tpu_torch.exprs.base import bind_references

        return type(self)(bind_references(self.child, schema),
                          self.ignore_nulls)

    @property
    def op(self) -> str:
        base = type(self).__name__.lower()
        return base if self.ignore_nulls else f"{base}_any"


class Last(First):
    """last(expr[, ignoreNulls]): as ``First``, from the group's end."""


class CountDistinct(AggregateFunction):
    """count(DISTINCT expr): rewritten by the session before planning."""

    @property
    def name(self) -> str:
        return "count_distinct"

    def update_ops(self):
        raise NotImplementedError(
            "count_distinct runs as the session's two-level aggregate")


class CountStar(AggregateFunction):
    def __init__(self):
        super().__init__(None)

    def update_ops(self):
        return ["count_star"]

    def merge_ops(self):
        return ["sum"]

    def partial_dtypes(self):
        return [T.LONG]

    @property
    def nullable(self) -> bool:
        return False

    def finalize_expr(self, partial_refs):
        from spark_rapids_tpu_torch.exprs.predicates import Coalesce

        # the merge SUMs counts: NULL only for an empty grand aggregate,
        # where SQL count(*) must be 0
        return Coalesce(partial_refs[0], Literal.of(0))


class Average(AggregateFunction):
    """avg = sum / count: partials [sum, count], merge [sum, sum],
    finalize sum / count (NULL when the count is 0)."""

    def update_ops(self):
        return ["sum", "count"]

    def merge_ops(self):
        return ["sum", "sum"]

    def partial_dtypes(self):
        return [T.DOUBLE, T.LONG]

    @property
    def dtype(self) -> T.DataType:
        return T.DOUBLE

    def finalize_expr(self, partial_refs):
        from spark_rapids_tpu_torch.exprs.arithmetic import Divide

        return Divide(partial_refs[0], partial_refs[1])


class CollectList(AggregateFunction):
    """collect_list(expr): a group's non-NULL values as an array, never
    NULL (an all-NULL group gives an empty array).  On the device the
    elements come in ascending order (``ops/collect.py``); Spark leaves
    the order unspecified."""

    collect_kind = "list"

    @property
    def dtype(self) -> T.DataType:
        cdt = self.child.dtype
        if isinstance(cdt, T.ListType):
            # no array of arrays in this engine: a construction error,
            # not a fallback (the reference supports array<array<T>>)
            raise TypeError(
                f"{self.name} over an array column is not supported "
                "by this engine (no nested array type)")
        return T.ListType(cdt)

    @property
    def nullable(self) -> bool:
        return False

    def check_supported(self) -> None:
        dt = self.child.dtype
        if isinstance(dt, (T.StringType, T.DecimalType)):
            raise TypeError(
                f"{self.name} over {dt.name} input runs on the CPU "
                "engine (device lists hold fixed-width elements only)")


class CollectSet(CollectList):
    """collect_set(expr): a group's distinct non-NULL values (NaN equals
    NaN, -0.0 equals 0.0)."""

    collect_kind = "set"


@dataclasses.dataclass(repr=False)
class PivotFirst(AggregateFunction):
    """pivot_first(pivot, value, [v1, v2, ...]): the first value of
    ``child`` per group and pivot value; expanded before planning into
    one first(if(pivot = v, child, NULL), ignoreNulls) per value."""

    pivot: Optional[Expression] = None
    pivot_values: tuple = ()

    @property
    def name(self) -> str:
        return (f"pivot_first({self.pivot.name}, {self.child.name}, "
                f"{list(self.pivot_values)})")

    def expand(self, out_name: str) -> list["NamedAgg"]:
        return expand_pivot_aggs(
            self.pivot, self.pivot_values,
            [NamedAgg(First(self.child, ignore_nulls=True), out_name)],
            single=out_name == "__pivot")


def expand_pivot_aggs(pcol: Expression, values, named: list["NamedAgg"],
                      single: bool) -> list["NamedAgg"]:
    """F(v) as F(if(p <=> value, v, NULL)) per pivot value, in value
    order: a None value matches NULL pivot keys; First / Last turn to
    ignoring NULLs, so a masked-out row never wins the slot (Spark's
    pivot considers the matching rows only).  Named ``str(value)`` when
    ``single``, else ``{value}_{name}``."""
    from spark_rapids_tpu_torch.exprs.predicates import EqualTo, If, IsNull

    out = []
    for v in values:
        for na in named:
            ins = na.fn.inputs()
            if len(ins) != 1:
                raise ValueError(f"pivot over {na.fn.name} is not supported")
            child = ins[0]
            try:
                null_dt = child.dtype  # a bound child knows its type
            except RuntimeError:
                null_dt = None  # unbound: the NULL literal widens in If
            cond = IsNull(pcol) if v is None \
                else EqualTo(pcol, Literal.of(v))
            fn = dataclasses.replace(
                na.fn, child=If(cond, child, Literal.of(None, null_dt)))
            if isinstance(fn, First) and not fn.ignore_nulls:
                fn = dataclasses.replace(fn, ignore_nulls=True)
            out.append(NamedAgg(fn, str(v) if single
                                else f"{v}_{na.out_name}"))
    return out


@dataclasses.dataclass
class NamedAgg:
    """An aggregate function with its output column name."""

    fn: AggregateFunction
    out_name: str

    def output_field(self) -> T.Field:
        return T.Field(self.out_name, self.fn.dtype, self.fn.nullable)
