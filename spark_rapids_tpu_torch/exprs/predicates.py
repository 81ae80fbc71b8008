"""Predicates with Spark SQL three-valued logic.

Counterpart of ``spark_rapids_tpu/exprs/predicates.py``: comparisons
propagate NULL, And/Or are Kleene (false AND NULL = false, true OR NULL
= true), and floating-point comparisons use Spark's total order (NaN =
NaN, NaN greater than every other value).  String comparison is not in
this slice and raises.
"""

from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import (
    AnyColumn,
    Column,
    StringColumn,
)
from spark_rapids_tpu_torch.exprs.base import (
    EvalContext,
    Expression,
    broadcast_validity,
)


def _ordered_cmp(ld: torch.Tensor, rd: torch.Tensor):
    """(lt, eq) under Spark's total order."""
    if ld.is_floating_point():
        lnan, rnan = torch.isnan(ld), torch.isnan(rd)
        return (ld < rd) | (~lnan & rnan), (ld == rd) | (lnan & rnan)
    return ld < rd, ld == rd


@dataclasses.dataclass(repr=False)
class BinaryComparison(Expression):
    left: Expression
    right: Expression

    @property
    def dtype(self) -> T.DataType:
        return T.BOOLEAN

    def eval(self, ctx: EvalContext) -> AnyColumn:
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        if isinstance(lc, StringColumn) or isinstance(rc, StringColumn):
            raise NotImplementedError(
                "string comparison is not ported yet")
        ct = T.common_type(self.left.dtype, self.right.dtype) \
            or self.left.dtype
        phys = T.to_torch_dtype(ct)
        lt, eq = _ordered_cmp(lc.data.to(phys), rc.data.to(phys))
        return Column(self.compare_ordered(lt, eq),
                      broadcast_validity(lc, rc), T.BOOLEAN)

    def compare_ordered(self, lt, eq):
        raise NotImplementedError


class EqualTo(BinaryComparison):
    def compare_ordered(self, lt, eq):
        return eq


class LessThan(BinaryComparison):
    def compare_ordered(self, lt, eq):
        return lt


class LessThanOrEqual(BinaryComparison):
    def compare_ordered(self, lt, eq):
        return lt | eq


class GreaterThan(BinaryComparison):
    def compare_ordered(self, lt, eq):
        return ~(lt | eq)


class GreaterThanOrEqual(BinaryComparison):
    def compare_ordered(self, lt, eq):
        return ~lt


@dataclasses.dataclass(repr=False)
class And(Expression):
    left: Expression
    right: Expression

    @property
    def dtype(self) -> T.DataType:
        return T.BOOLEAN

    def eval(self, ctx: EvalContext) -> AnyColumn:
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        lval, rval = lc.data.bool(), rc.data.bool()
        false_wins = (lc.validity & ~lval) | (rc.validity & ~rval)
        valid = (lc.validity & rc.validity) | false_wins
        return Column(lval & rval & lc.validity & rc.validity, valid,
                      T.BOOLEAN)


@dataclasses.dataclass(repr=False)
class Or(Expression):
    left: Expression
    right: Expression

    @property
    def dtype(self) -> T.DataType:
        return T.BOOLEAN

    def eval(self, ctx: EvalContext) -> AnyColumn:
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        lval = lc.data.bool() & lc.validity
        rval = rc.data.bool() & rc.validity
        true_wins = lval | rval
        return Column(true_wins, (lc.validity & rc.validity) | true_wins,
                      T.BOOLEAN)


@dataclasses.dataclass(repr=False)
class Not(Expression):
    child: Expression

    @property
    def dtype(self) -> T.DataType:
        return T.BOOLEAN

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = self.child.eval(ctx)
        return Column(~c.data.bool(), c.validity, T.BOOLEAN)


@dataclasses.dataclass(repr=False)
class Coalesce(Expression):
    """coalesce(a, b): the first non-NULL of two same-typed columns (the
    finalize step of COUNT over an empty grand aggregate)."""

    first: Expression
    second: Expression

    @property
    def dtype(self) -> T.DataType:
        return T.common_type(self.first.dtype, self.second.dtype) \
            or self.first.dtype

    @property
    def nullable(self) -> bool:
        return self.first.nullable and self.second.nullable

    def eval(self, ctx: EvalContext) -> AnyColumn:
        a = self.first.eval(ctx)
        b = self.second.eval(ctx)
        phys = T.to_torch_dtype(self.dtype)
        data = torch.where(a.validity, a.data.to(phys), b.data.to(phys))
        return Column(data, a.validity | b.validity, self.dtype)
