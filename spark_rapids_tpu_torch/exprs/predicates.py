"""Predicates, null handling and conditionals with Spark SQL
three-valued logic.

Counterpart of ``spark_rapids_tpu/exprs/predicates.py``, all of it:
comparisons propagate NULL, And/Or are Kleene (false AND NULL = false,
true OR NULL = true), EqualNullSafe / IsNull / IsNotNull / IsNaN /
AtLeastNNonNulls never return NULL, and floating-point comparisons use
Spark's total order (NaN = NaN, NaN greater than every other value).

Strings compare by their unsigned bytes, then by length, as Spark does:
the zero padding of the ``(N, W)`` byte matrix makes "a" and "a\\0"
byte-equal, and the length puts "a" first.

``In`` follows Spark where the JAX package does not: NaN IN (NaN) is
true there (Spark compares doubles in its total order), while the JAX
``In`` compares with ``==``.
"""

from __future__ import annotations

import dataclasses
import decimal
from typing import Sequence

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
    Literal,
    broadcast_validity,
    physical_value,
)
from spark_rapids_tpu_torch.exprs.cast import cast_column


def _widen(dtypes: Sequence[T.DataType]) -> T.DataType:
    """The common type of branch or argument types (NULL takes the
    other's type); TypeError when there is none."""
    out = dtypes[0]
    for dt in dtypes[1:]:
        ct = T.common_type(out, dt)
        if ct is None:
            raise TypeError(f"incompatible types {out} / {dt}")
        out = ct
    return out


def _result_type(dtypes: Sequence[T.DataType]) -> T.DataType:
    """STRING when any branch is a string (the others strings or NULL),
    else the widened type."""
    if any(isinstance(dt, T.StringType) for dt in dtypes):
        other = [dt for dt in dtypes
                 if not isinstance(dt, (T.StringType, T.NullType))]
        if other:
            raise TypeError(f"incompatible types string / {other[0]}")
        return T.STRING
    return _widen(dtypes)


def _as_type(c: AnyColumn, dtype: T.DataType) -> AnyColumn:
    """``c`` in ``dtype``: converted as a cast converts it (a DECIMAL
    rescaled or made a double, a DATE made a TIMESTAMP at midnight), or
    a NULL-typed column (a NULL literal) as empty, NULL strings."""
    if isinstance(dtype, T.StringType):
        if isinstance(c, StringColumn):
            return c
        if not isinstance(c.dtype, T.NullType):
            raise TypeError(f"{c.dtype} does not compare with string")
        n = len(c)
        return StringColumn(
            torch.zeros((n, 1), dtype=torch.uint8, device=c.validity.device),
            torch.zeros(n, dtype=torch.int32, device=c.validity.device),
            c.validity)
    if c.dtype == dtype:
        return c
    if isinstance(c.dtype, T.NullType):
        return Column(c.data.to(T.to_torch_dtype(dtype)), c.validity, dtype)
    return cast_column(c, c.dtype, dtype)


def _string_cmp(lc: StringColumn, rc: StringColumn):
    """(lt, eq) of two string columns: the first differing byte decides,
    compared unsigned (a widened difference, so no uint8 wrap); strings
    whose bytes agree on the common padded width order by length."""
    w = max(lc.width, rc.width)
    diff = (lc.with_width(w).chars.to(torch.int16)
            - rc.with_width(w).chars.to(torch.int16))
    nz = diff != 0
    any_nz = nz.any(dim=1)
    first = nz.to(torch.uint8).argmax(dim=1, keepdim=True)
    first_diff = diff.gather(1, first).squeeze(1)
    same_bytes = ~any_nz
    lt = (any_nz & (first_diff < 0)) | (same_bytes
                                        & (lc.lengths < rc.lengths))
    return lt, same_bytes & (lc.lengths == rc.lengths)


def decimal_integral_cmp(dec: torch.Tensor, scale: int, ints: torch.Tensor):
    """(lt, eq) of DECIMAL unscaled values at ``scale`` against integers
    of a type with no common decimal type (a LONG beside a scale, a
    DECIMAL(p, s) with p - s + 10 > 18 beside an INT), exactly: the
    integer scaled by 10^scale, and an integer too large for that
    compared by its sign (no DECIMAL of 18 digits reaches it)."""
    f = 10 ** scale
    lim = (2 ** 63 - 1) // f
    ints = ints.long()
    big = (ints > lim) | (ints < -lim)
    scaled = torch.where(big, torch.zeros_like(ints), ints) * f
    return torch.where(big, ints > 0, dec < scaled), ~big & (dec == scaled)


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

    def _cmp_columns(self, lc: AnyColumn, rc: AnyColumn):
        if isinstance(lc, StringColumn) or isinstance(rc, StringColumn):
            return _string_cmp(_as_type(lc, T.STRING),
                               _as_type(rc, T.STRING))
        ltype, rtype = self.left.dtype, self.right.dtype
        if T.decimal_beside_integral(ltype, rtype):
            if isinstance(ltype, T.DecimalType):
                return decimal_integral_cmp(lc.data, ltype.scale, rc.data)
            lt, eq = decimal_integral_cmp(rc.data, rtype.scale, lc.data)
            return ~(lt | eq), eq
        ct = T.common_type(ltype, rtype)
        if ct is None:  # a DATE against an integer: its day number
            phys = T.to_torch_dtype(self.left.dtype)
            return _ordered_cmp(lc.data.to(phys), rc.data.to(phys))
        return _ordered_cmp(_as_type(lc, ct).data, _as_type(rc, ct).data)

    def eval(self, ctx: EvalContext) -> AnyColumn:
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        lt, eq = self._cmp_columns(lc, rc)
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


class EqualNullSafe(BinaryComparison):
    """<=>: never NULL; NULL <=> NULL is true, NULL <=> x false."""

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: EvalContext) -> AnyColumn:
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        _, eq = self._cmp_columns(lc, rc)
        lv, rv = lc.validity, rc.validity
        data = (~lv & ~rv) | (lv & rv & eq)
        return Column(data, torch.ones_like(data), T.BOOLEAN)


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
class _NeverNull(Expression):
    """A BOOLEAN test of one child that is never NULL."""

    child: Expression

    @property
    def dtype(self) -> T.DataType:
        return T.BOOLEAN

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: EvalContext) -> AnyColumn:
        data = self.test(self.child.eval(ctx))
        return Column(data, torch.ones_like(data), T.BOOLEAN)

    def test(self, c: AnyColumn) -> torch.Tensor:
        raise NotImplementedError


class IsNull(_NeverNull):
    def test(self, c):
        return ~c.validity


class IsNotNull(_NeverNull):
    def test(self, c):
        return c.validity.clone()


class IsNaN(_NeverNull):
    """Spark IsNaN: a NULL input gives false."""

    def test(self, c):
        return torch.isnan(c.data) & c.validity


@dataclasses.dataclass(repr=False)
class In(Expression):
    """value IN (literals...): NULL when the value is NULL, or when
    nothing matches and the list holds a NULL.  Values compare in the
    common type of the value and each literal, NaN equal to NaN; a DATE
    value compares day numbers, as the JAX ``In`` does."""

    child: Expression
    values: tuple

    @property
    def dtype(self) -> T.DataType:
        return T.BOOLEAN

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = self.child.eval(ctx)
        has_null = any(v is None for v in self.values)
        match = torch.zeros(len(c), dtype=torch.bool,
                            device=c.validity.device)
        for v in self.values:
            if v is None:
                continue
            if isinstance(c, StringColumn):
                _, eq = _string_cmp(c, Literal.of(v).eval(ctx))
            elif isinstance(self.child.dtype, (T.DateType, T.TimestampType)):
                # a DATE compares as its day number, a TIMESTAMP as its
                # microseconds, the literal too
                eq = c.data == physical_value(v, self.child.dtype)
            elif isinstance(self.child.dtype, T.DecimalType) \
                    and not isinstance(v, float):
                # exact: a value with more digits than the scale matches
                # no row
                d = decimal.Decimal(v).scaleb(self.child.dtype.scale)
                eq = c.data == int(d) if d == d.to_integral_value() \
                    and abs(d) < 2 ** 63 else torch.zeros_like(match)
            elif isinstance(self.child.dtype, T.IntegralType) \
                    and isinstance(v, decimal.Decimal):
                # exact: a value with a fraction matches no integer
                eq = c.data == int(v) if v == v.to_integral_value() \
                    and abs(v) < 2 ** 63 else torch.zeros_like(match)
            else:
                lit = Literal.of(v)
                ct = T.common_type(self.child.dtype, lit.dtype)
                if ct is None:
                    raise TypeError(f"{v!r} does not compare with "
                                    f"{self.child.dtype}")
                d = _as_type(c, ct).data
                eq = d == v
                if d.is_floating_point() and v != v:
                    eq = torch.isnan(d)
            match = match | eq
        valid = c.validity & (match | (not has_null))
        return Column(match & c.validity, valid, T.BOOLEAN)


def _choose(take_a: torch.Tensor, a: AnyColumn, b: AnyColumn,
            dtype: T.DataType) -> AnyColumn:
    """Row-wise ``a`` where ``take_a``, else ``b``, in ``dtype``."""
    a, b = _as_type(a, dtype), _as_type(b, dtype)
    validity = torch.where(take_a, a.validity, b.validity)
    if isinstance(a, StringColumn):
        w = max(a.width, b.width)
        return StringColumn(
            torch.where(take_a[:, None], a.with_width(w).chars,
                        b.with_width(w).chars),
            torch.where(take_a, a.lengths, b.lengths), validity)
    return Column(torch.where(take_a, a.data, b.data), validity, dtype)


@dataclasses.dataclass(repr=False)
class Coalesce(Expression):
    """coalesce(e1, e2, ...): each row's first non-NULL argument."""

    exprs: tuple[Expression, ...]

    def __init__(self, *exprs: Expression):
        self.exprs = tuple(exprs)

    @property
    def children(self) -> tuple[Expression, ...]:
        return self.exprs

    def with_children(self, children):
        return Coalesce(*children)

    @property
    def dtype(self) -> T.DataType:
        return _result_type([e.dtype for e in self.exprs])

    @property
    def nullable(self) -> bool:
        return all(e.nullable for e in self.exprs)

    def eval(self, ctx: EvalContext) -> AnyColumn:
        cols = [e.eval(ctx) for e in self.exprs]
        out = cols[-1]
        for c in reversed(cols[:-1]):
            out = _choose(c.validity, c, out, self.dtype)
        return _as_type(out, self.dtype)


@dataclasses.dataclass(repr=False)
class If(Expression):
    """if(pred, then, otherwise): ``then`` where the predicate is true,
    else ``otherwise`` (a NULL predicate takes ``otherwise``); the
    branches widen to a common type."""

    pred: Expression
    then: Expression
    otherwise: Expression

    @property
    def dtype(self) -> T.DataType:
        return _result_type([self.then.dtype, self.otherwise.dtype])

    def eval(self, ctx: EvalContext) -> AnyColumn:
        p = self.pred.eval(ctx)
        return _choose(p.data.bool() & p.validity, self.then.eval(ctx),
                       self.otherwise.eval(ctx), self.dtype)


@dataclasses.dataclass(repr=False)
class CaseWhen(Expression):
    """CASE WHEN c1 THEN v1 ... ELSE e END: the first branch whose
    condition is true (NULL is not) gives the value."""

    branches: tuple[tuple[Expression, Expression], ...]
    else_value: Expression

    @property
    def children(self) -> tuple[Expression, ...]:
        kids: list[Expression] = []
        for c, v in self.branches:
            kids += [c, v]
        return (*kids, self.else_value)

    def with_children(self, children):
        n = len(self.branches)
        return CaseWhen(tuple((children[2 * i], children[2 * i + 1])
                              for i in range(n)), children[2 * n])

    @property
    def dtype(self) -> T.DataType:
        return _result_type([v.dtype for _, v in self.branches]
                            + [self.else_value.dtype])

    def eval(self, ctx: EvalContext) -> AnyColumn:
        dtype = self.dtype
        out = self.else_value.eval(ctx)
        for cond, val in reversed(self.branches):
            p = cond.eval(ctx)
            out = _choose(p.data.bool() & p.validity, val.eval(ctx), out,
                          dtype)
        return _as_type(out, dtype)


@dataclasses.dataclass(repr=False)
class AtLeastNNonNulls(Expression):
    """True where at least ``n`` arguments are neither NULL nor NaN."""

    n: int
    exprs: tuple[Expression, ...]

    def __init__(self, n: int, exprs: Sequence[Expression]):
        self.n = n
        self.exprs = tuple(exprs)

    @property
    def children(self) -> tuple[Expression, ...]:
        return self.exprs

    def with_children(self, children):
        return AtLeastNNonNulls(self.n, children)

    @property
    def dtype(self) -> T.DataType:
        return T.BOOLEAN

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: EvalContext) -> AnyColumn:
        count = torch.zeros(ctx.batch.num_rows, dtype=torch.int32,
                            device=ctx.batch.device)
        for e in self.exprs:
            c = e.eval(ctx)
            v = c.validity
            if isinstance(c, Column) and c.data.is_floating_point():
                v = v & ~torch.isnan(c.data)
            count = count + v.to(torch.int32)
        data = count >= self.n
        return Column(data, torch.ones_like(data), T.BOOLEAN)
