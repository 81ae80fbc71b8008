"""Arithmetic with Spark SQL semantics.

Counterpart of ``spark_rapids_tpu/exprs/arithmetic.py`` without its
decimal branches (the port has no DECIMAL type yet) and its ANSI error
polling:

- Add / Subtract / Multiply over the numeric common type, NULL in,
  NULL out; integers wrap, as in Spark's non-ANSI mode;
- Divide, always DOUBLE; IntegralDivide (``div``), always LONG,
  truncated toward zero; Remainder (``%``) and Pmod with Java's signs.
  A zero divisor gives NULL in all four;
- UnaryMinus, UnaryPositive and Abs (the integers' MIN_VALUE wraps to
  itself, as Java's negation and ``Math.abs`` do);
- Least / Greatest over any number of arguments, skipping NULLs, NaN
  the greatest double.

Java's integer ``/`` and ``%`` truncate toward zero and give the
remainder the dividend's sign.  ``torch.remainder`` (and Python's
``%``) floor instead, so neither is used: ``_java_divmod`` takes the
truncated quotient (``rounding_mode="trunc"``) and the remainder as
``a - q * b``; a divisor of -1 is negated apart, so MIN_VALUE / -1 is
MIN_VALUE and MIN_VALUE % -1 is 0 (Java's results) and the division
never traps.  For doubles Java's ``%`` is C's ``fmod``: exact.
``torch.fmod`` is that, except on the CPU where ``a / b`` overflows
(1e300 % 1e-300), where it gives NaN; ``_fmod`` redoes those rows by
exact subtraction of the divisor scaled by powers of two.
"""

from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import AnyColumn, Column
from spark_rapids_tpu_torch.exprs.base import (
    EvalContext,
    Expression,
    broadcast_validity,
)


@dataclasses.dataclass(repr=False)
class BinaryArithmetic(Expression):
    left: Expression
    right: Expression

    @property
    def dtype(self) -> T.DataType:
        ct = T.common_type(self.left.dtype, self.right.dtype)
        if ct is None or isinstance(ct, (T.StringType, T.BooleanType,
                                         T.DateType)):
            raise TypeError(
                f"incompatible types {self.left.dtype} / {self.right.dtype}")
        return ct

    @property
    def nullable(self) -> bool:
        return self.left.nullable or self.right.nullable

    def eval(self, ctx: EvalContext) -> AnyColumn:
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        phys = T.to_torch_dtype(self.dtype)
        data, valid = self.compute(lc.data.to(phys), rc.data.to(phys),
                                   broadcast_validity(lc, rc))
        return Column(data, valid, self.dtype)

    def compute(self, ld, rd, valid):
        raise NotImplementedError


class Add(BinaryArithmetic):
    def compute(self, ld, rd, valid):
        return ld + rd, valid


class Subtract(BinaryArithmetic):
    def compute(self, ld, rd, valid):
        return ld - rd, valid


class Multiply(BinaryArithmetic):
    def compute(self, ld, rd, valid):
        return ld * rd, valid


class Divide(BinaryArithmetic):
    """Double division; x / 0 -> NULL (Spark non-ANSI)."""

    @property
    def dtype(self) -> T.DataType:
        return T.DOUBLE

    @property
    def nullable(self) -> bool:
        return True

    def compute(self, ld, rd, valid):
        zero = rd == 0.0
        return ld / torch.where(zero, torch.ones_like(rd), rd), valid & ~zero


def _java_divmod(ld: torch.Tensor, rd: torch.Tensor):
    """Java's (quotient, remainder) of integer tensors: the quotient
    truncated toward zero, the remainder with the dividend's sign.
    ``rd`` holds no 0; a -1 divisor negates (wrapping at MIN_VALUE)."""
    minus_one = rd == -1
    q = torch.div(ld, torch.where(minus_one, torch.ones_like(rd), rd),
                  rounding_mode="trunc")
    q = torch.where(minus_one, -ld, q)
    return q, ld - q * rd


def _fmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C's fmod of doubles (``b`` nonzero), exact on every device."""
    r = torch.fmod(a, b)
    far = torch.nonzero(torch.isfinite(a) & torch.isfinite(b)
                        & ~torch.isfinite(a / b)).squeeze(1)
    if far.numel() == 0:
        return r
    x, y = torch.abs(a[far]), torch.abs(b[far])
    top = int((torch.frexp(x).exponent - torch.frexp(y).exponent).max())
    for k in range(top, -1, -1):
        t, rest = y, k
        while rest:  # y * 2^k in steps: 2.0 ** k overflows past 1023
            t = t * 2.0 ** min(rest, 1000)
            rest -= min(rest, 1000)
        # x < 2t holds from the top power down, so x - t is exact
        x = torch.where(x >= t, x - t, x)
    r = r.clone()
    r[far] = torch.copysign(x, a[far])
    return r


def _safe_divisor(rd: torch.Tensor, valid: torch.Tensor):
    """(divisor with its zeros replaced by 1, validity with those rows
    NULL): x / 0, x div 0, x % 0 and pmod(x, 0) are NULL."""
    zero = rd == 0
    return torch.where(zero, torch.ones_like(rd), rd), valid & ~zero


class IntegralDivide(BinaryArithmetic):
    """``a div b``: LONG, truncated toward zero; NULL on a zero
    divisor.  Integer operands divide in int64 (no double round trip:
    large longs would lose digits)."""

    @property
    def dtype(self) -> T.DataType:
        if isinstance(super().dtype, T.DoubleType):
            raise TypeError("div of doubles is not ported: Spark casts "
                            "them to DECIMAL first")
        return T.LONG

    @property
    def nullable(self) -> bool:
        return True

    def compute(self, ld, rd, valid):
        safe, valid = _safe_divisor(rd, valid)
        return _java_divmod(ld, safe)[0], valid


class Remainder(BinaryArithmetic):
    """``a % b`` with Java's sign (the dividend's); NULL on a zero
    divisor."""

    @property
    def nullable(self) -> bool:
        return True

    def compute(self, ld, rd, valid):
        safe, valid = _safe_divisor(rd, valid)
        if ld.is_floating_point():
            return _fmod(ld, safe), valid
        return _java_divmod(ld, safe)[1], valid


class Pmod(BinaryArithmetic):
    """Spark's pmod: ``r = a % n; if (r < 0) (r + n) % n else r`` with
    Java's ``%``, so pmod(-7, -3) is -1; NULL on a zero divisor."""

    @property
    def nullable(self) -> bool:
        return True

    def compute(self, ld, rd, valid):
        safe, valid = _safe_divisor(rd, valid)
        if ld.is_floating_point():
            r = _fmod(ld, safe)
            return torch.where(r < 0, _fmod(r + safe, safe), r), valid
        r = _java_divmod(ld, safe)[1]
        return torch.where(r < 0, _java_divmod(r + safe, safe)[1], r), valid


@dataclasses.dataclass(repr=False)
class UnaryMinus(Expression):
    child: Expression

    @property
    def dtype(self) -> T.DataType:
        return self.child.dtype

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = self.child.eval(ctx)
        return Column(-c.data, c.validity, self.dtype)


@dataclasses.dataclass(repr=False)
class UnaryPositive(Expression):
    child: Expression

    @property
    def dtype(self) -> T.DataType:
        return self.child.dtype

    def eval(self, ctx: EvalContext) -> AnyColumn:
        return self.child.eval(ctx)


@dataclasses.dataclass(repr=False)
class Abs(Expression):
    child: Expression

    @property
    def dtype(self) -> T.DataType:
        return self.child.dtype

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = self.child.eval(ctx)
        return Column(torch.abs(c.data), c.validity, self.dtype)


@dataclasses.dataclass(repr=False)
class Least(Expression):
    """least(e1, e2, ...): each row's smallest non-NULL argument (NULL
    when all are NULL), in the arguments' common type.  Doubles compare
    in Spark's total order, NaN the greatest: least(NaN, 1.0) = 1.0,
    greatest(NaN, 1.0) = NaN."""

    exprs: tuple[Expression, ...]

    def __init__(self, *exprs: Expression):
        self.exprs = tuple(exprs)

    @property
    def children(self) -> tuple[Expression, ...]:
        return self.exprs

    def with_children(self, children):
        return type(self)(*children)

    @property
    def dtype(self) -> T.DataType:
        out = self.exprs[0].dtype
        for e in self.exprs[1:]:
            ct = T.common_type(out, e.dtype)
            if ct is None:
                raise TypeError(f"incompatible types {out} / {e.dtype}")
            out = ct
        return out

    def eval(self, ctx: EvalContext) -> AnyColumn:
        phys = T.to_torch_dtype(self.dtype)
        acc = acc_valid = None
        for e in self.exprs:
            c = e.eval(ctx)
            d = c.data.to(phys)
            if acc is None:
                acc, acc_valid = d, c.validity
                continue
            take = c.validity & (~acc_valid | self._take_new(d, acc))
            acc = torch.where(take, d, acc)
            acc_valid = acc_valid | c.validity
        return Column(acc, acc_valid, self.dtype)

    @staticmethod
    def _lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a < b in the total order (NaN above +inf, NaN = NaN)."""
        if a.is_floating_point():
            return (a < b) | (~torch.isnan(a) & torch.isnan(b))
        return a < b

    def _take_new(self, d, acc):
        return self._lt(d, acc)


class Greatest(Least):
    def _take_new(self, d, acc):
        return self._lt(acc, d)
