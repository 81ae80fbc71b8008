"""Math expressions with Spark SQL semantics.

Counterpart of ``spark_rapids_tpu/exprs/math.py`` without decimal
inputs (the port has no DECIMAL type yet).  Where Spark differs from
IEEE or torch defaults, Spark wins:

- the log family gives NULL, not NaN or -inf, for inputs out of its
  domain (<= 0; <= -1 for log1p);
- ceil / floor of a double are LONG, saturating as Java's ``(long) d``;
- ``round`` is HALF_UP (ties away from zero) and ``bround`` HALF_EVEN.
  ``torch.round`` is half-to-even, so only ``BRound`` uses it; ``Round``
  takes the JAX package's formula ``sign(x) * floor(|x| + 0.5)`` on the
  scaled value;
- ``signum`` keeps NaN and the sign of a zero, as ``Math.signum`` does
  (``torch.sign`` maps NaN and -0.0 to 0.0); ``round`` keeps them too,
  as the JAX formula does (round(-0.0) = -0.0).

torch has no ``cbrt``: ``Cbrt`` takes ``|x| ** (1/3)`` with the sign
and one Newton step, within an ulp or two of ``jnp.cbrt``.  The other
transcendental functions are torch's own and agree with numpy's to
within a few ulps.
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
from spark_rapids_tpu_torch.exprs.cast import saturating_double_to_integral


def _cbrt(d: torch.Tensor) -> torch.Tensor:
    y = torch.sign(d) * torch.abs(d).pow(1.0 / 3.0)
    fix = torch.isfinite(y) & (y != 0)
    safe = torch.where(fix, y, torch.ones_like(y))
    return torch.where(fix, y - (y * y * y - d) / (3.0 * safe * safe), y)


def _signum(d: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(d) | (d == 0), d, torch.sign(d))


@dataclasses.dataclass(repr=False)
class UnaryMath(Expression):
    """double -> double, element by element."""

    child: Expression

    fn = staticmethod(lambda d: d)

    @property
    def dtype(self) -> T.DataType:
        return T.DOUBLE

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = self.child.eval(ctx)
        return Column(type(self).fn(c.data.to(torch.float64)), c.validity,
                      T.DOUBLE)


class Sqrt(UnaryMath):
    fn = staticmethod(torch.sqrt)  # sqrt of a negative is NaN, as Spark


class Cbrt(UnaryMath):
    fn = staticmethod(_cbrt)


class Exp(UnaryMath):
    fn = staticmethod(torch.exp)


class Expm1(UnaryMath):
    fn = staticmethod(torch.expm1)


class Sin(UnaryMath):
    fn = staticmethod(torch.sin)


class Cos(UnaryMath):
    fn = staticmethod(torch.cos)


class Tan(UnaryMath):
    fn = staticmethod(torch.tan)


class Cot(UnaryMath):
    fn = staticmethod(lambda d: 1.0 / torch.tan(d))


class Asin(UnaryMath):
    fn = staticmethod(torch.asin)


class Acos(UnaryMath):
    fn = staticmethod(torch.acos)


class Atan(UnaryMath):
    fn = staticmethod(torch.atan)


class Sinh(UnaryMath):
    fn = staticmethod(torch.sinh)


class Cosh(UnaryMath):
    fn = staticmethod(torch.cosh)


class Tanh(UnaryMath):
    fn = staticmethod(torch.tanh)


class Asinh(UnaryMath):
    fn = staticmethod(torch.asinh)


class Acosh(UnaryMath):
    fn = staticmethod(torch.acosh)


class Atanh(UnaryMath):
    fn = staticmethod(torch.atanh)


class Rint(UnaryMath):
    fn = staticmethod(torch.round)  # half to even, as Math.rint


class Signum(UnaryMath):
    fn = staticmethod(_signum)


class ToDegrees(UnaryMath):
    fn = staticmethod(torch.rad2deg)


class ToRadians(UnaryMath):
    fn = staticmethod(torch.deg2rad)


class _LogBase(UnaryMath):
    """Spark's log family: NULL where the input is out of the domain
    (<= 0, or <= -1 for log1p)."""

    _shift = 0.0

    @property
    def nullable(self) -> bool:
        return True

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = self.child.eval(ctx)
        d = c.data.to(torch.float64)
        bad = d <= -self._shift
        safe = torch.where(bad, torch.ones_like(d), d)
        return Column(type(self).fn(safe), c.validity & ~bad, T.DOUBLE)


class Log(_LogBase):
    fn = staticmethod(torch.log)


class Log10(_LogBase):
    fn = staticmethod(torch.log10)


class Log2(_LogBase):
    fn = staticmethod(torch.log2)


class Log1p(_LogBase):
    fn = staticmethod(torch.log1p)
    _shift = 1.0


@dataclasses.dataclass(repr=False)
class Logarithm(Expression):
    """log(base, x): NULL where x <= 0 or base <= 0."""

    base: Expression
    child: Expression

    @property
    def dtype(self) -> T.DataType:
        return T.DOUBLE

    @property
    def nullable(self) -> bool:
        return True

    def eval(self, ctx: EvalContext) -> AnyColumn:
        b = self.base.eval(ctx)
        c = self.child.eval(ctx)
        bd = b.data.to(torch.float64)
        cd = c.data.to(torch.float64)
        bad = (cd <= 0.0) | (bd <= 0.0)
        out = (torch.log(torch.where(cd <= 0, torch.ones_like(cd), cd))
               / torch.log(torch.where(bd <= 0, torch.full_like(bd, 2.0),
                                       bd)))
        return Column(out, broadcast_validity(b, c) & ~bad, T.DOUBLE)


@dataclasses.dataclass(repr=False)
class Pow(Expression):
    left: Expression
    right: Expression

    @property
    def dtype(self) -> T.DataType:
        return T.DOUBLE

    def eval(self, ctx: EvalContext) -> AnyColumn:
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        out = torch.pow(lc.data.to(torch.float64), rc.data.to(torch.float64))
        return Column(out, broadcast_validity(lc, rc), T.DOUBLE)


@dataclasses.dataclass(repr=False)
class Ceil(Expression):
    """ceil(double) -> LONG, saturating as Java's ``(long) d`` (NaN ->
    0); the identity on integral types."""

    child: Expression

    _fn = staticmethod(torch.ceil)

    @property
    def dtype(self) -> T.DataType:
        if isinstance(self.child.dtype, T.DoubleType):
            return T.LONG
        return self.child.dtype

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = self.child.eval(ctx)
        if not isinstance(self.child.dtype, T.DoubleType):
            return c
        r = type(self)._fn(c.data.to(torch.float64))
        return Column(saturating_double_to_integral(r, torch.int64),
                      c.validity, T.LONG)


class Floor(Ceil):
    _fn = staticmethod(torch.floor)


@dataclasses.dataclass(repr=False)
class Round(Expression):
    """round(x, scale): HALF_UP (``BRound``: HALF_EVEN).  Doubles scale
    by 10^scale, round and scale back; integers with a negative scale
    round to a multiple of 10^-scale, and are unchanged otherwise."""

    child: Expression
    scale: int = 0

    half_even = False

    @property
    def dtype(self) -> T.DataType:
        return self.child.dtype

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = self.child.eval(ctx)
        dt = self.child.dtype
        if isinstance(dt, T.DoubleType):
            p = 10.0 ** self.scale
            scaled = c.data.to(torch.float64) * p
            if self.half_even:
                r = torch.round(scaled)
            else:
                r = _signum(scaled) * torch.floor(torch.abs(scaled) + 0.5)
            return Column(r / p, c.validity, dt)
        if self.scale >= 0:
            return c
        p = 10 ** (-self.scale)
        d = c.data.to(torch.int64)
        if self.half_even:
            # floor-based: the remainder in [0, p) makes HALF_EVEN
            # symmetric about zero
            q0 = torch.div(d, p, rounding_mode="floor")
            rem = d - q0 * p
            odd = torch.remainder(q0, 2) != 0
            up = (rem * 2 > p) | ((rem * 2 == p) & odd)
            out = (q0 + up.to(torch.int64)) * p
        else:
            half = p // 2
            out = torch.where(
                d >= 0, torch.div(d + half, p, rounding_mode="floor"),
                -torch.div(-d + half, p, rounding_mode="floor")) * p
        return Column(out.to(c.data.dtype), c.validity, dt)


class BRound(Round):
    half_even = True


@dataclasses.dataclass(repr=False)
class NaNvl(Expression):
    """nanvl(a, b): ``b`` where ``a`` is NaN, else ``a``."""

    left: Expression
    right: Expression

    @property
    def dtype(self) -> T.DataType:
        return self.left.dtype

    def eval(self, ctx: EvalContext) -> AnyColumn:
        a = self.left.eval(ctx)
        b = self.right.eval(ctx)
        take_b = torch.isnan(a.data.to(torch.float64)) & a.validity
        phys = T.to_torch_dtype(self.dtype)
        return Column(torch.where(take_b, b.data.to(phys), a.data.to(phys)),
                      torch.where(take_b, b.validity, a.validity),
                      self.dtype)


@dataclasses.dataclass(repr=False)
class NormalizeNaNAndZero(Expression):
    """Every NaN the canonical NaN and -0.0 as 0.0, so float group and
    join keys compare equal."""

    child: Expression

    @property
    def dtype(self) -> T.DataType:
        return self.child.dtype

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = self.child.eval(ctx)
        d = c.data
        d = torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)
        return Column(d + 0.0, c.validity, self.dtype)  # -0.0 + 0.0 = 0.0


@dataclasses.dataclass(repr=False)
class KnownFloatingPointNormalized(Expression):
    """Marks an input already normalized: the identity."""

    child: Expression

    @property
    def dtype(self) -> T.DataType:
        return self.child.dtype

    def eval(self, ctx: EvalContext) -> AnyColumn:
        return self.child.eval(ctx)
