"""Decimal precision management.

Counterpart of ``spark_rapids_tpu/exprs/decimal.py``.  Spark's analyzer
wraps decimal arithmetic as
``CheckOverflow(op(PromotePrecision(l), PromotePrecision(r)))`` and the
physical layer works on unscaled integers.  Decimals here are int64
unscaled values (precision <= 18), so:

- ``PromotePrecision`` rescales the unscaled value to the target scale,
  one multiply by a power of ten, exact while the target fits int64;
- ``CheckOverflow`` re-asserts the declared precision after an
  operation: scaling down rounds HALF_UP (away from zero), scaling up
  is guarded before the multiply, and a value whose magnitude reaches
  10^precision becomes NULL (Spark's default nullOnOverflow; the raising
  mode is refused, and the planner runs it on the CPU engine);
- ``UnscaledValue`` reads the int64 backing as a LONG, ``MakeDecimal``
  reads a LONG as unscaled digits, NULL past the precision.
"""

from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import AnyColumn, Column
from spark_rapids_tpu_torch.exprs.base import EvalContext, Expression


def _within(data: torch.Tensor, precision: int) -> torch.Tensor:
    """|data| < 10^precision."""
    bound = 10 ** precision
    return (data > -bound) & (data < bound)


@dataclasses.dataclass(repr=False)
class PromotePrecision(Expression):
    """A decimal child rescaled to the target precision and scale."""

    child: Expression
    target: T.DecimalType

    @property
    def dtype(self) -> T.DataType:
        return self.target

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def check_supported(self) -> None:
        cdt = self.child.dtype
        if not isinstance(cdt, T.DecimalType):
            raise TypeError("PromotePrecision over non-decimal input")
        if self.target.scale < cdt.scale:
            raise TypeError(
                "PromotePrecision cannot reduce scale (would round)")
        if self.target.precision > T.DecimalType.MAX_PRECISION:
            raise TypeError("decimal precision beyond int64 falls back")

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = self.child.eval(ctx)
        diff = self.target.scale - self.child.dtype.scale
        data = c.data * 10 ** diff if diff else c.data
        return Column(data, c.validity, self.target)


@dataclasses.dataclass(repr=False)
class CheckOverflow(Expression):
    """Values past the declared precision become NULL."""

    child: Expression
    target: T.DecimalType
    null_on_overflow: bool = True

    @property
    def dtype(self) -> T.DataType:
        return self.target

    @property
    def nullable(self) -> bool:
        return True

    def check_supported(self) -> None:
        if not self.null_on_overflow:
            raise TypeError(
                "ANSI overflow (exception mode) falls back, like the "
                "reference's ansiEnabled tagging")
        if self.target.precision > T.DecimalType.MAX_PRECISION:
            raise TypeError("decimal precision beyond int64 falls back")

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = self.child.eval(ctx)
        diff = self.child.dtype.scale - self.target.scale
        data = c.data
        if diff > 0:
            # scale down, HALF_UP: round the magnitude, restore the sign
            p = 10 ** diff
            mag = torch.div(data.abs() + p // 2, p, rounding_mode="floor")
            data = torch.where(data < 0, -mag, mag)
            ok = _within(data, self.target.precision)
        elif diff < 0:
            # guard before scaling up: a wrapped product could land back
            # inside the bound and pass as a wrong value
            mult = 10 ** (-diff)
            limit = (10 ** self.target.precision - 1) // mult
            ok = (data >= -limit) & (data <= limit)
            data = data * mult
        else:
            ok = _within(data, self.target.precision)
        return Column(data, c.validity & ok, self.target)


@dataclasses.dataclass(repr=False)
class UnscaledValue(Expression):
    """decimal -> its LONG unscaled value (the backing itself)."""

    child: Expression

    @property
    def dtype(self) -> T.DataType:
        return T.LONG

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    @property
    def name(self) -> str:
        return f"unscaled({self.child.name})"

    def check_supported(self) -> None:
        if not isinstance(self.child.dtype, T.DecimalType):
            raise TypeError("UnscaledValue needs a decimal input")

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = self.child.eval(ctx)
        return Column(c.data.to(torch.int64), c.validity, T.LONG)


@dataclasses.dataclass(repr=False)
class MakeDecimal(Expression):
    """LONG unscaled -> decimal(p, s); NULL past the precision."""

    child: Expression
    precision: int
    scale: int

    @property
    def dtype(self) -> T.DataType:
        return T.DecimalType(self.precision, self.scale)

    @property
    def nullable(self) -> bool:
        return True

    @property
    def name(self) -> str:
        return (f"make_decimal({self.child.name}, "
                f"{self.precision}, {self.scale})")

    def check_supported(self) -> None:
        if not isinstance(self.child.dtype, T.IntegralType):
            raise TypeError("MakeDecimal needs an integral input")
        if self.precision > T.DecimalType.MAX_PRECISION:
            raise TypeError("decimal precision beyond int64 falls back")

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = self.child.eval(ctx)
        data = c.data.to(torch.int64)
        return Column(data, c.validity & _within(data, self.precision),
                      self.dtype)
