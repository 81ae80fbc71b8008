"""Cast among the numeric types, and from NULL.

Counterpart of the part of ``spark_rapids_tpu/exprs/cast.py`` that
UNION's type widening needs, with Spark's non-ANSI results:

- INT, LONG and DOUBLE to one another: integral narrowing keeps the low
  bits (Java semantics), integral to DOUBLE rounds to nearest, DOUBLE to
  integral truncates toward zero with NaN -> 0 and +/-inf or out of
  range saturating at the target's MIN / MAX (Java ``(long) d``);
- the NULL type to any type: all NULL, a string column of zeroed chars.

The rest of the JAX matrix (strings, dates, decimals, booleans) and ANSI
error polling are not ported; ``check_supported`` raises TypeError for
them.
"""

from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import null_column
from spark_rapids_tpu_torch.columnar.column import AnyColumn, Column
from spark_rapids_tpu_torch.exprs.base import EvalContext, Expression

_NUMERIC = (T.IntegerType, T.LongType, T.DoubleType)


def cast_supported(src: T.DataType, dst: T.DataType) -> bool:
    return (src == dst or isinstance(src, T.NullType)
            or (isinstance(src, _NUMERIC) and isinstance(dst, _NUMERIC)))


def saturating_double_to_integral(d: torch.Tensor,
                                  phys: torch.dtype) -> torch.Tensor:
    """Java ``(long) d`` / ``(int) d``: truncate toward zero, NaN -> 0,
    +/-inf and out of range saturate.  By threshold compare: float64
    cannot hold INT64_MAX, so clip-then-convert would overflow."""
    info = torch.iinfo(phys)
    hi, lo = float(info.max) + 1.0, float(info.min)  # exact powers of two
    t = torch.trunc(torch.where(torch.isnan(d), 0.0, d))
    out = torch.where((t > lo) & (t < hi), t, 0.0).to(phys)
    out = torch.where(t >= hi, info.max, out)
    return torch.where(t <= lo, info.min, out)


@dataclasses.dataclass(repr=False)
class Cast(Expression):
    child: Expression
    to: T.DataType

    @property
    def dtype(self) -> T.DataType:
        return self.to

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    @property
    def name(self) -> str:
        return f"cast({self.child.name} as {self.to.name})"

    def check_supported(self) -> None:
        if not cast_supported(self.child.dtype, self.to):
            raise TypeError(f"cast {self.child.dtype} -> {self.to} is not "
                            "ported")

    def eval(self, ctx: EvalContext) -> AnyColumn:
        self.check_supported()
        c = self.child.eval(ctx)
        src, dst = self.child.dtype, self.to
        if src == dst:
            return c
        if isinstance(src, T.NullType):
            return null_column(dst, len(c), c.validity.device)
        phys = T.to_torch_dtype(dst)
        if c.data.is_floating_point() and not phys.is_floating_point:
            return Column(saturating_double_to_integral(c.data, phys),
                          c.validity, dst)
        return Column(c.data.to(phys), c.validity, dst)
