"""Arithmetic with Spark SQL semantics.

Counterpart of ``spark_rapids_tpu/exprs/arithmetic.py`` for the slice:
NULL-propagating Add/Subtract/Multiply over the numeric common type
(integers wrap, as Spark's non-ANSI mode), and Divide, which is always
DOUBLE and yields NULL on a zero divisor.
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
