"""Bitwise and shift expressions.

Counterpart of ``spark_rapids_tpu/exprs/bitwise.py``, with Java's
rules, as Spark has them:

- ``&``, ``|``, ``^`` over the operands' common integral type, ``~``
  over the operand's;
- a shift amount is taken modulo the value's width (32 bits, or 64 for
  a LONG): ``x << 65`` is ``x << 1`` for a LONG;
- ``>>`` propagates the sign; ``>>>`` (``ShiftRightUnsigned``) fills
  with zeros: torch's ``>>`` of a signed tensor is arithmetic, so the
  result is masked to the ``width - amount`` low bits.

A value narrower than INT shifts as an INT (Java promotes it) and is
cut back to its own type.
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
class BitwiseBinary(Expression):
    left: Expression
    right: Expression

    @property
    def dtype(self) -> T.DataType:
        ct = T.common_type(self.left.dtype, self.right.dtype)
        if ct is None or not isinstance(ct, T.IntegralType):
            raise TypeError("bitwise op requires integral operands")
        return ct

    @staticmethod
    def _op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval(self, ctx: EvalContext) -> AnyColumn:
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        phys = T.to_torch_dtype(self.dtype)
        return Column(self._op(l.data.to(phys), r.data.to(phys)),
                      broadcast_validity(l, r), self.dtype)


class BitwiseAnd(BitwiseBinary):
    _op = staticmethod(torch.bitwise_and)


class BitwiseOr(BitwiseBinary):
    _op = staticmethod(torch.bitwise_or)


class BitwiseXor(BitwiseBinary):
    _op = staticmethod(torch.bitwise_xor)


@dataclasses.dataclass(repr=False)
class BitwiseNot(Expression):
    child: Expression

    @property
    def dtype(self) -> T.DataType:
        return self.child.dtype

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = self.child.eval(ctx)
        return Column(~c.data, c.validity, self.dtype)


@dataclasses.dataclass(repr=False)
class ShiftLeft(Expression):
    left: Expression
    right: Expression  # the shift amount

    @property
    def dtype(self) -> T.DataType:
        return self.left.dtype

    def _bits(self) -> int:
        return 64 if isinstance(self.left.dtype, T.LongType) else 32

    @staticmethod
    def _shift(v: torch.Tensor, amount: torch.Tensor,
               bits: int) -> torch.Tensor:
        return v << amount

    def eval(self, ctx: EvalContext) -> AnyColumn:
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        bits = self._bits()
        phys = torch.int64 if bits == 64 else torch.int32
        amount = r.data.to(phys) & (bits - 1)  # Java masks the amount
        out = self._shift(l.data.to(phys), amount, bits)
        return Column(out.to(T.to_torch_dtype(self.dtype)),
                      broadcast_validity(l, r), self.dtype)


class ShiftRight(ShiftLeft):
    @staticmethod
    def _shift(v, amount, bits):
        return v >> amount  # arithmetic: the sign propagates


class ShiftRightUnsigned(ShiftLeft):
    @staticmethod
    def _shift(v, amount, bits):
        # the arithmetic shift, then its top ``amount`` bits cleared:
        # (1 << (bits - amount)) - 1 wraps to the type's MAX at amount 1
        mask = (torch.ones_like(v) << (bits - amount).clamp(max=bits - 1)) - 1
        return torch.where(amount == 0, v, (v >> amount) & mask)
