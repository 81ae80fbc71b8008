"""Casts, with Spark's non-ANSI results.

Counterpart of the part of ``spark_rapids_tpu/exprs/cast.py`` that
UNION's type widening and the SQL frontend need:

- INT, LONG and DOUBLE to one another: integral narrowing keeps the low
  bits (Java semantics), integral to DOUBLE rounds to nearest, DOUBLE to
  integral truncates toward zero with NaN -> 0 and +/-inf or out of
  range saturating at the target's MIN / MAX (Java ``(long) d``);
- the NULL type to any type: all NULL, a string column of zeroed chars;
- INT, LONG and BOOLEAN to STRING: decimal digits (``true`` /
  ``false``), as the JAX package expands them on its device;
- STRING to INT and LONG: an optional sign and digits within ASCII
  whitespace, a fractional tail truncated ('3.5' -> 3); NULL when the
  text is malformed or out of the type's range (non-ANSI Spark);
- DATE to STRING: ``yyyy-MM-dd`` (years 0-9999).

STRING to DOUBLE and DOUBLE to STRING (Java's shortest round-trip
digits), STRING to DATE, decimals, timestamps and ANSI error polling
are not ported; ``check_supported`` raises TypeError for them.  No
TPC-DS text the port runs casts anything but a number.
"""

from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import null_column
from spark_rapids_tpu_torch.columnar.column import (
    AnyColumn,
    Column,
    StringColumn,
)
from spark_rapids_tpu_torch.exprs.base import EvalContext, Expression

_INTEGRAL = (T.IntegerType, T.LongType)
_NUMERIC = _INTEGRAL + (T.DoubleType,)
#: decimal digits of the widest int64
_MAX_DIGITS = 20


def cast_supported(src: T.DataType, dst: T.DataType) -> bool:
    if src == dst or isinstance(src, T.NullType):
        return True
    if isinstance(src, _NUMERIC) and isinstance(dst, _NUMERIC):
        return True
    if isinstance(dst, T.StringType):
        return isinstance(src, _INTEGRAL + (T.BooleanType, T.DateType))
    return isinstance(src, T.StringType) and isinstance(dst, _INTEGRAL)


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
        if isinstance(src, T.StringType):
            return _parse_integral(c, dst)
        if isinstance(dst, T.StringType):
            if isinstance(src, T.BooleanType):
                return _bool_to_string(c)
            if isinstance(src, T.DateType):
                return _date_to_string(c)
            return _integral_to_string(c)
        phys = T.to_torch_dtype(dst)
        if c.data.is_floating_point() and not phys.is_floating_point:
            return Column(saturating_double_to_integral(c.data, phys),
                          c.validity, dst)
        return Column(c.data.to(phys), c.validity, dst)


def _digits(v: torch.Tensor, n: int) -> torch.Tensor:
    """(N, n) decimal digits of non-negative int64 values, most
    significant first, zero padded on the left."""
    p = torch.tensor([10 ** (n - 1 - i) for i in range(n)],
                     dtype=torch.int64, device=v.device)
    return torch.remainder(torch.div(v[:, None], p, rounding_mode="floor"),
                           10)


def _string_out(chars: torch.Tensor, lengths: torch.Tensor,
                validity: torch.Tensor) -> StringColumn:
    keep = torch.arange(chars.shape[1], device=chars.device)[None, :] \
        < lengths[:, None]
    chars = torch.where(keep & validity[:, None], chars, 0).to(torch.uint8)
    return StringColumn(chars, torch.where(validity, lengths, 0)
                        .to(torch.int32), validity)


def _integral_to_string(c: Column) -> StringColumn:
    """Decimal digits with a leading '-' for negatives, MIN_VALUE
    included (its magnitude is taken digit by digit from the negated
    remainders, so nothing overflows)."""
    v = c.data.to(torch.int64)
    neg = v < 0
    # digits of |v| without negating MIN_VALUE: -(v // 10) and -(v % 10)
    # of a negative v are both in range
    q = torch.where(neg, -torch.div(v, 10, rounding_mode="trunc"),
                    torch.div(v, 10, rounding_mode="trunc"))
    last = torch.abs(torch.fmod(v, 10))
    digs = torch.cat([_digits(q, _MAX_DIGITS - 1), last[:, None]], dim=1)
    nz = (digs != 0).to(torch.int32)
    lead_zeros = (torch.cumsum(nz, dim=1) == 0).sum(dim=1)
    ndig = (_MAX_DIGITS - lead_zeros).clamp(min=1)
    length = ndig + neg.to(torch.int64)
    pos = torch.arange(_MAX_DIGITS + 1, device=v.device)[None, :]
    src = pos - neg.to(torch.int64)[:, None] + (_MAX_DIGITS - ndig)[:, None]
    chars = torch.gather(digs, 1, src.clamp(0, _MAX_DIGITS - 1)) + 48
    chars = torch.where((pos == 0) & neg[:, None], 45, chars)  # '-'
    return _string_out(chars, length, c.validity)


def _bool_to_string(c: Column) -> StringColumn:
    t = torch.tensor(list(b"true\0"), dtype=torch.int64,
                     device=c.data.device)
    f = torch.tensor(list(b"false"), dtype=torch.int64, device=c.data.device)
    b = c.data.bool()
    return _string_out(torch.where(b[:, None], t, f),
                       torch.where(b, 4, 5), c.validity)


def _date_to_string(c: Column) -> StringColumn:
    """``yyyy-MM-dd``."""
    from spark_rapids_tpu_torch.exprs.datetime import civil_from_days

    y, m, d = civil_from_days(c.data)
    digs = torch.cat([_digits(y.clamp(0, 9999), 4), _digits(m, 2),
                      _digits(d, 2)], dim=1) + 48
    dash = torch.full((len(c), 1), 45, dtype=torch.int64,
                      device=c.data.device)
    chars = torch.cat([digs[:, :4], dash, digs[:, 4:6], dash, digs[:, 6:]],
                      dim=1)
    return _string_out(chars, torch.full((len(c),), 10,
                                         device=c.data.device), c.validity)


def _parse_integral(c: StringColumn, dst: T.DataType) -> Column:
    """STRING -> INT / LONG: ASCII whitespace around an optional sign,
    digits and an optional '.' with digits after it (dropped: Spark
    truncates); NULL when malformed, without digits, or out of range."""
    ch = c.chars.to(torch.int64)
    n, w = ch.shape
    dev = ch.device
    pos = torch.arange(w, device=dev)[None, :]
    in_str = pos < c.lengths[:, None]
    space = in_str & ((ch == 32) | ((ch >= 9) & (ch <= 13)))
    lead = torch.cumprod(space.to(torch.int64), dim=1).sum(dim=1)
    pad_or_space = (space | ~in_str).flip(1).to(torch.int64)
    end = w - torch.cumprod(pad_or_space, dim=1).sum(dim=1)
    start = lead
    end = torch.maximum(end, start)
    at_start = in_str & (pos == start[:, None])
    has_sign = (at_start & ((ch == 45) | (ch == 43))).any(dim=1)
    negative = (at_start & (ch == 45)).any(dim=1)
    dstart = start + has_sign.to(torch.int64)
    payload = (pos >= dstart[:, None]) & (pos < end[:, None])
    is_digit = (ch >= 48) & (ch <= 57)
    dot = payload & (ch == 46)
    first_dot = torch.where(dot.any(dim=1),
                            dot.to(torch.int8).argmax(dim=1), end)
    int_pos = payload & (pos < first_dot[:, None])
    frac_pos = payload & (pos > first_dot[:, None])
    ok = ((~int_pos | is_digit).all(dim=1) & (~frac_pos | is_digit).all(dim=1)
          & (((int_pos | frac_pos) & is_digit).sum(dim=1) > 0))
    # Horner over the integer digits in the negative range (which holds
    # MIN_VALUE), flagging any step that leaves int64
    acc = torch.zeros(n, dtype=torch.int64, device=dev)
    overflow = torch.zeros(n, dtype=torch.bool, device=dev)
    lo = -(2 ** 63)
    for j in range(w):
        use = int_pos[:, j]
        dj = torch.where(use, ch[:, j] - 48, 0)
        overflow |= use & ((acc < lo // 10 + 1)
                           | ((acc == lo // 10 + 1) & (dj > 8)))
        acc = torch.where(use & ~overflow, acc * 10 - dj, acc)
    ok = ok & ~overflow & (negative | (acc != lo))
    val = torch.where(negative, acc, -acc)
    phys = T.to_torch_dtype(dst)
    if phys != torch.int64:
        info = torch.iinfo(phys)
        ok = ok & (val >= info.min) & (val <= info.max)
    return Column(torch.where(ok, val, 0).to(phys), c.validity & ok, dst)
