"""Casts, with Spark's non-ANSI results.

Counterpart of ``spark_rapids_tpu/exprs/cast.py``, its whole matrix
(``cast_supported`` is the JAX function) and two pairs more:

- numeric to numeric across TINYINT, SMALLINT, INT, LONG, FLOAT and
  DOUBLE: integral narrowing keeps the low bits (Java semantics),
  floating to integral truncates toward zero with NaN -> 0 and +/-inf
  or out of range saturating at the target's MIN / MAX (Java
  ``(long) d``);
- numeric to BOOLEAN (``!= 0``) and BOOLEAN to numeric (1 / 0);
- DATE to TIMESTAMP (midnight UTC) and TIMESTAMP to DATE (the day,
  floored); TIMESTAMP to LONG (epoch seconds, floored) and LONG to
  TIMESTAMP (seconds);
- DECIMAL to a DECIMAL that keeps every digit (scale and integral
  digits both non-decreasing), integral to a DECIMAL that holds every
  value of the source type, DECIMAL to FLOAT / DOUBLE;
- integral and BOOLEAN to STRING: decimal digits (``true`` /
  ``false``), as the JAX package expands them on its device;
- STRING to integral: an optional sign and digits within ASCII
  whitespace, a fractional tail truncated ('3.5' -> 3); NULL when the
  text is malformed or out of the type's range (non-ANSI Spark);
- and beyond the JAX matrix: the NULL type to any type (all NULL, as
  UNION's widening needs), DATE to STRING (``yyyy-MM-dd``, years
  0-9999).

With an ANSI capture open (``exprs/base.py``) a cast reports what
ANSI mode rejects, with the JAX messages: a malformed STRING to an
integral type ("invalid input syntax"), a FLOAT / DOUBLE to an integral
type that is NaN or out of its range, and an integral narrowing that
loses the value ("value out of range"); NULL rows never report.

STRING to DOUBLE / DATE / TIMESTAMP, DOUBLE to STRING and decimal
narrowing lie outside the JAX matrix; ``check_supported`` raises
TypeError for them, and the planner runs the node on the CPU engine
(q37's ``cast('2000-02-01' as date)`` filter of date_dim).
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
from spark_rapids_tpu_torch.exprs.base import (
    EvalContext,
    Expression,
    ansi_active,
    ansi_report,
)
from spark_rapids_tpu_torch.exprs.datetime import US_PER_DAY, US_PER_SECOND

_INTEGRAL = (T.ByteType, T.ShortType, T.IntegerType, T.LongType)
_FLOATING = (T.FloatType, T.DoubleType)
_NUMERIC = _INTEGRAL + _FLOATING
#: decimal digits of the widest int64
_MAX_DIGITS = 20


def cast_supported(src: T.DataType, dst: T.DataType) -> bool:
    """The JAX package's cast matrix, plus NULL to any type and DATE to
    STRING."""
    if src == dst or isinstance(src, T.NullType):
        return True
    ts, td = type(src), type(dst)
    if ts in _NUMERIC and td in _NUMERIC:
        return True
    if (ts in _NUMERIC and td is T.BooleanType) \
            or (ts is T.BooleanType and td in _NUMERIC):
        return True
    if {ts, td} == {T.DateType, T.TimestampType}:
        return True
    if {ts, td} == {T.TimestampType, T.LongType}:
        return True
    if td is T.StringType:
        return ts in _INTEGRAL + (T.BooleanType, T.DateType)
    if ts is T.StringType:
        return td in _INTEGRAL
    if ts is T.DecimalType and td is T.DecimalType:
        # widening only: no value can leave the int64 unscaled backing
        return (dst.scale >= src.scale
                and dst.precision - dst.scale >= src.precision - src.scale)
    if ts in _INTEGRAL and td is T.DecimalType:
        return dst.precision - dst.scale >= T.INTEGRAL_DECIMAL_DIGITS[ts]
    return ts is T.DecimalType and td in _FLOATING


def saturating_double_to_integral(d: torch.Tensor,
                                  phys: torch.dtype) -> torch.Tensor:
    """Java ``(long) d`` / ``(int) d``: truncate toward zero, NaN -> 0,
    +/-inf and out of range saturate.  By threshold compare: float64
    cannot hold INT64_MAX, so clip-then-convert would overflow."""
    info = torch.iinfo(phys)
    hi, lo = float(info.max) + 1.0, float(info.min)  # exact powers of two
    d = d.to(torch.float64)
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
            out = _parse_integral(c, dst)
            if ansi_active():
                ansi_report(c.validity & ~out.validity,
                            f"invalid input syntax for type {dst.name} "
                            "(ANSI cast)")
            return out
        if isinstance(dst, T.StringType):
            if isinstance(src, T.BooleanType):
                return _bool_to_string(c)
            if isinstance(src, T.DateType):
                return _date_to_string(c)
            return _integral_to_string(c)
        out = cast_column(c, src, dst)
        if ansi_active() and isinstance(dst, _INTEGRAL) \
                and isinstance(src, _NUMERIC):
            _ansi_range_check(c, out, dst)
        return out


def _ansi_range_check(c: Column, out: Column, dst: T.DataType) -> None:
    """ANSI: a floating value that is NaN or whose truncation leaves the
    integral type, or an integral one the narrowing changed."""
    msg = f"value out of range for {dst.name} (ANSI cast overflow)"
    d = c.data
    if d.is_floating_point():
        info = torch.iinfo(T.to_torch_dtype(dst))
        f = d.to(torch.float64)
        t = torch.trunc(f)
        ansi_report(c.validity & (torch.isnan(f) | (t > float(info.max))
                                  | (t < float(info.min))), msg)
    elif out.data.element_size() < d.element_size():
        ansi_report(c.validity & (out.data.to(d.dtype) != d), msg)


def cast_column(c: Column, src: T.DataType, dst: T.DataType) -> Column:
    """A cast between two fixed-width types of the matrix; also the
    conversion of an operand into its comparison's or branch's common
    type (``exprs/predicates.py``)."""
    d, valid = c.data, c.validity
    ts, td = type(src), type(dst)
    phys = T.to_torch_dtype(dst)
    if td is T.BooleanType:
        return Column(d != 0, valid, dst)
    if ts is T.DecimalType and td is T.DecimalType:
        # widening only, so the shift is >= 0 and the result fits
        return Column(d * 10 ** (dst.scale - src.scale), valid, dst)
    if ts in _INTEGRAL + (T.BooleanType,) and td is T.DecimalType:
        return Column(d.to(torch.int64) * 10 ** dst.scale, valid, dst)
    if ts is T.DecimalType:  # to FLOAT / DOUBLE
        return Column((d.to(torch.float64) / 10.0 ** src.scale).to(phys),
                      valid, dst)
    if ts is T.DateType and td is T.TimestampType:
        return Column(d.to(torch.int64) * US_PER_DAY, valid, dst)
    if ts is T.TimestampType and td is T.DateType:
        return Column(torch.div(d, US_PER_DAY, rounding_mode="floor")
                      .to(torch.int32), valid, dst)
    if ts is T.TimestampType:  # to LONG: epoch seconds
        return Column(torch.div(d, US_PER_SECOND, rounding_mode="floor"),
                      valid, dst)
    if td is T.TimestampType:  # from LONG
        return Column(d * US_PER_SECOND, valid, dst)
    if c.data.is_floating_point() and not phys.is_floating_point:
        return Column(saturating_double_to_integral(d, phys), valid, dst)
    return Column(d.to(phys), valid, dst)


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
