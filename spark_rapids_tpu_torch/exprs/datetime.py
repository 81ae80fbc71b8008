"""DATE expressions.

Counterpart of the DATE half of ``spark_rapids_tpu/exprs/datetime.py``:
the civil-calendar fields (year, month, day, quarter, day of week,
weekday, day of year), ``last_day``, ``add_months``, ``date_add``,
``date_sub`` and ``datediff``.  A DATE is int32 days since 1970-01-01.
Calendar fields come from Howard Hinnant's ``civil_from_days`` /
``days_from_civil``: branch-free integer arithmetic, done here in int64
with floor division, so dates before 1970 (negative days) and the
spec's whole 1900-2100 calendar convert exactly, on the proleptic
Gregorian calendar as Python's ``datetime`` does.

The TIMESTAMP fields (hour, minute, second) and every function after
``datediff`` in the JAX module need the TIMESTAMP type, which the port
does not have yet; the SQL frontend raises ``SqlError`` for them.
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


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z: torch.Tensor):
    """days since the epoch -> (year, month 1-12, day 1-31), int64."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097  # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)  # [0, 399]
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)  # [0, 11], March first
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return torch.where(m <= 2, y + 1, y), m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
    """(year, month, day) -> int32 days since the epoch."""
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9).to(torch.int64)
    doy = _fdiv(153 * mp + 2, 5) + d.to(torch.int64) - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


def _leap(y: torch.Tensor) -> torch.Tensor:
    return ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)


_DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _days_in_month(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    dim = torch.tensor(_DAYS_IN_MONTH, dtype=torch.int64,
                       device=m.device)[m - 1]
    return torch.where((m == 2) & _leap(y), 29, dim)


@dataclasses.dataclass(repr=False)
class _DateField(Expression):
    child: Expression

    @property
    def dtype(self) -> T.DataType:
        return T.INT

    def _field(self, days: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval(self, ctx: EvalContext) -> AnyColumn:
        if not isinstance(self.child.dtype, T.DateType):
            raise TypeError(f"{self.name} needs a DATE, got "
                            f"{self.child.dtype}")
        c = self.child.eval(ctx)
        return Column(self._field(c.data.to(torch.int64)).to(torch.int32),
                      c.validity, T.INT)


class Year(_DateField):
    def _field(self, days):
        return civil_from_days(days)[0]


class Month(_DateField):
    def _field(self, days):
        return civil_from_days(days)[1]


class DayOfMonth(_DateField):
    def _field(self, days):
        return civil_from_days(days)[2]


class Quarter(_DateField):
    def _field(self, days):
        return _fdiv(civil_from_days(days)[1] - 1, 3) + 1


class DayOfWeek(_DateField):
    """Spark's dayofweek: Sunday = 1 .. Saturday = 7 (1970-01-01 was a
    Thursday)."""

    def _field(self, days):
        return torch.remainder(days + 4, 7) + 1


class WeekDay(_DateField):
    """Spark's weekday: Monday = 0 .. Sunday = 6."""

    def _field(self, days):
        return torch.remainder(days + 3, 7)


class DayOfYear(_DateField):
    def _field(self, days):
        y = civil_from_days(days)[0]
        one = torch.ones_like(y)
        return days - days_from_civil(y, one, one).to(torch.int64) + 1


@dataclasses.dataclass(repr=False)
class LastDay(Expression):
    """The last day of the input date's month, a DATE."""

    child: Expression

    @property
    def dtype(self) -> T.DataType:
        return T.DATE

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = self.child.eval(ctx)
        y, m, _ = civil_from_days(c.data)
        return Column(days_from_civil(y, m, _days_in_month(y, m)),
                      c.validity, T.DATE)


@dataclasses.dataclass(repr=False)
class AddMonths(Expression):
    """add_months(date, n): the calendar month shift, the day clamped to
    the target month's end (Jan 31 + 1 month = Feb 28, 29 in a leap
    year); the month/year arm of the SQL frontend's date-column
    interval arithmetic lowers here."""

    child: Expression
    months: int

    @property
    def dtype(self) -> T.DataType:
        return T.DATE

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    @property
    def name(self) -> str:
        return f"add_months({self.child.name}, {self.months})"

    def eval(self, ctx: EvalContext) -> AnyColumn:
        if not isinstance(self.child.dtype, T.DateType):
            raise TypeError("AddMonths needs a date input")
        c = self.child.eval(ctx)
        y, m, d = civil_from_days(c.data)
        mi = y * 12 + (m - 1) + self.months
        y2 = _fdiv(mi, 12)
        m2 = mi - y2 * 12 + 1
        d2 = torch.minimum(d, _days_in_month(y2, m2))
        return Column(days_from_civil(y2, m2, d2), c.validity, T.DATE)


@dataclasses.dataclass(repr=False)
class DateAdd(Expression):
    """date_add(date, days) -> DATE."""

    left: Expression
    right: Expression

    _sign = 1

    @property
    def dtype(self) -> T.DataType:
        return T.DATE

    def eval(self, ctx: EvalContext) -> AnyColumn:
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        out = lc.data.to(torch.int32) + self._sign * rc.data.to(torch.int32)
        return Column(out, broadcast_validity(lc, rc), T.DATE)


class DateSub(DateAdd):
    _sign = -1


@dataclasses.dataclass(repr=False)
class DateDiff(Expression):
    """datediff(end, start) -> INT days."""

    left: Expression
    right: Expression

    @property
    def dtype(self) -> T.DataType:
        return T.INT

    def eval(self, ctx: EvalContext) -> AnyColumn:
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        out = lc.data.to(torch.int32) - rc.data.to(torch.int32)
        return Column(out, broadcast_validity(lc, rc), T.INT)
