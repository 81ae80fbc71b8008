"""DATE and TIMESTAMP expressions.

Counterpart of ``spark_rapids_tpu/exprs/datetime.py``: the civil-
calendar fields (year, month, day, quarter, day of week, weekday, day
of year) of a DATE or a TIMESTAMP, the time fields (hour, minute,
second), ``last_day``, ``add_months``, ``date_add``, ``date_sub``,
``datediff``, ``to_unix_timestamp``, ``from_unixtime`` and
``date_format`` (the two formats the JAX package formats on its
device), and timestamp / date plus a literal calendar interval.

A DATE is int32 days since 1970-01-01, a TIMESTAMP int64 microseconds
since the epoch, UTC only.  Calendar fields come from Howard Hinnant's
``civil_from_days`` / ``days_from_civil``: branch-free integer
arithmetic, done here in int64 with floor division, so instants before
1970 (negative counts) and the spec's whole 1900-2100 calendar convert
exactly, on the proleptic Gregorian calendar as Python's ``datetime``
does.  A TIMESTAMP's day and time of day are its microseconds floor-
divided by the day, so 1969-12-31 23:00 is hour 23 of day -1.
"""

from __future__ import annotations

import dataclasses

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
    broadcast_validity,
)


US_PER_DAY = 86_400_000_000
US_PER_HOUR = 3_600_000_000
US_PER_MINUTE = 60_000_000
US_PER_SECOND = 1_000_000


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
        if not isinstance(self.child.dtype, (T.DateType, T.TimestampType)):
            raise TypeError(f"{self.name} needs a DATE or a TIMESTAMP, "
                            f"got {self.child.dtype}")
        c = self.child.eval(ctx)
        days = c.data.to(torch.int64)
        if isinstance(self.child.dtype, T.TimestampType):
            days = _fdiv(days, US_PER_DAY)
        return Column(self._field(days).to(torch.int32), c.validity, T.INT)


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


@dataclasses.dataclass(repr=False)
class _TimeField(Expression):
    """A field of a TIMESTAMP's time of day (floor-mod, so instants
    before the epoch count from their own midnight)."""

    child: Expression

    divisor = US_PER_HOUR
    modulus = 24

    @property
    def dtype(self) -> T.DataType:
        return T.INT

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = self.child.eval(ctx)
        day_us = torch.remainder(c.data.to(torch.int64), US_PER_DAY)
        out = torch.remainder(_fdiv(day_us, self.divisor), self.modulus)
        return Column(out.to(torch.int32), c.validity, T.INT)


class Hour(_TimeField):
    divisor = US_PER_HOUR
    modulus = 24


class Minute(_TimeField):
    divisor = US_PER_MINUTE
    modulus = 60


class Second(_TimeField):
    divisor = US_PER_SECOND
    modulus = 60


@dataclasses.dataclass(repr=False)
class UnixTimestampFromTs(Expression):
    """to_unix_timestamp(timestamp) -> LONG seconds (floored)."""

    child: Expression

    @property
    def dtype(self) -> T.DataType:
        return T.LONG

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = self.child.eval(ctx)
        return Column(_fdiv(c.data.to(torch.int64), US_PER_SECOND),
                      c.validity, T.LONG)


#: the formats formatted on the device, as in the JAX package; any
#: other is refused by ``check_supported`` and runs on the CPU engine
SUPPORTED_FORMATS = ("yyyy-MM-dd HH:mm:ss", "yyyy-MM-dd")


def _format_chars(days: torch.Tensor, sec_of_day: torch.Tensor,
                  fmt: str) -> tuple[torch.Tensor, int]:
    """Civil fields formatted into an ``(N, len(fmt))`` byte matrix: each
    pattern token a run of digits, any other character itself."""
    y, m, d = civil_from_days(days)
    fields = {
        "yyyy": (y, 4), "MM": (m, 2), "dd": (d, 2),
        "HH": (_fdiv(sec_of_day, 3600), 2),
        "mm": (torch.remainder(_fdiv(sec_of_day, 60), 60), 2),
        "ss": (torch.remainder(sec_of_day, 60), 2),
    }
    n = days.shape[0]
    cols: list[torch.Tensor] = []
    i = 0
    while i < len(fmt):
        for token, (val, nd) in fields.items():
            if fmt.startswith(token, i):
                for k in range(nd):
                    cols.append(torch.remainder(
                        _fdiv(val, 10 ** (nd - 1 - k)), 10) + 48)
                i += len(token)
                break
        else:
            cols.append(torch.full((n,), ord(fmt[i]), dtype=torch.int64,
                                   device=days.device))
            i += 1
    chars = torch.stack(cols, dim=1).to(torch.uint8)
    return chars, len(cols)


def _formatted(days, sod, fmt: str, validity: torch.Tensor) -> StringColumn:
    chars, width = _format_chars(days, sod, fmt)
    chars = chars * validity[:, None].to(torch.uint8)
    lengths = torch.where(validity, width, 0).to(torch.int32)
    return StringColumn(chars, lengths, validity)


@dataclasses.dataclass(repr=False)
class FromUnixTime(Expression):
    """from_unixtime(seconds, fmt) -> the UTC instant formatted."""

    child: Expression
    fmt: str = "yyyy-MM-dd HH:mm:ss"

    @property
    def dtype(self) -> T.DataType:
        return T.STRING

    def check_supported(self) -> None:
        if self.fmt not in SUPPORTED_FORMATS:
            raise TypeError(
                f"from_unixtime format {self.fmt!r} not supported "
                f"(supported: {', '.join(SUPPORTED_FORMATS)})")

    def eval(self, ctx: EvalContext) -> AnyColumn:
        self.check_supported()
        c = self.child.eval(ctx)
        secs = c.data.to(torch.int64)
        days = _fdiv(secs, 86400)
        return _formatted(days, secs - days * 86400, self.fmt, c.validity)


@dataclasses.dataclass(repr=False)
class DateFormatClass(Expression):
    """date_format(date or timestamp, fmt) -> the UTC value formatted."""

    child: Expression
    fmt: str = "yyyy-MM-dd"

    @property
    def dtype(self) -> T.DataType:
        return T.STRING

    def check_supported(self) -> None:
        if self.fmt not in SUPPORTED_FORMATS:
            raise TypeError(
                f"date_format format {self.fmt!r} not supported "
                f"(supported: {', '.join(SUPPORTED_FORMATS)})")
        if not isinstance(self.child.dtype, (T.DateType, T.TimestampType)):
            raise TypeError("date_format needs a date/timestamp input")

    def eval(self, ctx: EvalContext) -> AnyColumn:
        self.check_supported()
        c = self.child.eval(ctx)
        v = c.data.to(torch.int64)
        if isinstance(self.child.dtype, T.DateType):
            days, sod = v, torch.zeros_like(v)
        else:
            days = _fdiv(v, US_PER_DAY)
            sod = _fdiv(v - days * US_PER_DAY, US_PER_SECOND)
        return _formatted(days, sod, self.fmt, c.validity)


@dataclasses.dataclass
class CalendarInterval:
    """A literal calendar interval (months, days, microseconds), the
    value ``TimeAdd`` / ``DateAddInterval`` take."""

    months: int = 0
    days: int = 0
    microseconds: int = 0


@dataclasses.dataclass(repr=False)
class TimeAdd(Expression):
    """timestamp + interval.  A month component depends on the calendar
    and is refused (the planner runs it on the CPU engine)."""

    child: Expression
    interval: CalendarInterval
    _sign = 1

    @property
    def dtype(self) -> T.DataType:
        return T.TIMESTAMP

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    @property
    def name(self) -> str:
        iv = self.interval
        return (f"{self.child.name} + interval({iv.months}m "
                f"{iv.days}d {iv.microseconds}us)")

    def check_supported(self) -> None:
        if not isinstance(self.child.dtype, T.TimestampType):
            raise TypeError("TimeAdd needs a timestamp input")
        if self.interval.months:
            raise TypeError(
                "interval months are calendar-dependent — CPU fallback "
                "(the reference rejects them too)")

    def eval(self, ctx: EvalContext) -> AnyColumn:
        self.check_supported()
        c = self.child.eval(ctx)
        delta = (self.interval.days * US_PER_DAY
                 + self.interval.microseconds) * self._sign
        return Column(c.data.to(torch.int64) + delta, c.validity,
                      T.TIMESTAMP)


class TimeSub(TimeAdd):
    _sign = -1


@dataclasses.dataclass(repr=False)
class DateAddInterval(Expression):
    """date + interval -> DATE: whole days, the microseconds truncated
    toward zero to days; a month component is refused."""

    child: Expression
    interval: CalendarInterval

    @property
    def dtype(self) -> T.DataType:
        return T.DATE

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    @property
    def name(self) -> str:
        return f"{self.child.name} + interval({self.interval.days}d)"

    def check_supported(self) -> None:
        if not isinstance(self.child.dtype, T.DateType):
            raise TypeError("DateAddInterval needs a date input")
        if self.interval.months:
            raise TypeError("interval months fall back")

    def eval(self, ctx: EvalContext) -> AnyColumn:
        self.check_supported()
        c = self.child.eval(ctx)
        days = self.interval.days + int(
            self.interval.microseconds / US_PER_DAY)
        return Column(c.data.to(torch.int32) + days, c.validity, T.DATE)
