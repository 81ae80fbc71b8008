"""The port's DATE expressions against the JAX package's, and against
Python's calendar.

Inputs are numpy-seeded days over the spec's whole 1900-2100 calendar,
plus dates before 1970, the leap days and month ends around 1900, 2000
and 2100, and NULLs.  Every result must be equal exactly (all integer
arithmetic).  ``civil_from_days`` / ``days_from_civil`` must round-trip
every day of the calendar and agree with ``datetime.date``.
"""

import datetime as dt
import types

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs import datetime as JDT

from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs import datetime as DT
from torch_jax_eval import jax_eval, port_eval

EPOCH = dt.date(1970, 1, 1)
FIRST, LAST = dt.date(1900, 1, 2), dt.date(2100, 1, 1)
EDGES = [dt.date(1900, 1, 1), dt.date(1900, 2, 28), dt.date(1900, 3, 1),
         dt.date(1969, 12, 31), dt.date(1970, 1, 1), dt.date(2000, 1, 31),
         dt.date(2000, 2, 29), dt.date(2000, 12, 31), dt.date(2004, 2, 29),
         dt.date(2099, 12, 31), dt.date(2100, 2, 28), dt.date(2100, 3, 1),
         dt.date(1904, 2, 29), dt.date(1950, 6, 15)]

JAX = types.SimpleNamespace(DT=JDT, col=JB.ColumnReference, lit=JB.Literal.of)
PORT = types.SimpleNamespace(DT=DT, col=B.col, lit=B.Literal.of)


def _days(d: dt.date) -> int:
    return (d - EPOCH).days


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(5)
    n = 400
    days = np.concatenate([
        rng.integers(_days(FIRST), _days(LAST) + 1, n - len(EDGES)),
        [_days(d) for d in EDGES]]).astype(np.int32)
    mask = rng.random(n) < 0.1
    return pa.table({
        "d": pa.array(days, pa.int32(), mask=mask).cast(pa.date32()),
        "e": pa.array(rng.permutation(days), pa.int32()).cast(pa.date32()),
        "k": pa.array(rng.integers(-400, 400, n), pa.int64(),
                      mask=rng.random(n) < 0.1),
    })


def _cases(ns):
    D, c, lit = ns.DT, ns.col, ns.lit
    d, e, k = c("d"), c("e"), c("k")
    return {
        "fields": [D.Year(d), D.Month(d), D.DayOfMonth(d), D.Quarter(d),
                   D.DayOfWeek(d), D.WeekDay(d), D.DayOfYear(d)],
        "last_day": [D.LastDay(d), D.LastDay(e)],
        "add_months": [D.AddMonths(d, m) for m in (1, -1, 12, -13, 25, 0)],
        "date_add_sub_diff": [D.DateAdd(d, k), D.DateSub(d, k),
                              D.DateAdd(d, lit(30)), D.DateDiff(d, e),
                              D.DateDiff(e, d)],
    }


@pytest.mark.parametrize("case", list(_cases(PORT)))
def test_port_equals_the_jax_functions(case, table):
    got = port_eval(table, _cases(PORT)[case])
    want = jax_eval(table, _cases(JAX)[case])
    assert got.equals(want), (got.slice(0, 5).to_pylist(),
                              want.slice(0, 5).to_pylist())


def test_civil_conversions_round_trip_the_whole_calendar():
    days = torch.arange(_days(FIRST) - 1, _days(LAST) + 1)
    y, m, d = DT.civil_from_days(days)
    assert torch.equal(DT.days_from_civil(y, m, d).long(), days)
    py = [EPOCH + dt.timedelta(days=int(x)) for x in days[::97]]
    assert y[::97].tolist() == [p.year for p in py]
    assert m[::97].tolist() == [p.month for p in py]
    assert d[::97].tolist() == [p.day for p in py]


def test_fields_agree_with_python(table):
    got = port_eval(table, _cases(PORT)["fields"] + [
        DT.LastDay(B.col("d")), DT.AddMonths(B.col("d"), -1)])
    for i, day in enumerate(table.column("d").to_pylist()):
        row = [got.column(k)[i].as_py() for k in range(got.num_columns)]
        if day is None:
            assert row == [None] * got.num_columns
            continue
        y, m = day.year, day.month
        last = (dt.date(y + m // 12, m % 12 + 1, 1) - dt.timedelta(days=1))
        pm_y, pm_m = (y, m - 1) if m > 1 else (y - 1, 12)
        pm_last = (dt.date(pm_y + pm_m // 12, pm_m % 12 + 1, 1)
                   - dt.timedelta(days=1)).day
        assert row == [y, m, day.day, (m - 1) // 3 + 1,
                       day.isoweekday() % 7 + 1, day.weekday(),
                       day.timetuple().tm_yday, last,
                       dt.date(pm_y, pm_m, min(day.day, pm_last))]


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
