"""The port's TIMESTAMP expressions against the JAX package's, against
Python's calendar, and the SQL frontend's datetime constructs against
the JAX frontend's.

- Expressions: every datetime class the port has over TIMESTAMP inputs
  (the date fields, hour / minute / second, ``to_unix_timestamp``,
  ``from_unixtime`` and ``date_format`` in both device formats,
  timestamp and date plus an interval), and the casts between DATE,
  TIMESTAMP and LONG, evaluated by both packages on one batch
  (``tests/torch_jax_eval.py``) over the inputs of the JAX package's
  ``tests/test_expr_batch5.py`` and ``test_expr_batch6.py`` and
  numpy-seeded instants over 1900-2100 with instants before 1970, leap
  days, month ends and NULLs.  Equal exactly (integer arithmetic).
- A month interval and a format the device refuses run on the CPU
  engine (``explain()`` marks the node), with Python's answer and the
  JAX package's.
- The SQL frontend accepts and rejects the constructs the JAX frontend
  accepts and rejects, with the same error class.
"""

import datetime as dt
import types

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs import datetime as JDT
from spark_rapids_tpu.exprs.cast import Cast as JCast
from spark_rapids_tpu.frontends import sql as JSQL
from spark_rapids_tpu.session import TpuSession

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs import datetime as DT
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.frontends import sql as SQL
from torch_jax_eval import jax_eval, port_eval

UTC = dt.timezone.utc
EPOCH = dt.datetime(1970, 1, 1, tzinfo=UTC)
EDGES = [dt.datetime(1969, 12, 31, 23, 59, 59, 999999, tzinfo=UTC),
         dt.datetime(1970, 1, 1, tzinfo=UTC),
         dt.datetime(1900, 2, 28, 23, 0, tzinfo=UTC),
         dt.datetime(1900, 3, 1, 0, 0, 1, tzinfo=UTC),
         dt.datetime(1904, 2, 29, 12, 34, 56, 789, tzinfo=UTC),
         dt.datetime(1955, 1, 31, 1, 2, 3, tzinfo=UTC),
         dt.datetime(2000, 2, 29, 23, 59, 59, tzinfo=UTC),
         dt.datetime(2000, 12, 31, 23, 59, 59, 999999, tzinfo=UTC),
         dt.datetime(2004, 2, 29, tzinfo=UTC),
         dt.datetime(2020, 9, 13, 12, 26, 40, tzinfo=UTC),
         dt.datetime(2100, 2, 28, 6, 0, tzinfo=UTC)]
#: from_unixtime's inputs in JAX test_expr_batch5.py, and more
SECONDS = [0, 86399, 86400, 1_600_000_000, -1, -2, -86400, -86401,
           -123456789]
US = 1_000_000


def _us(t: dt.datetime) -> int:
    d = t - EPOCH
    return d.days * 86_400 * US + d.seconds * US + d.microseconds


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(17)
    n = 300
    lo = _us(dt.datetime(1900, 1, 2, tzinfo=UTC))
    hi = _us(dt.datetime(2100, 1, 1, tzinfo=UTC))
    ts = np.concatenate([rng.integers(lo, hi, n - len(EDGES)),
                         [_us(t) for t in EDGES]]).astype(np.int64)
    # JAX test_expr_batch6.py's TimeAdd inputs: [0, 2^45)
    ts[:40] = rng.integers(0, 2 ** 45, 40)
    secs = np.concatenate([rng.integers(-4_000_000_000, 4_000_000_000,
                                        n - len(SECONDS)), SECONDS])
    days = rng.integers(-25_000, 47_000, n).astype(np.int32)
    days[:3] = [0, 18262, 11016]  # JAX batch5's dates, and 2000-02-29
    return pa.table({
        "t": pa.array(ts, pa.timestamp("us", tz="UTC"),
                      mask=rng.random(n) < 0.1),
        "s": pa.array(secs.astype(np.int64), mask=rng.random(n) < 0.1),
        "d": pa.array(days, pa.int32(),
                      mask=rng.random(n) < 0.1).cast(pa.date32()),
    })


JAX = types.SimpleNamespace(DT=JDT, T=JT, col=JB.ColumnReference,
                            Cast=JCast)
PORT = types.SimpleNamespace(DT=DT, T=T, col=B.col, Cast=Cast)
FORMATS = ("yyyy-MM-dd HH:mm:ss", "yyyy-MM-dd")


def _cases(ns):
    D, c = ns.DT, ns.col
    t, s, d = c("t"), c("s"), c("d")
    iv = D.CalendarInterval(days=3, microseconds=5_000_000)
    back = D.CalendarInterval(days=-45, microseconds=-1)
    return {
        "year": D.Year(t), "month": D.Month(t), "day": D.DayOfMonth(t),
        "quarter": D.Quarter(t), "dayofweek": D.DayOfWeek(t),
        "weekday": D.WeekDay(t), "dayofyear": D.DayOfYear(t),
        "hour": D.Hour(t), "minute": D.Minute(t), "second": D.Second(t),
        "unix_ts": D.UnixTimestampFromTs(t),
        **{f"from_unixtime {f}": D.FromUnixTime(s, f) for f in FORMATS},
        **{f"date_format date {f}": D.DateFormatClass(d, f)
           for f in FORMATS},
        **{f"date_format ts {f}": D.DateFormatClass(t, f)
           for f in FORMATS},
        "time_add": D.TimeAdd(t, iv), "time_sub": D.TimeSub(t, iv),
        "time_add_back": D.TimeAdd(t, back),
        "date_add_interval": D.DateAddInterval(
            d, D.CalendarInterval(days=-45)),
        "date_add_interval_us": D.DateAddInterval(
            d, D.CalendarInterval(days=2, microseconds=3 * 86_400 * US + 5)),
        "ts_to_date": ns.Cast(t, ns.T.DATE),
        "date_to_ts": ns.Cast(d, ns.T.TIMESTAMP),
        "ts_to_long": ns.Cast(t, ns.T.LONG),
        "long_to_ts": ns.Cast(s, ns.T.TIMESTAMP),
        "hour_of_day_ts": D.Hour(ns.Cast(d, ns.T.TIMESTAMP)),
    }


@pytest.mark.parametrize("name", list(_cases(PORT)))
def test_expression_equals_jax(table, name):
    got = port_eval(table, [_cases(PORT)[name]])
    want = jax_eval(table, [_cases(JAX)[name]])
    assert got.equals(want), (name, got.column(0)[:8], want.column(0)[:8])


def test_fields_and_formats_equal_python(table):
    vals = table["t"].to_pylist()
    got = port_eval(table, [DT.Hour(B.col("t")), DT.Minute(B.col("t")),
                            DT.Second(B.col("t")),
                            DT.DateFormatClass(B.col("t"), FORMATS[0]),
                            DT.Year(B.col("t")), DT.DayOfYear(B.col("t")),
                            DT.UnixTimestampFromTs(B.col("t"))])
    for i, v in enumerate(vals):
        row = [got.column(k)[i].as_py() for k in range(7)]
        if v is None:
            assert row == [None] * 7
            continue
        assert row == [v.hour, v.minute, v.second,
                       v.strftime("%Y-%m-%d %H:%M:%S"), v.year,
                       v.timetuple().tm_yday, _us(v) // US], (v, row)
    secs = table["s"].to_pylist()
    got = port_eval(table, [DT.FromUnixTime(B.col("s"))]).column(0)
    assert got.to_pylist() == [
        None if s is None else (EPOCH + dt.timedelta(seconds=s))
        .strftime("%Y-%m-%d %H:%M:%S") for s in secs]


def test_month_interval_and_other_formats_run_on_the_cpu_engine():
    jan31 = dt.datetime(2021, 1, 31, 12, 30, tzinfo=UTC)
    t = pa.table({"t": pa.array([jan31, EDGES[0], None],
                                pa.timestamp("us", tz="UTC")),
                  "d": pa.array([dt.date(2020, 1, 31), dt.date(1969, 12, 31),
                                 None])})
    port = TorchSession(device="cpu").create_dataframe(t)
    jax = TpuSession().create_dataframe(t)

    def both(make):
        p = port.select(*make(PORT))
        j = jax.select(*make(JAX))
        return p, j

    p, j = both(lambda ns: [
        ns.DT.TimeAdd(ns.col("t"), ns.DT.CalendarInterval(months=1))
        .alias("x"),
        ns.DT.DateAddInterval(ns.col("d"), ns.DT.CalendarInterval(months=1))
        .alias("y"),
        ns.DT.DateFormatClass(ns.col("t"), "yyyy-MM").alias("m")])
    assert "!" in p.explain() and "!" in j.explain()
    got = p.collect()
    assert_tables_equal(got, j.collect(engine="tpu"))
    assert got["x"][0].as_py() == dt.datetime(2021, 2, 28, 12, 30,
                                              tzinfo=UTC)
    assert got["y"][0].as_py() == dt.date(2020, 2, 29)
    assert got["m"].to_pylist() == ["2021-01", "1969-12", None]


@pytest.fixture(scope="module")
def frontends():
    rng = np.random.default_rng(3)
    n = 50
    t = pa.table({
        "ts": pa.array(rng.integers(-2 ** 48, 2 ** 50, n),
                       pa.timestamp("us", tz="UTC")),
        "b": pa.array(rng.integers(-5, 5, n).astype(np.int8)),
        "h": pa.array(rng.integers(-3, 3, n).astype(np.int16)),
        "f": pa.array(rng.integers(-2, 2, n).astype(np.float32) / 2),
        "l": pa.array(rng.integers(0, 10 ** 9, n)),
        "s": pa.array([f"2001-0{i % 9 + 1}-1{i % 9}" for i in range(n)]),
    })
    port, jax = SQL.SqlSession(device="cpu"), JSQL.SqlSession()
    port.register_table("t", t)
    jax.register_table("t", t)
    return port, jax


#: Motivation's construct list: what the JAX frontend accepts, then what
#: it rejects
CONSTRUCTS = [
    "select extract(hour from ts) as h from t",
    "select extract(minute from ts) as m, extract(second from ts) as s "
    "from t",
    "select cast(ts as date) as d from t",
    "select cast(b as decimal(5,2)) as d from t",
    "select b, h, f, count(*) as n from t group by b, h, f",
    "select hour(ts) from t",
    "select minute(ts) from t",
    "select date_format(ts, 'yyyy-MM') from t",
    "select unix_timestamp(ts) from t",
    "select from_unixtime(l) from t",
    "select timestamp '2001-01-01 00:00:00' from t",
    "select ts + interval '2' hour from t",
    "select cast(s as timestamp) from t",
]


def _outcome(fe, text, **kw):
    try:
        return fe.sql(text).collect(**kw), None
    except Exception as exc:  # the class is what is compared
        return None, type(exc).__name__


@pytest.mark.parametrize("text", CONSTRUCTS)
def test_frontend_accepts_and_rejects_as_the_jax_frontend(frontends, text):
    port, jax = frontends
    got, got_err = _outcome(port, text)
    want, want_err = _outcome(jax, text, engine="tpu")
    assert got_err == want_err
    if want is not None:
        assert_tables_equal(got, want)
