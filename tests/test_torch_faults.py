"""The five faults of the port that the re-anchor after the expression
long tail found (ROADMAP.md §3, F1-F5), each input of that list a case.

- F1: a column name given to ``group_by``, ``join(left_on=,
  right_on=)``, ``order_by``, ``select``, ``rollup`` or a ``Window`` is a
  column, not a string literal: each held against both JAX engines at 3,
  10 and 1 000 rows, ``order_by`` in order.
- F2: a DECIMAL compared with a LONG (or an INT past 18 digits) compares
  exactly, in <, =, <=>, BETWEEN and IN, on the device path and on the
  port's CPU engine, against the JAX CPU engine and Python's ``Decimal``;
  a join on DECIMAL = LONG pairs the rows Spark pairs; TPC-DS q48 over
  store_sales with DECIMAL(7,2) money equals the JAX CPU engine's 416.
- F3: an integral or DECIMAL cast to DATE is a day number, as both JAX
  engines give it (a LONG by its low 32 bits).
- F4: the DECIMAL and TIMESTAMP casts the JAX CPU engine runs, on the
  port's CPU engine: against the JAX engines where they follow Spark,
  against Spark's values (seconds; ``yyyy-MM-dd HH:mm:ss`` with the
  fraction's digits) where they do not (ROADMAP.md §3, divergences).
- F5: DECIMAL + - * with an integral operand on the CPU engine, against
  both JAX engines and ``Decimal``.
"""

import datetime as dt
import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.exprs import arithmetic as JA
from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs import predicates as JP
from spark_rapids_tpu.exprs.cast import Cast as JCast
from spark_rapids_tpu.exprs.window import Window as JWindow
from spark_rapids_tpu.exprs.window import row_number as jrow_number
from spark_rapids_tpu.frontends.sql import SqlSession as JSqlSession
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import sum_ as jsum

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession, tpcds
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.cpu.engine import execute_cpu
from spark_rapids_tpu_torch.exprs import arithmetic as A
from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs import predicates as P
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.window import Window, row_number
from spark_rapids_tpu_torch.frontends.sql import SqlSession
from spark_rapids_tpu_torch.session import col, sum_
from spark_rapids_tpu_torch.tpcds_queries import QUERIES
from test_torch_tpcds_texts import catalog  # noqa: F401

D = decimal.Decimal
UTC = dt.timezone.utc
TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"


@pytest.fixture(scope="module")
def sessions():
    return TorchSession(device="cpu"), TpuSession()


def _both_jax(jdf):
    return jdf.collect(engine="tpu"), jdf.collect(engine="cpu")


# ---------------------------------------------------------------------- #
# F1: names are columns
# ---------------------------------------------------------------------- #

def _names_table(n: int) -> pa.Table:
    rng = np.random.default_rng(n)
    return pa.table({
        "k": pa.array(rng.permutation(n).astype(np.int64)),
        "g": pa.array(rng.integers(0, 3, n).astype(np.int64)),
        "v": pa.array(rng.integers(-50, 50, n).astype(np.int64))})


def _keys_table(n: int) -> pa.Table:
    rng = np.random.default_rng(n + 1)
    return pa.table({
        "k2": pa.array(rng.integers(0, max(n // 2, 1), n).astype(np.int64)),
        "w": pa.array(rng.integers(0, 100, n).astype(np.int64))})


#: (the port's query, the JAX query, whether order matters)
F1_CASES = {
    "group_by": (
        lambda df, _o: df.group_by("g").agg((sum_(col("v")), "s")),
        lambda df, _o: df.group_by("g").agg((jsum(jcol("v")), "s")),
        False),
    "join_left_on": (
        lambda df, o: df.join(o, left_on=["k"], right_on=["k2"]),
        lambda df, o: df.join(o, left_on=["k"], right_on=["k2"]),
        False),
    "order_by_desc": (
        lambda df, _o: df.order_by("k", desc=True),
        lambda df, _o: df.order_by("k", desc=True),
        True),
    "select": (
        lambda df, _o: df.select("v", "k"),
        lambda df, _o: df.select("v", "k"),
        False),
    "rollup": (
        lambda df, _o: df.rollup("g").agg((sum_(col("v")), "s")),
        lambda df, _o: df.rollup("g").agg((jsum(jcol("v")), "s")),
        False),
    "window": (
        lambda df, _o: df.select("k", row_number().over(
            Window.partition_by("g").order_by("k")).alias("rn")),
        lambda df, _o: df.select("k", jrow_number().over(
            JWindow.partition_by("g").order_by("k")).alias("rn")),
        False),
}


@pytest.mark.parametrize("n", [3, 10, 1000])
@pytest.mark.parametrize("case", list(F1_CASES))
def test_f1_a_name_is_a_column(sessions, case, n):
    ps, js = sessions
    port_q, jax_q, ordered = F1_CASES[case]
    t, o = _names_table(n), _keys_table(n)
    got = port_q(ps.create_dataframe(t), ps.create_dataframe(o)).collect()
    for want in _both_jax(jax_q(js.create_dataframe(t),
                                js.create_dataframe(o))):
        assert_tables_equal(got, want, ignore_order=not ordered)
    if case == "order_by_desc":
        assert got.column("k").to_pylist() == list(range(n - 1, -1, -1))
    if case == "group_by":
        assert got.num_rows == len(set(t.column("g").to_pylist()))


# ---------------------------------------------------------------------- #
# F2: DECIMAL against LONG, exactly
# ---------------------------------------------------------------------- #

F2_DECIMALS = ["67.60", "9.09", "-6.26", "3.00", "1.00", None, "100.00",
               "-100.01", "0.00", "99999.99"]
F2_LONGS = [100, 9, -7, 3, 1, 5, None, 2 ** 62, -(2 ** 62), 99999]
F2_INTS = [100, 9, -7, 3, 1, 5, None, 2 ** 31 - 1, -(2 ** 31), 99999]


def _f2_table() -> pa.Table:
    return pa.table({
        "d": pa.array([None if v is None else D(v) for v in F2_DECIMALS],
                      pa.decimal128(7, 2)),
        "w": pa.array([None if v is None else D(v).scaleb(-7).quantize(
            D("1e-9")) for v in F2_DECIMALS], pa.decimal128(18, 9)),
        "l": pa.array(F2_LONGS, pa.int64()),
        "i": pa.array(F2_INTS, pa.int32())})


#: case -> (a builder over a namespace, the Python predicate over a row)
F2_CASES = {
    "d_gt_100": (lambda ns: ns.P.GreaterThan(ns.col("d"),
                                             ns.Literal(100, ns.LONG)),
                 lambda r: r["d"] > 100),
    "d_between_-10_10": (
        lambda ns: ns.P.And(
            ns.P.GreaterThanOrEqual(ns.col("d"), ns.Literal(-10, ns.LONG)),
            ns.P.LessThanOrEqual(ns.col("d"), ns.Literal(10, ns.LONG))),
        lambda r: -10 <= r["d"] <= 10),
    "d_eq_3": (lambda ns: ns.P.EqualTo(ns.col("d"), ns.Literal(3, ns.LONG)),
               lambda r: r["d"] == 3),
    "d_lt_l": (lambda ns: ns.P.LessThan(ns.col("d"), ns.col("l")),
               lambda r: r["d"] < r["l"]),
    "l_le_d": (lambda ns: ns.P.LessThanOrEqual(ns.col("l"), ns.col("d")),
               lambda r: r["l"] <= r["d"]),
    "d_eq_l": (lambda ns: ns.P.EqualTo(ns.col("d"), ns.col("l")),
               lambda r: r["d"] == r["l"]),
    "l_gt_d": (lambda ns: ns.P.GreaterThan(ns.col("l"), ns.col("d")),
               lambda r: r["l"] > r["d"]),
    "w_ge_i": (lambda ns: ns.P.GreaterThanOrEqual(ns.col("w"), ns.col("i")),
               lambda r: r["w"] >= r["i"]),
}


def case_text(case: str) -> str:
    """The columns a case reads, from its name."""
    return " ".join(f'"{c}"' for c in case.split("_") if len(c) == 1)


class _NS:
    def __init__(self, P_, col_, Literal, LONG):
        self.P, self.col, self.Literal, self.LONG = P_, col_, Literal, LONG


PORT_NS = _NS(P, B.col, B.Literal, T.LONG)
JAX_NS = _NS(JP, JB.ColumnReference, JB.Literal, JT.LONG)


@pytest.mark.parametrize("case", list(F2_CASES))
def test_f2_decimal_against_long_compares_exactly(sessions, case):
    ps, js = sessions
    build, pred = F2_CASES[case]
    t = _f2_table()
    df = ps.create_dataframe(t).select(build(PORT_NS).alias("c"))
    got = df.collect()
    on_cpu = execute_cpu(df._plan)
    want = js.create_dataframe(t).select(
        build(JAX_NS).alias("c")).collect(engine="cpu")
    assert_tables_equal(got, want, ignore_order=False)
    assert_tables_equal(on_cpu, want, ignore_order=False)
    reads = [n for n in ("d", "w", "l", "i") if f'"{n}"' in case_text(case)]
    py = [None if any(r[n] is None for n in reads) else pred(r)
          for r in t.to_pylist()]
    assert got.column("c").to_pylist() == py


def test_f2_equal_null_safe_and_in(sessions):
    ps, js = sessions
    t = _f2_table()
    port = [P.EqualNullSafe(col("d"), col("l")).alias("ns"),
            P.In(col("d"), (3, 100, 2 ** 62)).alias("d_in"),
            P.In(col("l"), (D("3.00"), D("9.09"), D("99999"))).alias("l_in")]
    jax = [JP.EqualNullSafe(jcol("d"), jcol("l")).alias("ns"),
           JP.In(jcol("d"), (3, 100)).alias("d_in"),
           JP.In(jcol("l"), (D("3.00"), D("9.09"), D("99999"))).alias("l_in")]
    df = ps.create_dataframe(t).select(*port)
    got = df.collect()
    # the JAX CPU engine cannot scale 2^62 to the decimal's scale
    # (ArrowInvalid): it answers without it, which matches no row here
    want = js.create_dataframe(t).select(*jax[:2]).collect(engine="cpu")
    assert_tables_equal(got.select(["ns", "d_in"]), want, ignore_order=False)
    on_cpu = execute_cpu(df._plan)
    assert_tables_equal(on_cpu.select(["ns", "d_in"]), want,
                        ignore_order=False)
    assert on_cpu.column("l_in").to_pylist() == got.column("l_in").to_pylist()
    rows = t.to_pylist()
    assert got.column("ns").to_pylist() == [
        (r["d"] is None and r["l"] is None)
        or (None not in (r["d"], r["l"]) and r["d"] == r["l"]) for r in rows]
    assert got.column("d_in").to_pylist() == [
        None if r["d"] is None else r["d"] in (3, 100, 2 ** 62) for r in rows]
    assert got.column("l_in").to_pylist() == [
        None if r["l"] is None else r["l"] in (3, 99999) for r in rows]


@pytest.mark.parametrize("how", ["inner", "left_outer", "left_anti"])
def test_f2_join_on_decimal_equals_long(sessions, how):
    """Spark pairs a DECIMAL(7,2) key with a LONG key by value; the JAX
    CPU engine cannot join keys of two types, so the reference is
    Python's."""
    ps, _ = sessions
    dec = pa.table({"d": pa.array([D(v) for v in ("3.00", "3.50", "1.00",
                                                  "-6.00", "7.01")]
                                  + [None], pa.decimal128(7, 2)),
                    "a": pa.array(range(6), pa.int64())})
    lng = pa.table({"l": pa.array([3, 1, 1, -6, 7, 2 ** 62], pa.int64()),
                    "b": pa.array(range(10, 16), pa.int64())})
    df = ps.create_dataframe(dec).join(ps.create_dataframe(lng),
                                       left_on=["d"], right_on=["l"], how=how)
    got = df.collect()
    rows = []
    for r in dec.to_pylist():
        hits = [s for s in lng.to_pylist()
                if r["d"] is not None and r["d"] == s["l"]]
        if how == "left_anti":
            rows += [] if hits else [dict(r)]
        elif hits:
            rows += [{**r, **s} for s in hits]
        elif how == "left_outer":
            rows.append({**r, "l": None, "b": None})
    want = pa.Table.from_pylist(rows, schema=got.schema)
    assert_tables_equal(got, want)
    assert_tables_equal(execute_cpu(df._plan), want)
    if how == "inner":
        assert got.num_rows == 4  # 3 = 3, 1 = 1 twice, -6 = -6


@pytest.fixture(scope="module")
def q48_frontends(tmp_path_factory, catalog):  # noqa: F811
    """The JAX sweep's SF1 catalog (seed 7) with store_sales' money
    columns DECIMAL(7,2), as the spec types them."""
    ss = catalog["store_sales"]
    for name in tpcds.MONEY_COLUMNS:
        i = ss.schema.get_field_index(name)
        ss = ss.set_column(i, pa.field(name, tpcds.MONEY_TYPE),
                           tpcds.cents(ss.column(name)))
    d = tmp_path_factory.mktemp("q48")
    port = SqlSession({TTB: 1}, device="cpu")
    jax = JSqlSession()
    for name in tpcds.STORE_CHANNEL_TABLES:
        t = ss if name == "store_sales" else catalog[name]
        jax.register_table(name, t)
        path = str(d / f"{name}.parquet")
        pq.write_table(t, path, store_decimal_as_integer=True)
        port.register_parquet(name, path)
    return port, jax


def test_f2_q48_over_decimal_money_equals_the_jax_cpu_engine(q48_frontends):
    port, jax = q48_frontends
    got = port.sql(QUERIES[48]).collect()
    want = jax.sql(QUERIES[48]).collect(engine="cpu")
    assert_tables_equal(got, want)
    assert got.column(0).to_pylist() == [416]


# ---------------------------------------------------------------------- #
# F3 and F4: casts on the port's CPU engine
# ---------------------------------------------------------------------- #

def _cast_table() -> pa.Table:
    return pa.table({
        "d": pa.array([D("1.50"), D("-6.26"), D("67.60"), None, D("3.00"),
                       D("-0.01")], pa.decimal128(7, 2)),
        "b": pa.array([1, -2, 3, None, 127, -128], pa.int8()),
        "sh": pa.array([1, -2, 3, None, 300, -32768], pa.int16()),
        "i": pa.array([1, -70000, 3, None, 2 ** 20, -1], pa.int32()),
        "l": pa.array([1, -70000, 3, None, 2 ** 40, 2 ** 40 + 5], pa.int64()),
        "f": pa.array([1.5, -2.25, float("nan"), None, 1e9, float("inf")],
                      pa.float32()),
        "x": pa.array([1.5, -2.25, float("inf"), None, 1e9, -1e-7],
                      pa.float64()),
        "ts": pa.array([dt.datetime(2000, 1, 1, 12, 30, 0),
                        dt.datetime(1969, 12, 31, 23, 59, 59, 500000),
                        dt.datetime(1970, 1, 1), None,
                        dt.datetime(2000, 1, 1, 12, 30, 0, 123450),
                        dt.datetime(2038, 1, 19, 3, 14, 8)],
                       pa.timestamp("us", tz="UTC")),
        "s": pa.array(["1.5", " 2e3 ", "abc", None, "-0.25", "1e39"])})


PORT_TYPES = {"string": T.STRING, "int": T.INT, "long": T.LONG,
              "date": T.DATE, "timestamp": T.TIMESTAMP,
              "boolean": T.BOOLEAN, "tinyint": T.BYTE, "smallint": T.SHORT,
              "float": T.FLOAT, "double": T.DOUBLE}
JAX_TYPES = {"string": JT.STRING, "int": JT.INT, "long": JT.LONG,
             "date": JT.DATE, "timestamp": JT.TIMESTAMP,
             "boolean": JT.BOOLEAN, "tinyint": JT.BYTE, "smallint": JT.SHORT,
             "float": JT.FLOAT, "double": JT.DOUBLE}


def _ts(secs_or_us, unit="s"):
    if secs_or_us is None:
        return None
    us = secs_or_us * 1_000_000 if unit == "s" else secs_or_us
    return dt.datetime(1970, 1, 1, tzinfo=UTC) + dt.timedelta(microseconds=us)


def _epoch_us(v):
    return None if v is None else int(
        (v - dt.datetime(1970, 1, 1, tzinfo=UTC)) / dt.timedelta(
            microseconds=1))


def _spark_ts_to_string(v):
    if v is None:
        return None
    s = v.strftime("%Y-%m-%d %H:%M:%S")
    return s + (f".{v.microsecond:06d}".rstrip("0") if v.microsecond else "")


def _wrap(v, bits):
    if v is None:
        return None
    return (v + 2 ** (bits - 1)) % 2 ** bits - 2 ** (bits - 1)


def _spark_double_to_ts(v):
    if v is None or v != v or v in (float("inf"), float("-inf")):
        return None
    return _ts(int(v * 1e6), unit="us")


#: (source column, target type) -> Spark's values, where the JAX CPU
#: engine departs from them; the other pairs are held against JAX
SPARK_VALUES = {
    ("d", "timestamp"): lambda t: [
        None if v is None else _ts(int(v * 1_000_000), unit="us")
        for v in t.column("d").to_pylist()],
    ("ts", "string"): lambda t: [_spark_ts_to_string(v)
                                 for v in t.column("ts").to_pylist()],
    ("ts", "tinyint"): lambda t: [
        None if v is None else _wrap(_epoch_us(v) // 1_000_000, 8)
        for v in t.column("ts").to_pylist()],
    ("ts", "smallint"): lambda t: [
        None if v is None else _wrap(_epoch_us(v) // 1_000_000, 16)
        for v in t.column("ts").to_pylist()],
    ("ts", "int"): lambda t: [
        None if v is None else _wrap(_epoch_us(v) // 1_000_000, 32)
        for v in t.column("ts").to_pylist()],
    ("ts", "float"): lambda t: [
        None if v is None else float(np.float32(_epoch_us(v) / 1e6))
        for v in t.column("ts").to_pylist()],
    ("ts", "double"): lambda t: [
        None if v is None else _epoch_us(v) / 1e6
        for v in t.column("ts").to_pylist()],
    ("b", "timestamp"): lambda t: [_ts(v) for v in t.column("b").to_pylist()],
    ("sh", "timestamp"): lambda t: [_ts(v)
                                    for v in t.column("sh").to_pylist()],
    ("i", "timestamp"): lambda t: [_ts(v) for v in t.column("i").to_pylist()],
    ("f", "timestamp"): lambda t: [
        _spark_double_to_ts(None if v is None else float(v))
        for v in t.column("f").to_pylist()],
    ("x", "timestamp"): lambda t: [_spark_double_to_ts(v)
                                   for v in t.column("x").to_pylist()],
}

#: pairs held against both JAX engines
JAX_PAIRS = [("d", "string"), ("d", "int"), ("d", "long"), ("d", "date"),
             ("ts", "boolean"), ("s", "float"), ("i", "date"),
             ("l", "date"), ("b", "date"), ("sh", "date")]


def _port_cast(ps, t, c, to):
    df = ps.create_dataframe(t).select(Cast(col(c), PORT_TYPES[to])
                                       .alias("o"))
    return df


@pytest.mark.parametrize("pair", JAX_PAIRS, ids=lambda p: "->".join(p))
def test_f3_f4_cast_equals_the_jax_engines(sessions, pair):
    ps, js = sessions
    c, to = pair
    t = _cast_table()
    df = _port_cast(ps, t, c, to)
    got = df.collect()
    want = _both_jax(js.create_dataframe(t).select(
        JCast(jcol(c), JAX_TYPES[to]).alias("o")))
    for w in want:
        assert_tables_equal(got, w, ignore_order=False)
    assert_tables_equal(execute_cpu(df._plan), want[1], ignore_order=False)
    if (c, to) == ("l", "date"):  # the low 32 bits: 2^40 is day 0
        assert got.column("o").to_pylist()[4:] == [
            dt.date(1970, 1, 1), dt.date(1970, 1, 6)]
    if (c, to) == ("i", "date"):
        assert got.column("o").to_pylist()[:2] == [
            dt.date(1970, 1, 2), dt.date(1778, 5, 7)]


@pytest.mark.parametrize("pair", list(SPARK_VALUES),
                         ids=lambda p: "->".join(p))
def test_f4_cast_follows_spark(sessions, pair):
    ps, _ = sessions
    c, to = pair
    t = _cast_table()
    df = _port_cast(ps, t, c, to)
    got = df.collect().column("o").to_pylist()
    want = SPARK_VALUES[pair](t)
    assert got == want
    assert execute_cpu(df._plan).column("o").to_pylist() == want
    if pair == ("ts", "string"):
        assert got[:2] == ["2000-01-01 12:30:00", "1969-12-31 23:59:59.5"]


# ---------------------------------------------------------------------- #
# F5: DECIMAL arithmetic with an integral operand
# ---------------------------------------------------------------------- #

def _f5_table() -> pa.Table:
    return pa.table({
        "dd": pa.array([D(v) if v else None for v in
                        ("1.00", "3.00", "-2.50", None, "99999.99")],
                       pa.decimal128(7, 2)),
        "i": pa.array([1, 3, 4, 5, -2], pa.int32()),
        "b": pa.array([2, None, -3, 1, 7], pa.int8()),
        "sh": pa.array([10, 3, -300, 1, 2], pa.int16())})


F5_CASES = {
    "dd_plus_i": (lambda ns: ns.A.Add(ns.col("dd"), ns.col("i")),
                  lambda r: r["dd"] + r["i"]),
    "dd_times_i": (lambda ns: ns.A.Multiply(ns.col("dd"), ns.col("i")),
                   lambda r: r["dd"] * r["i"]),
    "dd_times_b": (lambda ns: ns.A.Multiply(ns.col("dd"), ns.col("b")),
                   lambda r: r["dd"] * r["b"]),
    "sh_minus_dd": (lambda ns: ns.A.Subtract(ns.col("sh"), ns.col("dd")),
                    lambda r: r["sh"] - r["dd"]),
}


class _ArithNS:
    def __init__(self, A_, col_):
        self.A, self.col = A_, col_


@pytest.mark.parametrize("case", list(F5_CASES))
def test_f5_decimal_arithmetic_with_an_integral_operand(sessions, case):
    ps, js = sessions
    build, py = F5_CASES[case]
    t = _f5_table()
    expr = build(_ArithNS(A, B.col))
    df = ps.create_dataframe(t).select(expr.alias("o"))
    got = df.collect()
    want = _both_jax(js.create_dataframe(t).select(
        build(_ArithNS(JA, JB.ColumnReference)).alias("o")))
    for w in want:
        assert_tables_equal(got, w, ignore_order=False)
    assert_tables_equal(execute_cpu(df._plan), want[1], ignore_order=False)
    # NULL past the result type's precision (DECIMAL(7,2) * TINYINT is
    # DECIMAL(7,2) in both packages, ROADMAP.md §3)
    rt = got.schema.field("o").type
    vals = [None if None in r.values() or abs(py(r)) >= D(10) ** (
        rt.precision - rt.scale) else py(r)
        for r in t.select(case.split("_")[::2]).to_pylist()]
    assert got.column("o").to_pylist() == vals
    assert isinstance(got.schema.field("o").type, pa.Decimal128Type)


# ---------------------------------------------------------------------- #
# F6: a new TorchSession closed every other session's store
# ---------------------------------------------------------------------- #

def _f6_table(n: int = 3000) -> pa.Table:
    rng = np.random.default_rng(66)
    return pa.table({"k": pa.array(rng.integers(0, 40, n), pa.int64()),
                     "v": pa.array(rng.integers(-500, 500, n), pa.int64())})


def _f6_jax(t: pa.Table) -> pa.Table:
    return TpuSession().create_dataframe(t).group_by(jcol("k")).agg(
        (jsum(jcol("v")), "s")).collect(engine="tpu")


def test_f6_a_cached_frame_survives_another_sessions_creation():
    """Session A caches a frame and aggregates it; making session B
    leaves A's store entries where they were, and A's next collect over
    the cached frame equals the JAX package's result (it raised
    KeyError when every TorchSession installed a new store)."""
    t = _f6_table()
    a = TorchSession(device="cpu")
    before = len(a.store._entries)
    cached = a.create_dataframe(t).cache()
    agg = cached.group_by(col("k")).agg((sum_(col("v")), "s"))
    first = agg.collect()
    entries = len(a.store._entries)
    assert entries > before and cached._plan.slot.filled
    b = TorchSession(device="cpu")
    assert len(a.store._entries) == entries
    again = agg.collect()
    assert again.equals(first)
    assert_tables_equal(again, _f6_jax(t))
    assert b.store is a.store and b.semaphore is a.semaphore
    cached.unpersist()
    assert len(a.store._entries) == before


def test_f6_a_collect_while_another_session_is_made():
    """Session B is made in the middle of A's collect, between the map
    stage that parks A's exchange blocks in the store and the reduce
    tasks that read them (a UDF of A's projection makes B): A's result
    equals the JAX package's."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.udf import torch_udf

    made = []

    @torch_udf(T.LONG)
    def make_a_session(v):
        if not made:
            made.append(TorchSession(device="cpu"))
        return v

    t = _f6_table()
    a = TorchSession({**C.SERIAL, C.BATCH_ROWS: 512}, device="cpu")
    df = a.create_dataframe(t).group_by(col("k")).agg(
        (sum_(col("v")), "s0")).select(
        col("k"), make_a_session(col("s0")).alias("s"))
    got = df.collect()
    assert made and made[0].store is a.store
    assert_tables_equal(got, _f6_jax(t))
    assert a.store.leak_report() == []


def test_f6_one_semaphore_with_the_jax_owner_rules():
    """Every session shares the process semaphore; a conf asking for a
    non-default size resizes it and owns it, a conf carrying the
    default never moves it back, and the owner does."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore

    TpuSemaphore.reset()
    a = TorchSession(device="cpu")
    owner = C.TorchConf({C.CONCURRENT_TASKS: 5})
    b = TorchSession(owner, device="cpu")
    sem = a.semaphore
    assert b.semaphore is sem and sem.permits == 2
    TpuSemaphore.sync_conf(owner)
    assert sem.permits == 5
    TpuSemaphore.sync_conf(a.conf)
    assert TpuSemaphore.get() is sem and sem.permits == 5
    owner.set(C.CONCURRENT_TASKS, 2)
    TpuSemaphore.sync_conf(owner)
    assert sem.permits == 2
    TpuSemaphore.reset()


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
