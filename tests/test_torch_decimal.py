"""DECIMAL(p <= 18, s) in the port against the JAX package.

- The seven cases of the JAX package's ``tests/test_decimal.py``
  (PromotePrecision, CheckOverflow's HALF_UP and its guard before
  scaling up, mismatched scales, results past precision 18 on the CPU
  engine) as cases of one test: the port on the CPU against both JAX
  engines and the values that file asserts.
- ``_DecimalAddSub``'s and ``Multiply``'s result types and refusals, and
  ``cast_supported`` over every pair of types, equal to the JAX
  package's (the port adds NULL to any type and DATE to STRING).
- Every supported cast, comparison, IN, CASE and COALESCE over columns
  of all the scalar types, evaluated by both packages on one batch.
- sum / min / max / first / last of a decimal, grouped (over an
  exchange) and grand, against the JAX engine; a decimal average runs
  on the CPU engine with the JAX reason and the JAX result (DOUBLE).
- TPC-DS q3, q42, q52, q55, q7 and q27 over the JAX sweep's catalog
  with store_sales' twelve money columns DECIMAL(7,2) (INT32 in
  Parquet), the port on the CPU against the JAX engine; q93 raises
  TypeError in both, as Spark would not (ROADMAP.md §3).
Decimals and integers compare exactly, doubles to 9 decimals
(``approx_float``: sums and averages add in another order).
"""

import decimal
import itertools
import types

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.exprs import arithmetic as JA
from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs import cast as JC
from spark_rapids_tpu.exprs import decimal as JDEC
from spark_rapids_tpu.exprs import predicates as JP
from spark_rapids_tpu.frontends.sql import SqlSession as JSqlSession
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import avg as javg
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import first as jfirst
from spark_rapids_tpu.session import last as jlast
from spark_rapids_tpu.session import max_ as jmax
from spark_rapids_tpu.session import min_ as jmin
from spark_rapids_tpu.session import sum_ as jsum

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession, tpcds
from spark_rapids_tpu_torch import session as PS
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs import arithmetic as A
from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs import cast as C
from spark_rapids_tpu_torch.exprs import decimal as DEC
from spark_rapids_tpu_torch.exprs import predicates as P
from spark_rapids_tpu_torch.frontends.sql import SqlSession
from spark_rapids_tpu_torch.tpcds_queries import QUERIES, variant
from test_torch_q1 import _significant
from test_torch_tpcds_texts import catalog  # noqa: F401
from torch_jax_eval import jax_eval, port_eval

D = decimal.Decimal
TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
JAX = types.SimpleNamespace(T=JT, DEC=JDEC, A=JA, P=JP, C=JC,
                            col=JB.ColumnReference, lit=JB.Literal.of)
PORT = types.SimpleNamespace(T=T, DEC=DEC, A=A, P=P, C=C, col=B.col,
                             lit=B.Literal.of)


def _dec(vals, p, s):
    return pa.array([None if v is None else D(v) for v in vals],
                    pa.decimal128(p, s))


#: JAX tests/test_decimal.py, case by case: (table, the expression of a
#: namespace, the values that file asserts, or None)
SEVEN = {
    "promote_then_add_then_check": (
        pa.table({"l": _dec(["1.10", "99999999.99", None, "-5.25"], 10, 2),
                  "r": _dec(["2.05", "0.01", "3.00", "-0.75"], 10, 2)}),
        lambda ns: ns.DEC.CheckOverflow(
            ns.DEC.PromotePrecision(ns.col("l"), ns.T.DecimalType(11, 2))
            + ns.DEC.PromotePrecision(ns.col("r"), ns.T.DecimalType(11, 2)),
            ns.T.DecimalType(11, 2)),
        None),
    "check_overflow_nulls_out_of_range": (
        pa.table({"d": _dec(["99999999.99", "-99999999.99", "1.00", None],
                            10, 2)}),
        lambda ns: ns.DEC.CheckOverflow(ns.col("d"), ns.T.DecimalType(6, 2)),
        [None, None, D("1.00"), None]),
    "check_overflow_rescale_half_up": (
        pa.table({"d": _dec(["1.25", "1.24", "-1.25", "-1.24", "0.05"],
                            10, 2)}),
        lambda ns: ns.DEC.CheckOverflow(ns.col("d"), ns.T.DecimalType(6, 1)),
        [D("1.3"), D("1.2"), D("-1.3"), D("-1.2"), D("0.1")]),
    "mismatched_decimal_add_widens": (
        pa.table({"a": _dec(["1.10", "-2.55", None], 10, 2),
                  "b": _dec(["1.1", "0.5", "3.0"], 10, 1)}),
        lambda ns: ns.col("a") + ns.col("b"),
        [D("2.20"), D("-2.05"), None]),
    "decimal_add_beyond_precision_falls_back": (
        pa.table({"a": _dec(["1.10"], 18, 2), "b": _dec(["1.10"], 18, 2)}),
        lambda ns: ns.col("a") + ns.col("b"),
        [D("2.20")]),
    "check_overflow_scale_up_wraparound": (
        pa.table({"d": _dec(["184467440737095517", "1"], 18, 0)}),
        lambda ns: ns.DEC.CheckOverflow(ns.col("d"),
                                        ns.T.DecimalType(18, 2)),
        [None, D("1.00")]),
    "wide_decimal_fallback_nulls_not_crashes": (
        pa.table({"d": _dec(["10000000000000000", "2"], 18, 0)}),
        lambda ns: ns.col("d") * ns.col("d"),
        [None, D("4")]),
}
#: the cases whose node the planners send to the CPU engine
SEVEN_ON_CPU = ("decimal_add_beyond_precision_falls_back",
                "wide_decimal_fallback_nulls_not_crashes")


@pytest.mark.parametrize("name", list(SEVEN))
def test_jax_decimal_cases(name):
    table, make, values = SEVEN[name]
    port = TorchSession(device="cpu").create_dataframe(table).select(
        make(PORT).alias("o"))
    jax = TpuSession().create_dataframe(table).select(make(JAX).alias("o"))
    got = port.collect()
    assert_tables_equal(got, jax.collect(engine="tpu"), ignore_order=False)
    assert_tables_equal(got, jax.collect(engine="cpu"), ignore_order=False)
    if values is not None:
        assert got["o"].to_pylist() == values
    assert ("!" in port.explain()) == (name in SEVEN_ON_CPU)


DECIMAL_TYPES = [(7, 2), (10, 0), (18, 4), (5, 5), (3, 0), (17, 2),
                 (12, 6)]


@pytest.mark.parametrize("l,r", list(itertools.product(DECIMAL_TYPES,
                                                       repeat=2)))
def test_add_sub_multiply_types_equal_jax(l, r):
    def typed(ns, cls):
        lt, rt = ns.T.DecimalType(*l), ns.T.DecimalType(*r)
        return cls(ns.lit(None, lt), ns.lit(None, rt))

    for name in ("Add", "Subtract", "Multiply"):
        got = typed(PORT, getattr(A, name))
        want = typed(JAX, getattr(JA, name))
        assert got.dtype.name == want.dtype.name
        if name != "Multiply":
            refused = [False, False]
            for i, e in enumerate((got, want)):
                try:
                    e.check_supported()
                except TypeError:
                    refused[i] = True
            assert refused[0] == refused[1]


def test_mixed_decimal_add_is_refused_as_in_jax():
    for ns, cls in ((PORT, A.Add), (JAX, JA.Add)):
        e = cls(ns.lit(None, ns.T.DecimalType(7, 2)), ns.lit(None, ns.T.INT))
        with pytest.raises(TypeError):
            e.check_supported()


ALL_TYPES = ["BOOLEAN", "BYTE", "SHORT", "INT", "LONG", "FLOAT", "DOUBLE",
             "STRING", "DATE", "TIMESTAMP"]


def _types(ns):
    return [getattr(ns.T, k) for k in ALL_TYPES] + [
        ns.T.DecimalType(p, s) for p, s in DECIMAL_TYPES]


def test_cast_supported_equals_jax_over_every_pair():
    port, jax = _types(PORT), _types(JAX)
    extra = []
    for (ps, js), (pd, jd) in itertools.product(zip(port, jax), repeat=2):
        got, want = C.cast_supported(ps, pd), JC.cast_supported(js, jd)
        if got != want:
            extra.append((ps.name, pd.name, got))
    # what the port casts beyond the JAX matrix
    assert extra == [("date", "string", True)]
    assert all(C.cast_supported(T.NULL, t) for t in port)


@pytest.fixture(scope="module")
def scalars():
    """A column of every scalar type, 20 % NULLs: floats with -0.0, NaN
    and +/-inf, integers at their extremes, instants before 1970,
    negative decimals, numeric strings."""
    rng = np.random.default_rng(8)
    n = 240

    def mask():
        return rng.random(n) < 0.2

    f = rng.normal(0, 300, n)
    f[::11] = -0.0
    f[1::13] = np.nan
    f[2::17] = np.inf
    f[3::19] = -np.inf
    b = rng.integers(-128, 128, n).astype(np.int8)
    b[::9] = -128
    h = rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16)
    h[::9] = -32768
    cols = {
        "boolean": pa.array(rng.random(n) < 0.5, mask=mask()),
        "byte": pa.array(b, mask=mask()),
        "short": pa.array(h, mask=mask()),
        "int": pa.array(rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int32),
                        mask=mask()),
        "long": pa.array(rng.integers(-10 ** 9, 10 ** 9, n), mask=mask()),
        "float": pa.array(f.astype(np.float32), mask=mask()),
        "double": pa.array(np.round(f, 3), mask=mask()),
        "string": pa.array([str(v) for v in rng.integers(-300, 300, n)],
                           mask=mask()),
        "date": pa.array(rng.integers(-25_000, 47_000, n).astype(np.int32),
                         mask=mask()).cast(pa.date32()),
        "timestamp": pa.array(rng.integers(-2 ** 52, 2 ** 52, n),
                              pa.timestamp("us", tz="UTC"), mask=mask()),
    }
    for p, s in DECIMAL_TYPES:
        top = min(10 ** p - 1, 10 ** 12)
        cols[f"dec{p}_{s}"] = pa.array(
            [D(int(v)).scaleb(-s) for v in rng.integers(-top, top + 1, n)],
            pa.decimal128(p, s), mask=mask())
    return pa.table(cols)


def _column_names():
    return ALL_TYPES, [f"dec{p}_{s}" for p, s in DECIMAL_TYPES]


def _casts():
    """(source column, target type index) for every pair both packages
    cast, but STRING targets of floating sources (no package casts
    them)."""
    names = [k.lower() for k in ALL_TYPES] + _column_names()[1]
    out = []
    for si, sname in enumerate(names):
        for di, dt_ in enumerate(_types(JAX)):
            src = _types(JAX)[si]
            if src != dt_ and JC.cast_supported(src, dt_):
                out.append(pytest.param(sname, di,
                                        id=f"{sname}->{dt_.name}"))
    return out


@pytest.mark.parametrize("src,dst", _casts())
def test_cast_equals_jax(scalars, src, dst):
    got = port_eval(scalars, [C.Cast(B.col(src), _types(PORT)[dst])])
    want = jax_eval(scalars, [JC.Cast(JB.ColumnReference(src),
                                      _types(JAX)[dst])])
    assert got.column(0).type == want.column(0).type
    assert_tables_equal(got, want, ignore_order=False)


SAME_TYPE = ["byte", "short", "float", "timestamp", "dec7_2", "dec18_4"]


@pytest.mark.parametrize("name", SAME_TYPE)
def test_predicates_and_conditionals_equal_jax(scalars, name):
    rev = scalars.take(np.arange(scalars.num_rows)[::-1])
    table = scalars.append_column("other", rev.column(name))

    def cases(ns):
        c, o = ns.col(name), ns.col("other")
        first = scalars.column(name).drop_null()[0].as_py()
        if isinstance(first, float) and first != first:
            first = 1.5
        in_vals = () if name in ("timestamp",) or name.startswith("dec") \
            else (first, 0, None)
        out = [ns.P.EqualTo(c, o), ns.P.LessThan(c, o),
               ns.P.GreaterThanOrEqual(c, o), ns.P.EqualNullSafe(c, o),
               ns.P.Coalesce(c, o),
               ns.P.If(ns.P.LessThan(c, o), c, o),
               ns.P.CaseWhen(((ns.P.IsNull(c), o),), c),
               ns.P.IsNotNull(c)]
        if in_vals:
            out.append(ns.P.In(c, in_vals))
        return out

    got = port_eval(table, cases(PORT))
    want = jax_eval(table, cases(JAX))
    assert_tables_equal(got, want, ignore_order=False)


def _agg_table(n=400, seed=4):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.2
    vals = [D(int(v)).scaleb(-2) for v in
            rng.integers(-10 ** 7 + 1, 10 ** 7, n)]
    return pa.table({
        "g": pa.array(rng.integers(0, 9, n)),
        "d": pa.array(vals, pa.decimal128(9, 2), mask=mask),
        "e": pa.array([D(int(v)).scaleb(-4) for v in
                       rng.integers(-10 ** 15, 10 ** 15, n)],
                      pa.decimal128(18, 4)),
    })


def _write(tmp_path, t, files=3):
    per = -(-t.num_rows // files)
    paths = []
    for i in range(files):
        p = str(tmp_path / f"part-{i}.parquet")
        pq.write_table(t.slice(i * per, per), p,
                       store_decimal_as_integer=True)
        paths.append(p)
    return paths


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "grand"])
def test_decimal_aggregates_equal_jax(tmp_path, grouped):
    t = _agg_table()
    paths = _write(tmp_path, t)
    port = TorchSession({TTB: 1}, device="cpu").read_parquet(*paths)
    jax = TpuSession().read_parquet(*paths)
    paggs = [(PS.sum_(PS.col("d")), "s"), (PS.min_(PS.col("d")), "mn"),
             (PS.max_(PS.col("d")), "mx"), (PS.sum_(PS.col("e")), "se"),
             (PS.min_(PS.col("e")), "mne")]
    jaggs = [(jsum(jcol("d")), "s"), (jmin(jcol("d")), "mn"),
             (jmax(jcol("d")), "mx"), (jsum(jcol("e")), "se"),
             (jmin(jcol("e")), "mne")]
    if grouped:
        got_df = port.group_by(PS.col("g")).agg(*paggs)
        want = jax.group_by(jcol("g")).agg(*jaggs).collect(engine="tpu")
    else:
        got_df = port.agg(*paggs)
        want = jax.agg(*jaggs).collect(engine="tpu")
    got = got_df.collect()
    assert "!" not in got_df.explain()
    assert str(got.schema.field("s").type) == "decimal128(18, 2)"
    assert got.schema.field("s").type == want.schema.field("s").type
    assert_tables_equal(got, want)


@pytest.mark.parametrize("ignore_nulls", [False, True])
def test_decimal_first_last_equal_jax(tmp_path, ignore_nulls):
    """One scan task: both engines see one row order."""
    t = _agg_table(200, 6)
    path = str(tmp_path / "one.parquet")
    pq.write_table(t, path)
    port = TorchSession(device="cpu").read_parquet(path)
    jax = TpuSession().read_parquet(path)
    got = port.group_by(PS.col("g")).agg(
        (PS.first(PS.col("d"), ignore_nulls), "f"),
        (PS.last(PS.col("d"), ignore_nulls), "l")).collect()
    want = jax.group_by(jcol("g")).agg(
        (jfirst(jcol("d"), ignore_nulls), "f"),
        (jlast(jcol("d"), ignore_nulls), "l")).collect(engine="tpu")
    assert_tables_equal(got, want)


def test_decimal_average_runs_on_the_cpu_engine_as_in_jax(tmp_path):
    paths = _write(tmp_path, _agg_table())
    port = TorchSession({TTB: 1}, device="cpu").read_parquet(*paths) \
        .group_by(PS.col("g")).agg((PS.avg(PS.col("d")), "a"))
    jax = TpuSession().read_parquet(*paths).group_by(jcol("g")).agg(
        (javg(jcol("d")), "a"))
    marked = [ln for ln in port.explain().splitlines()
              if ln.lstrip().startswith("!")]
    assert len(marked) == 1 and "Aggregate" in marked[0]
    assert "aggregate average does not support input type decimal(9,2)" \
        in marked[0]
    jmarked = [ln for ln in jax.explain().splitlines()
               if ln.lstrip().startswith("!")]
    assert "aggregate average does not support input type decimal(9,2)" \
        in jmarked[0]
    got = port.collect()
    assert got.schema.field("a").type == pa.float64()
    assert_tables_equal(got, jax.collect(engine="tpu"), approx_float=True)


@pytest.fixture(scope="module")
def decimal_catalog(catalog):  # noqa: F811
    """The JAX sweep's catalog with store_sales' money columns as the
    spec types them."""
    out = dict(catalog)
    ss = catalog["store_sales"]
    for name in tpcds.MONEY_COLUMNS:
        i = ss.schema.get_field_index(name)
        ss = ss.set_column(i, pa.field(name, tpcds.MONEY_TYPE),
                           tpcds.cents(ss.column(name)))
    out["store_sales"] = ss
    return out


@pytest.fixture(scope="module")
def frontends(tmp_path_factory, decimal_catalog):
    d = tmp_path_factory.mktemp("decimal_texts")
    port = SqlSession({TTB: 1}, device="cpu")
    jax = JSqlSession()
    for name in tpcds.STORE_CHANNEL_TABLES:
        t = decimal_catalog[name]
        jax.register_table(name, t)
        if name == "store_sales":
            per = -(-t.num_rows // 3)
            paths = [str(d / f"{name}-{i}.parquet") for i in range(3)]
            for i, p in enumerate(paths):
                pq.write_table(t.slice(i * per, per), p,
                               store_decimal_as_integer=True)
        else:
            paths = [str(d / f"{name}.parquet")]
            pq.write_table(t, paths[0])
        port.register_parquet(name, *paths)
    return port, jax


TEXTS = {"q3": QUERIES[3], "q42": QUERIES[42], "q52": QUERIES[52],
         "q55": QUERIES[55], "q7": QUERIES[7], "q27_variant": variant(27)}


@pytest.mark.parametrize("name", list(TEXTS))
def test_spec_typed_text_equals_the_jax_engine(frontends, name):
    port, jax = frontends
    df = port.sql(TEXTS[name])
    got = df.collect()
    want = jax.sql(TEXTS[name]).collect(engine="tpu")
    assert got.num_rows > 0
    assert_tables_equal(_significant(got), _significant(want),
                        approx_float=True)
    marked = [ln for ln in df.explain().splitlines()
              if ln.lstrip().startswith("!")]
    if name in ("q7", "q27_variant"):
        assert len(marked) == 1 and "Aggregate" in marked[0]
        assert "input type decimal(7,2)" in marked[0]
        assert all(t == pa.float64() for t in got.schema.types[-4:])
    else:
        assert marked == []
        assert got.schema.types[-1] == pa.decimal128(17, 2)


def test_q93_raises_as_in_jax(frontends):
    port, jax = frontends
    with pytest.raises(TypeError, match="bigint / decimal"):
        port.sql(QUERIES[93])
    with pytest.raises(TypeError, match="bigint / DecimalType"):
        jax.sql(QUERIES[93])


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
