"""The port's predicates, null tests and conditionals against the JAX
package's: string comparisons, EqualNullSafe, IsNull / IsNotNull /
IsNaN, In, variadic Coalesce, If, CaseWhen and AtLeastNNonNulls.

Each case selects a list of expressions over one numpy-seeded Parquet
table (strings with NUL, UTF-8 and empty values, an all-empty string
column, LONG / INT / DOUBLE / BOOLEAN columns, 20 % NULLs) through the
port on the CPU, the JAX engine and the JAX package's CPU oracle, and
requires the three results to be equal exactly (no float tolerance:
every value is a selection or a comparison).  ``_string_cmp`` is also
held against the JAX function directly, and against Python's byte
order, on columns of different widths.

The JAX session reads with ``scan.fastDecode`` off: its native decoder
cuts dictionary-encoded strings at their first NUL byte ("a\\0" reads
as "a"), which the port does not (ROADMAP.md §3).  Where the JAX engine
departs from Spark (NaN IN (NaN), a string CASE with a NULL branch),
the port follows Spark, and the cases say which engine agrees.
"""

import types

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.columnar.arrow import from_arrow as jfrom_arrow
from spark_rapids_tpu.config import get_conf, set_conf
from spark_rapids_tpu.exprs import predicates as JP
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import lit as jlit

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession, col, lit
from spark_rapids_tpu_torch.columnar.arrow import from_arrow
from spark_rapids_tpu_torch.exprs import predicates as P

N = 96
WORDS = ["", "a", "a\0", "a\0b", "ab", "abc", "b", "B", "\x7f", "é", "ünï",
         "日本", "zz", "abcdefghij"]
DOUBLES = [-0.0, 0.0, float("nan"), 1.5, -2.0, float("inf"),
           float("-inf"), 3.0]
FAST_DECODE = "spark.rapids.tpu.sql.scan.fastDecode"

JAX = types.SimpleNamespace(col=jcol, lit=jlit, P=JP)
PORT = types.SimpleNamespace(col=col, lit=lit, P=P)


def _table(seed=11):
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(N) < 0.2

    def words():
        return pa.array(np.array(WORDS, dtype=object)[
            rng.integers(0, len(WORDS), N)], pa.string(), mask=nulls())

    def doubles():
        return pa.array(np.array(DOUBLES)[rng.integers(0, len(DOUBLES), N)],
                        mask=nulls())

    return pa.table({
        "s": words(), "t": words(),
        "z": pa.array([""] * N, mask=nulls()),
        "x": pa.array(rng.integers(-3, 4, N), pa.int64(), mask=nulls()),
        "y": pa.array(rng.integers(-3, 4, N), pa.int64(), mask=nulls()),
        "i": pa.array(rng.integers(-3, 4, N).astype(np.int32), pa.int32(),
                      mask=nulls()),
        "d": doubles(), "e": doubles(),
        "p": pa.array(rng.random(N) < 0.5, mask=nulls()),
        "q": pa.array(rng.random(N) < 0.5, mask=nulls()),
    })


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("predicates") / "t.parquet")
    pq.write_table(_table(), p)
    return p


@pytest.fixture(scope="module")
def jax_session():
    conf = get_conf()
    saved = dict(conf._values)
    conf.set(FAST_DECODE, False)
    set_conf(conf)
    try:
        yield TpuSession(conf)
    finally:
        conf._values.clear()
        conf._values.update(saved)
        set_conf(conf)


def _cases(ns):
    """name -> the expressions of one select, built from a package's
    ``col``, ``lit`` and predicates module."""
    c, lit_, P_ = ns.col, ns.lit, ns.P
    s, t, z, x, y, i, d, e, p, q = (c(n) for n in "stzxyidepq")
    return {
        "string_columns": [s < t, s <= t, s > t, s >= t, s.eq(t), s.ne(t),
                           z < s, z.eq(t)],
        "string_literals": [s < lit_("ab"), s.eq(lit_("")),
                            s >= lit_("é"), s.eq(lit_("a\0")),
                            lit_("a") < s, s > lit_("abcdefghijk"),
                            z.eq(lit_("")), z < lit_("a"),
                            s.ne(lit_("a\0b"))],
        "numeric_comparisons": [x < y, d < e, d.eq(e), d >= e, x < d,
                                i.eq(x), i.ne(y)],
        "equal_null_safe": [P_.EqualNullSafe(s, t), P_.EqualNullSafe(x, y),
                            P_.EqualNullSafe(s, lit_("ab")),
                            P_.EqualNullSafe(z, t),
                            P_.EqualNullSafe(i, x)],
        "null_tests": [s.is_null(), s.is_not_null(), x.is_null(),
                       d.is_not_null(), z.is_null(), P_.IsNaN(d),
                       P_.IsNaN(e), P_.IsNull(lit_(None))],
        "in": [P_.In(x, (1, 2)), P_.In(x, (1, None)), P_.In(i, (0, 3)),
               P_.In(s, ("a", "ünï", "")), P_.In(s, ("a", None)),
               P_.In(s, ("a\0",)), P_.In(z, ("",)),
               P_.In(d, (1.5, 3.0)), P_.In(d, (float("inf"), None))],
        "coalesce": [P_.Coalesce(x, y), P_.Coalesce(x, y, lit_(7)),
                     P_.Coalesce(s, t), P_.Coalesce(s, t, lit_("zz")),
                     P_.Coalesce(z, s), P_.Coalesce(i, x),
                     P_.Coalesce(i, d), P_.Coalesce(lit_(None), x),
                     P_.Coalesce(d)],
        "if": [P_.If(p, x, y), P_.If(p, s, t), P_.If(x < y, i, d),
               P_.If(p, x, lit_(None)), P_.If(p, lit_(None), d),
               P_.If(p.eq(q), z, s), P_.If(lit_(None), x, y)],
        "case_when": [
            P_.CaseWhen(((p, x), (q, y)), lit_(0)),
            P_.CaseWhen(((s.eq(lit_("a")), s), (x > lit_(0), t)),
                        lit_("none")),
            P_.CaseWhen(((p, i),), d),
            P_.CaseWhen(((lit_(None), x), (q, i)), y),
            P_.CaseWhen(((x.is_not_null(), (x - y) * d),), x * d)],
        "at_least_n_non_nulls": [P_.AtLeastNNonNulls(2, [x, s, d]),
                                 P_.AtLeastNNonNulls(1, [d, e]),
                                 P_.AtLeastNNonNulls(3, [x, y, s, t, z]),
                                 P_.AtLeastNNonNulls(0, [d])],
    }


def _select(df, exprs):
    return df.select(*[ex.alias(f"c{k}") for k, ex in enumerate(exprs)])


@pytest.mark.parametrize("case", list(_cases(PORT)))
def test_port_equals_the_jax_engine_and_the_cpu_oracle(case, path,
                                                       jax_session):
    got = _select(TorchSession(device="cpu").read_parquet(path),
                  _cases(PORT)[case]).collect()
    jdf = _select(jax_session.read_parquet(path), _cases(JAX)[case])
    assert got.num_rows == N
    for engine in ("tpu", "cpu"):
        want = jdf.collect(engine=engine)
        assert got.schema.types == want.schema.types, engine
        assert_tables_equal(got, want, ignore_order=False)


@pytest.mark.parametrize("case", list(_cases(PORT)))
def test_result_types_and_nullability_match_jax(case, path, jax_session):
    pdf = _select(TorchSession(device="cpu").read_parquet(path),
                  _cases(PORT)[case])
    jdf = _select(jax_session.read_parquet(path), _cases(JAX)[case])
    assert [f.dtype.name for f in pdf.schema.fields] == [
        f.dtype.name for f in jdf.schema.fields]
    never_null = {"equal_null_safe", "null_tests", "at_least_n_non_nulls"}
    if case in never_null:
        assert not any(f.nullable for f in pdf.schema.fields)


# --------------------------------------------------------------------- #
# String order, against the JAX function and against Python's bytes
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("left_extra,right_extra", [
    ("", ""), ("a much longer string than the rest", ""),
    ("", "ü" * 20)])
def test_string_cmp_equals_the_jax_function_and_byte_order(left_extra,
                                                           right_extra):
    pairs = [(a, b) for a in WORDS for b in WORDS]
    lw = [a for a, _ in pairs] + ([left_extra] if left_extra else [""])
    rw = [b for _, b in pairs] + ([right_extra] if right_extra else [""])
    lt_py = [a.encode() < b.encode() for a, b in zip(lw, rw)]
    eq_py = [a == b for a, b in zip(lw, rw)]
    tbl = pa.table({"l": pa.array(lw), "r": pa.array(rw)})
    pb = from_arrow(tbl, torch.device("cpu"))
    jb = jfrom_arrow(tbl)
    assert pb.columns[0].width != pb.columns[1].width or not (
        left_extra or right_extra)
    lt, eq = P._string_cmp(pb.columns[0], pb.columns[1])
    jlt, jeq = JP._string_cmp(jb.columns[0], jb.columns[1])
    n = len(lw)
    assert lt.tolist() == lt_py and eq.tolist() == eq_py
    assert lt.tolist() == np.asarray(jlt)[:n].tolist()
    assert eq.tolist() == np.asarray(jeq)[:n].tolist()


def test_string_order_cases_spark_pins():
    tbl = pa.table({"l": ["a", "z", "", "ab", "b"],
                    "r": ["a\0", "é", "", "a", "B"]})
    b = from_arrow(tbl, torch.device("cpu"))
    lt, eq = P._string_cmp(b.columns[0], b.columns[1])
    # "a" < "a\0"; 0xC3 (é) above every ASCII byte; "" = ""; longer
    # after its prefix; upper case before lower case
    assert lt.tolist() == [True, True, False, False, False]
    assert eq.tolist() == [False, False, True, False, False]


def test_null_string_equals_nothing(path):
    t = pq.read_table(path)
    got = _select(TorchSession(device="cpu").read_parquet(path), [
        col("s").eq(col("s")), col("s").eq(lit("")),
        P.EqualNullSafe(col("s"), col("s"))]).collect()
    null = t.column("s").is_null().to_pylist()
    assert null and any(null)
    for k, is_null in enumerate(null):
        if is_null:
            assert got.column("c0")[k].as_py() is None
            assert got.column("c1")[k].as_py() is None
            assert got.column("c2")[k].as_py() is True


# --------------------------------------------------------------------- #
# Three-valued logic, and where the JAX engine departs from Spark
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def tv_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("three_valued") / "t.parquet")
    pq.write_table(pa.table({
        "x": pa.array([1, 2, None, 3], pa.int64()),
        "s": pa.array(["a", None, "b", "c"]),
        "d": pa.array([float("nan"), -0.0, None, 2.0]),
        "p": pa.array([True, None, False, None]),
        "n": pa.nulls(4, pa.int64()),
    }), p)
    return p


def _tv_cases(ns):
    c, lit_, P_ = ns.col, ns.lit, ns.P
    return [
        # x IN (1, NULL): true on a match, NULL without one
        P_.In(c("x"), (1, None)),
        # NULL IN (...) is NULL
        P_.In(c("x"), (2, 3)),
        # <=> is never NULL
        P_.EqualNullSafe(c("x"), c("n")),
        P_.EqualNullSafe(c("s"), c("s")),
        # CASE WHEN NULL takes the next branch
        P_.CaseWhen(((c("p"), lit_(10)), (c("x") > lit_(1), lit_(20))),
                    lit_(30)),
        P_.IsNull(c("p")),
        P_.Coalesce(lit_(None), c("x"), lit_(-1)),
    ]


TV_WANT = [[True, None, None, None],
           [False, True, None, True],
           [False, False, True, False],
           [True, True, True, True],
           [10, 20, 30, 20],
           [False, True, False, True],
           [1, 2, -1, 3]]


def test_three_valued_cases_on_every_engine(tv_path, jax_session):
    got = _select(TorchSession(device="cpu").read_parquet(tv_path),
                  _tv_cases(PORT)).collect()
    assert [got.column(f"c{k}").to_pylist()
            for k in range(len(TV_WANT))] == TV_WANT
    jdf = _select(jax_session.read_parquet(tv_path), _tv_cases(JAX))
    for engine in ("tpu", "cpu"):
        assert_tables_equal(got, jdf.collect(engine=engine),
                            ignore_order=False)


def test_doubles_compare_as_spark_does(tv_path, jax_session):
    """NaN IN (NaN), -0.0 IN (0.0) and NaN <=> NaN are true in Spark (In
    and <=> compare doubles in their total order, where -0.0 = 0.0 and
    NaN = NaN).  The JAX engine's In compares with ``==`` (NaN IN (NaN)
    false); the CPU oracle's In hashes with pyarrow's ``is_in`` (-0.0 IN
    (0.0) false) and its <=> uses pyarrow's ``equal`` (NaN <=> NaN
    false)."""
    def exprs(ns):
        c, P_ = ns.col, ns.P
        return [P_.In(c("d"), (float("nan"),)), P_.In(c("d"), (0.0, 5.0)),
                P_.EqualNullSafe(c("d"), c("d"))]

    got = _select(TorchSession(device="cpu").read_parquet(tv_path),
                  exprs(PORT)).collect()
    spark = [[True, False, None, False], [False, True, None, False],
             [True, True, True, True]]
    assert [got.column(f"c{k}").to_pylist() for k in range(3)] == spark
    jdf = _select(jax_session.read_parquet(tv_path), exprs(JAX))
    tpu, cpu = jdf.collect(engine="tpu"), jdf.collect(engine="cpu")
    assert [tpu.column(f"c{k}").to_pylist() for k in range(3)] == [
        [False, False, None, False], spark[1], spark[2]]
    assert [cpu.column(f"c{k}").to_pylist() for k in range(3)] == [
        spark[0], [False, False, None, False], [False, True, True, True]]


def test_string_branch_with_a_null_branch(tv_path, jax_session):
    """A NULL literal branch takes the other branch's type, strings
    too.  The CPU oracle agrees; the JAX engine raises on it."""
    def exprs(ns):
        c, lit_, P_ = ns.col, ns.lit, ns.P
        return [P_.If(c("p"), c("s"), lit_(None)),
                P_.CaseWhen(((c("x") > lit_(1), c("s")),), lit_(None)),
                P_.Coalesce(c("s"), lit_(None), lit_("dflt"))]

    got = _select(TorchSession(device="cpu").read_parquet(tv_path),
                  exprs(PORT)).collect()
    assert got.schema.types == [pa.string()] * 3
    assert got.column("c0").to_pylist() == ["a", None, None, None]
    assert got.column("c1").to_pylist() == [None, None, None, "c"]
    assert got.column("c2").to_pylist() == ["a", "dflt", "b", "c"]
    jdf = _select(jax_session.read_parquet(tv_path), exprs(JAX))
    assert_tables_equal(got, jdf.collect(engine="cpu"), ignore_order=False)
    with pytest.raises(AttributeError):
        _select(jax_session.read_parquet(tv_path),
                exprs(JAX)[:1]).collect(engine="tpu")


def test_coalesce_keeps_counts_of_an_empty_grand_aggregate(tmp_path):
    from spark_rapids_tpu_torch import count, count_star

    p = str(tmp_path / "e.parquet")
    pq.write_table(pa.table({"x": pa.array([], pa.int64())}), p)
    out = TorchSession(device="cpu").read_parquet(p).agg(
        (count_star(), "n"), (count(col("x")), "m")).collect()
    assert out.to_pylist() == [{"n": 0, "m": 0}]


def test_a_string_and_a_number_do_not_mix(path):
    df = TorchSession(device="cpu").read_parquet(path)
    with pytest.raises(TypeError):
        df.select(P.If(col("p"), col("s"), col("x")).alias("c0"))
    with pytest.raises(TypeError):
        df.select(P.Coalesce(col("s"), lit(1)).alias("c0"))
    with pytest.raises(TypeError):
        df.select(col("s").eq(lit(1)).alias("c0")).collect()


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
