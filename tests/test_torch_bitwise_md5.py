"""Bitwise and shift expressions and md5 in the port against the JAX
package.

- ``exprs/bitwise.py``: ``&``, ``|``, ``^``, ``~``, ``<<``, ``>>`` and
  ``>>>`` over LONG and INT columns (shift amounts beyond the width,
  negative ones, MIN_VALUE), evaluated directly on one batch in both
  packages and through both sessions and the JAX CPU engine, exactly;
  a bitwise op over a DOUBLE is an analysis error in both packages.
- ``exprs/hashing.py::Md5`` (K7) equals ``hashlib`` and the JAX
  package's ``md5_string_bytes`` over lengths around each 64-byte block
  boundary, multi-byte UTF-8 and NULLs, in one batch and through the
  sessions; a bucket of ``md5`` hex prefixes groups through an
  exchange as the chip run's tickets query does.
"""

import hashlib
import types

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import session as JS
from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs import bitwise as JBW
from spark_rapids_tpu.exprs import hashing as JH
from spark_rapids_tpu.exprs import strings as JSTR
from spark_rapids_tpu.exprs.cast import Cast as JCast
from spark_rapids_tpu import types as JT

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import session as PS
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs import bitwise as BW
from spark_rapids_tpu_torch.exprs import hashing as H
from spark_rapids_tpu_torch.exprs import strings as S
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.execs.fallback import CpuFallbackExec
from test_torch_nested import assert_tables_equal
from torch_jax_eval import jax_eval, port_eval, raw
from torch_quiet import quiet_ladder  # noqa: F401

PORT = types.SimpleNamespace(BW=BW, H=H, S=S, col=B.col, lit=B.lit,
                             Cast=Cast, T=T, session=PS)
JAX = types.SimpleNamespace(BW=JBW, H=JH, S=JSTR, col=JB.ColumnReference,
                            lit=JB.lit, Cast=JCast, T=JT, session=JS)
I64MIN, I64MAX = -(2 ** 63), 2 ** 63 - 1
I32MIN, I32MAX = -(2 ** 31), 2 ** 31 - 1


def bit_table(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    a = rng.integers(-(2 ** 62), 2 ** 62, n)
    a[:4] = [I64MIN, I64MAX, -1, 0]
    i = rng.integers(I32MIN, I32MAX, n)
    i[:4] = [I32MIN, I32MAX, -1, 0]
    return pa.table({
        "a": pa.array(a, pa.int64(), mask=rng.random(n) < 0.1),
        "b": pa.array(rng.integers(-(2 ** 40), 2 ** 40, n), pa.int64()),
        "i": pa.array(i.astype(np.int32), pa.int32()),
        "s": pa.array(rng.integers(-70, 140, n).astype(np.int32),
                      pa.int32(), mask=rng.random(n) < 0.1)})


def _bit_exprs(ns):
    bw, c = ns.BW, ns.col
    a, b, i, s = c("a"), c("b"), c("i"), c("s")
    return [bw.BitwiseAnd(a, b), bw.BitwiseOr(a, b), bw.BitwiseXor(a, b),
            bw.BitwiseNot(a), bw.BitwiseAnd(i, s), bw.BitwiseXor(a, i),
            bw.BitwiseNot(i), bw.ShiftLeft(a, s), bw.ShiftRight(a, s),
            bw.ShiftRightUnsigned(a, s), bw.ShiftLeft(i, s),
            bw.ShiftRight(i, s), bw.ShiftRightUnsigned(i, s),
            bw.BitwiseAnd(bw.ShiftRight(a, ns.lit(4)), ns.lit(1023))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bitwise_equals_the_jax_functions(seed):
    t = bit_table(300, seed)
    got = port_eval(t, _bit_exprs(PORT))
    want = jax_eval(t, _bit_exprs(JAX))
    assert got.equals(want.cast(got.schema))


def test_bitwise_family_through_both_engines():
    """JAX ``test_expr_families::test_bitwise_family``."""
    t = bit_table(200, 21)

    def build(df, ns):
        return df.select(*[e.alias(f"c{k}")
                           for k, e in enumerate(_bit_exprs(ns))])

    got = build(TorchSession(device="cpu").create_dataframe(t),
                PORT).collect()
    assert not [n for n in build(TorchSession(device="cpu")
                                 .create_dataframe(t), PORT)
                .physical_plan().walk() if isinstance(n, CpuFallbackExec)]
    jdf = build(JS.TpuSession().create_dataframe(t), JAX)
    assert_tables_equal(got, jdf.collect(engine="tpu"), ignore_order=False)
    assert_tables_equal(got, jdf.collect(engine="cpu"), ignore_order=False)
    d = got.to_pydict()
    for a, s, u in zip(t.column("a").to_pylist(), t.column("s").to_pylist(),
                       d["c9"]):
        if a is None or s is None:
            assert u is None
            continue
        want = (a % 2 ** 64) >> (s & 63)
        assert u == (want - 2 ** 64 if want >= 2 ** 63 else want)


def test_bitwise_over_a_double_is_an_analysis_error():
    """As in the JAX package, the plan cannot even be built."""
    t = pa.table({"d": pa.array([1.5]), "a": pa.array([3])})
    for session, ns in ((TorchSession(device="cpu"), PORT),
                        (JS.TpuSession(), JAX)):
        with pytest.raises(TypeError, match="integral"):
            session.create_dataframe(t).select(ns.BW.BitwiseAnd(
                ns.col("a"), ns.col("d")).alias("x")).collect()


MD5_VALUES = ["", "a", "abc", "hello world", "é✓ünïcode", "x" * 55,
              "y" * 56, "z" * 63, "w" * 64, "q" * 100, None,
              "The quick brown fox jumps over the lazy dog", "日本語" * 40,
              "v" * 119, "u" * 120]


def test_md5_matches_hashlib_and_jax():
    t = pa.table({"s": pa.array(MD5_VALUES, pa.string())})
    want = [None if v is None else hashlib.md5(v.encode()).hexdigest()
            for v in MD5_VALUES]
    got = port_eval(t, [H.Md5(B.col("s"))])
    assert got.column(0).to_pylist() == want
    assert raw(got).equals(raw(jax_eval(t, [JH.Md5(JB.ColumnReference(
        "s"))])))

    def build(df, ns):
        return df.select(ns.col("s"), ns.H.Md5(ns.col("s")).alias("h"))

    port = build(TorchSession(device="cpu").create_dataframe(t),
                 PORT).collect()
    assert port.to_pydict()["h"] == want
    jdf = build(JS.TpuSession().create_dataframe(t), JAX)
    assert_tables_equal(port, jdf.collect(engine="tpu"), ignore_order=False)
    assert_tables_equal(port, jdf.collect(engine="cpu"), ignore_order=False)


@pytest.mark.parametrize("seed", [3, 4])
def test_md5_over_seeded_lengths(seed):
    rng = np.random.default_rng(seed)
    vals = ["".join(chr(c) for c in rng.integers(32, 0x3000, k))
            for k in rng.integers(0, 90, 200)]
    t = pa.table({"s": pa.array(vals, mask=rng.random(200) < 0.1)})
    got = port_eval(t, [H.Md5(B.col("s"))]).column(0).to_pylist()
    want = [None if v is None else hashlib.md5(v.encode()).hexdigest()
            for v in t.column("s").to_pylist()]
    assert got == want


def test_tickets_like_the_chip_query(tmp_path):
    """The chip run's tickets query, small: md5 of a concat_ws of two
    casts, grouped by its 2-character prefix (an exchange on a STRING)
    and by a bitwise bucket of the ticket (an exchange on a LONG)."""
    rng = np.random.default_rng(8)
    paths = []
    for f in range(3):
        n = 300
        p = str(tmp_path / f"s{f}.parquet")
        pq.write_table(pa.table({
            "ticket": pa.array(rng.integers(1, 10 ** 6, n), pa.int64()),
            "item": pa.array(rng.integers(1, 18000, n), pa.int64()),
            "cust": pa.array(rng.integers(1, 10 ** 5, n), pa.int64(),
                             mask=rng.random(n) < 0.05),
            "paid": pa.array(rng.integers(0, 10 ** 4, n) / 100.0)}), p)
        paths.append(p)

    def build(s, ns):
        c, lit = ns.col, ns.lit
        md5 = ns.H.Md5(ns.session.concat_ws(
            "|", ns.Cast(c("ticket"), ns.T.STRING),
            ns.Cast(c("item"), ns.T.STRING)))
        bucket = ns.BW.BitwiseAnd(ns.BW.ShiftRight(c("ticket"), lit(4)),
                                  lit(1023))
        proj = s.read_parquet(*paths).select(
            ns.S.Substring(md5, 1, 2).alias("h2"), bucket.alias("bucket"),
            ns.BW.BitwiseXor(c("item"), c("cust")).alias("x"), c("paid"))
        by_hash = proj.group_by(c("h2")).agg(
            (ns.session.count_star(), "n"), (ns.session.sum_(c("x")), "x"))
        by_bucket = proj.group_by(c("bucket")).agg(
            (ns.session.count_star(), "n"), (ns.session.sum_(c("x")), "x"))
        return by_hash, by_bucket

    port_s = TorchSession({"spark.rapids.tpu.sql.scan.taskTargetBytes": 1},
                          device="cpu")
    jax_s = JS.TpuSession()
    jax_s.conf.set("spark.rapids.tpu.sql.scan.taskTargetBytes", 1)
    for got_df, want_df in zip(build(port_s, PORT), build(jax_s, JAX)):
        assert "TpuShuffleExchangeExec" in got_df.physical_plan() \
            .tree_string()
        assert_tables_equal(got_df.collect(), want_df.collect(engine="tpu"))


@pytest.mark.parametrize("k", range(len(_bit_exprs(PORT)) + 1))
def test_cpu_engine_equals_the_jax_cpu_engine(k):
    """Each bitwise expression, and md5, through the port's
    ``execute_cpu`` and the JAX package's CPU engine."""
    from spark_rapids_tpu.cpu.engine import execute_cpu as jexecute

    from spark_rapids_tpu_torch.cpu.engine import execute_cpu

    t = bit_table(200, 9).append_column("w", pa.array(
        (MD5_VALUES * 14)[:200], pa.string()))

    def expr(ns):
        exprs = _bit_exprs(ns) + [ns.H.Md5(ns.col("w"))]
        return exprs[k].alias("v")

    got = execute_cpu(TorchSession(device="cpu").create_dataframe(t)
                      .select(expr(PORT))._plan)
    want = jexecute(JS.TpuSession().create_dataframe(t).select(
        expr(JAX))._plan)
    assert_tables_equal(got, want.cast(got.schema), ignore_order=False)
