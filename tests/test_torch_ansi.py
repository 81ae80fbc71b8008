"""ANSI mode (``spark.rapids.tpu.sql.ansi.enabled``) in the port against
the JAX package.

Every case of JAX ``tests/test_ansi.py``: with the key on, integral
overflow in + - *, a zero divisor, a malformed STRING cast to an
integral type, a NaN or out-of-range FLOAT / DOUBLE cast to one and a
narrowing integral cast that loses the value raise ``AnsiError`` with
the JAX message word for word, on the port's device path (Project and
Filter, each polling once a batch) and on its CPU engine (the Project's
switch off); what does not overflow gives the rows ANSI off gives, and
a NULL row never raises.  With the key off the port wraps or gives
NULL, equal to both JAX engines.  An ANSI-checked expression in a sort
key, a grouping key or a join key runs on the CPU engine with the JAX
reason, and raises there.  A Filter pushes no such conjunct into its
scan and is never elided.  With the key off a Project adds no device
sync (no ``.item()`` call and no poll), and with it on exactly one a
batch.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import session as JS
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.exprs import arithmetic as JA
from spark_rapids_tpu.exprs.base import AnsiError as JAnsiError
from spark_rapids_tpu.exprs.cast import Cast as JCast

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import session as PS
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs import arithmetic as A
from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs.base import AnsiError
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.execs.fallback import CpuFallbackExec
from test_torch_nested import assert_tables_equal
from torch_quiet import quiet_ladder  # noqa: F401

ANSI = "spark.rapids.tpu.sql.ansi.enabled"
PROJECT_OFF = "spark.rapids.tpu.sql.exec.Project"
I64MAX = (1 << 63) - 1
I64MIN = -(1 << 63)
SUFFIX = (". If necessary set spark.rapids.tpu.sql.ansi.enabled to false "
          "to bypass this error.")


class NS:
    def __init__(self, session_mod, arith, cast, types):
        self.col, self.lit = session_mod.col, session_mod.lit
        self.A, self.Cast, self.T = arith, cast, types


PORT = NS(PS, A, Cast, T)
JAX = NS(JS, JA, JCast, JT)


def port_session(ansi: bool, engine: str = "gpu") -> TorchSession:
    conf = {ANSI: ansi}
    if engine == "cpu":
        conf[PROJECT_OFF] = False
        conf["spark.rapids.tpu.sql.exec.Filter"] = False
    return TorchSession(conf, device="cpu")


def jax_session(ansi: bool):
    s = JS.TpuSession()
    s.conf.set(ANSI, ansi)
    return s


def _t(**cols) -> pa.Table:
    return pa.table({k: pa.array(v) for k, v in cols.items()})


def jax_message(table, build) -> str:
    with pytest.raises(JAnsiError) as err:
        build(jax_session(True).create_dataframe(table), JAX).collect(
            engine="tpu")
    return str(err.value)


RAISING = {
    "add": (_t(a=[1, I64MAX], b=[1, 1]),
            lambda n: n.col("a") + n.col("b"), "long overflow"),
    "subtract": (_t(a=[0, I64MIN], b=[5, 1]),
                 lambda n: n.col("a") - n.col("b"), "long overflow"),
    "multiply": (_t(a=[2, 1 << 62], b=[3, 4]),
                 lambda n: n.col("a") * n.col("b"), "long overflow"),
    "multiply_min_by_minus_one": (_t(a=[I64MIN], b=[-1]),
                                  lambda n: n.col("a") * n.col("b"),
                                  "long overflow"),
    "int_add": (pa.table({"a": pa.array([2 ** 31 - 1], pa.int32()),
                          "b": pa.array([1], pa.int32())}),
                lambda n: n.col("a") + n.col("b"), "integer overflow"),
    "divide": (_t(a=[10, 7], b=[2, 0]),
               lambda n: n.col("a") / n.col("b"), "Division by zero"),
    "integral_divide": (_t(a=[10, 7], b=[2, 0]),
                        lambda n: n.A.IntegralDivide(n.col("a"), n.col("b")),
                        "Division by zero"),
    "remainder": (_t(a=[10, 7], b=[2, 0]),
                  lambda n: n.A.Remainder(n.col("a"), n.col("b")),
                  "Division by zero"),
    "pmod": (_t(a=[10, 7], b=[2, 0]),
             lambda n: n.A.Pmod(n.col("a"), n.col("b")), "Division by zero"),
    "cast_double_to_int": (_t(x=[1.5, 3.1e9]),
                           lambda n: n.Cast(n.col("x"), n.T.INT),
                           "value out of range for int"),
    "cast_nan_to_long": (_t(x=[1.0, float("nan")]),
                         lambda n: n.Cast(n.col("x"), n.T.LONG),
                         "value out of range for bigint"),
    "cast_long_to_int": (_t(x=[5, 1 << 40]),
                         lambda n: n.Cast(n.col("x"), n.T.INT),
                         "value out of range for int"),
    "cast_malformed_string": (_t(s=["12", "x9", "34"]),
                              lambda n: n.Cast(n.col("s"), n.T.LONG),
                              "invalid input syntax for type bigint"),
}


@pytest.mark.parametrize("engine", ["gpu", "cpu"])
@pytest.mark.parametrize("case", sorted(RAISING))
def test_ansi_raises_with_the_jax_message(case, engine):
    table, expr, words = RAISING[case]

    def build(df, n):
        return df.select(expr(n).alias("v"))

    df = build(port_session(True, engine).create_dataframe(table), PORT)
    assert len([n for n in df.physical_plan().walk()
                if isinstance(n, CpuFallbackExec)]) == (engine == "cpu")
    with pytest.raises(AnsiError) as err:
        df.collect()
    assert str(err.value) == jax_message(table, build)
    assert str(err.value).startswith(words) and str(err.value).endswith(
        SUFFIX)


@pytest.mark.parametrize("case", sorted(RAISING))
def test_ansi_off_wraps_or_nulls_as_both_jax_engines(case):
    table, expr, _ = RAISING[case]

    def build(df, n):
        return df.select(expr(n).alias("v"))

    got = build(port_session(False).create_dataframe(table), PORT).collect()
    jdf = build(jax_session(False).create_dataframe(table), JAX)
    assert_tables_equal(got, jdf.collect(engine="tpu"), ignore_order=False)
    assert_tables_equal(got, jdf.collect(engine="cpu"), ignore_order=False)


def test_overflow_wraps_when_ansi_off():
    got = port_session(False).create_dataframe(_t(a=[I64MAX], b=[1])).select(
        (PS.col("a") + PS.col("b")).alias("s")).collect()
    assert got.to_pydict()["s"] == [I64MIN]


@pytest.mark.parametrize("engine", ["gpu", "cpu"])
def test_no_overflow_passes_in_ansi(engine):
    t = _t(a=[1, 2, None], b=[10, 20, 30])

    def build(df, n):
        return df.select((n.col("a") + n.col("b")).alias("s"),
                         (n.col("a") * n.col("b")).alias("p"),
                         (n.col("b") / n.col("b")).alias("q"))

    got = build(port_session(True, engine).create_dataframe(t),
                PORT).collect()
    jdf = build(jax_session(True).create_dataframe(t), JAX)
    assert_tables_equal(got, jdf.collect(engine="tpu"), ignore_order=False)
    assert_tables_equal(got, jdf.collect(engine="cpu"), ignore_order=False)


@pytest.mark.parametrize("engine", ["gpu", "cpu"])
def test_ansi_valid_casts_still_work(engine):
    for t, to in ((_t(x=[1.0, -3.7, 2000000.2]), "INT"),
                  (pa.table({"s": pa.array([" 12 ", "-7", None])}), "LONG")):
        def build(df, n):
            return df.select(n.Cast(n.col(t.column_names[0]),
                                    getattr(n.T, to)).alias("i"))

        got = build(port_session(True, engine).create_dataframe(t),
                    PORT).collect()
        assert_tables_equal(got, build(jax_session(True).create_dataframe(
            t), JAX).collect(engine="tpu"), ignore_order=False)


@pytest.mark.parametrize("engine", ["gpu", "cpu"])
def test_null_rows_never_trigger_ansi_errors(engine):
    t = pa.table({"a": pa.array([None, 5], pa.int64()),
                  "b": pa.array([I64MAX, 7], pa.int64()),
                  "z": pa.array([0, None], pa.int64()),
                  "s": pa.array([None, "33"])})

    def build(df, n):
        return df.select((n.col("a") + n.col("b")).alias("s"),
                         n.Cast(n.col("s"), n.T.LONG).alias("i"),
                         n.A.IntegralDivide(n.col("a"), n.col("z")).alias(
                             "d"))

    got = build(port_session(True, engine).create_dataframe(t),
                PORT).collect()
    jdf = build(jax_session(True).create_dataframe(t), JAX)
    assert_tables_equal(got, jdf.collect(engine="tpu"), ignore_order=False)
    assert_tables_equal(got, jdf.collect(engine="cpu"), ignore_order=False)


def test_ansi_long_to_int_pure_integer_check_on_the_cpu_engine():
    """A long past 2^53 raises AnsiError, not a float round trip's
    error."""
    df = port_session(True, "cpu").create_dataframe(_t(x=[1 << 62])).select(
        Cast(PS.col("x"), T.INT).alias("i"))
    with pytest.raises(AnsiError, match="overflow"):
        df.collect()


def test_ansi_in_a_filter_raises():
    t = _t(a=[1, I64MAX], b=[3, 1])
    df = port_session(True).create_dataframe(t).where(
        (PS.col("a") + PS.col("b")) > PS.lit(0))
    with pytest.raises(AnsiError, match="long overflow"):
        df.collect()
    assert port_session(False).create_dataframe(t).where(
        (PS.col("a") + PS.col("b")) > PS.lit(0)).collect().num_rows == 1


@pytest.mark.parametrize("where,build", [
    ("sort key", lambda df: df.order_by(PS.col("a") + PS.col("b"))),
    ("grouping key", lambda df: df.group_by(
        PS.col("a") + PS.col("b")).agg((PS.count_star(), "n"))),
    ("aggregate input", lambda df: df.group_by(PS.col("b")).agg(
        (PS.sum_(PS.col("a") + PS.col("b")), "n"))),
])
def test_ansi_risky_expression_outside_project_filter_runs_on_the_cpu(
        where, build):
    """The JAX ``test_ansi_risky_expr_outside_fused_positions_falls_back``:
    the node goes to the CPU engine, with the JAX reason, and raises."""
    t = _t(a=[1, I64MAX], b=[3, 1])
    q = build(port_session(True).create_dataframe(t))
    assert f"ANSI-checked expression as {where} only runs on the GPU " \
        "inside project/filter" in q.explain()
    with pytest.raises(AnsiError):
        q.collect()
    off = build(port_session(False).create_dataframe(t))
    assert "ANSI-checked" not in off.explain()
    assert not [n for n in off.physical_plan().walk()
                if isinstance(n, CpuFallbackExec)]


def test_ansi_join_key_runs_on_the_cpu_engine():
    s = port_session(True)
    left = s.create_dataframe(_t(a=[1, 2], b=[3, 4]))
    right = s.create_dataframe(_t(k=[4, 6]))
    q = left.join(right, left_on=[PS.col("a") + PS.col("b")],
                  right_on=[PS.col("k")])
    assert "ANSI-checked expression as join key" in q.explain()
    assert q.collect().num_rows == 2


def test_a_filter_pushes_no_ansi_checked_conjunct(tmp_path):
    p = str(tmp_path / "f.parquet")
    pq.write_table(_t(a=[1, 2, 3, I64MAX], b=[1, 1, 1, 1]), p)

    def build(s):
        return s.read_parquet(p).where(
            (PS.col("a") > PS.lit(1)) & ((PS.col("a") + PS.col("b"))
                                         > PS.lit(0)))

    on = build(port_session(True))
    text = on.explain()
    assert "pushed=[GreaterThan(a, 1)]" in text, text
    assert "elided" not in text and "TpuFilterExec" in text
    with pytest.raises(AnsiError):
        on.collect()
    off = build(port_session(False))
    assert "pushed=[And(GreaterThan(a, 1), GreaterThan(Add(a, b), 0))]" \
        in off.explain()
    assert off.collect().num_rows == 2


def _count_syncs(monkeypatch, q) -> tuple:
    calls = [0]
    item = torch.Tensor.item

    def counting(self):
        calls[0] += 1
        return item(self)

    monkeypatch.setattr(torch.Tensor, "item", counting)
    polls = B.ansi_polls()
    q.collect()
    monkeypatch.setattr(torch.Tensor, "item", item)
    return calls[0], B.ansi_polls() - polls


def test_ansi_off_adds_no_sync_and_on_polls_once_a_batch(monkeypatch):
    rng = np.random.default_rng(2)
    t = pa.table({"a": rng.integers(-1000, 1000, 1000),
                  "b": rng.integers(1, 1000, 1000)})
    rows = "spark.rapids.tpu.sql.batchSizeRows"

    def session(ansi):
        return TorchSession({ANSI: ansi, rows: 256}, device="cpu")

    def plain(s):
        return s.create_dataframe(t).select(PS.col("a").alias("v"))

    def risky(s):
        return s.create_dataframe(t).select(
            (PS.col("a") * PS.col("b") + PS.col("a")).alias("v"))

    base_items, base_polls = _count_syncs(monkeypatch, plain(session(False)))
    off_items, off_polls = _count_syncs(monkeypatch, risky(session(False)))
    assert (off_items, off_polls) == (base_items, base_polls)
    assert off_polls == 0
    on_items, on_polls = _count_syncs(monkeypatch, risky(session(True)))
    assert on_polls == 4  # one a batch: 1000 rows in batches of 256
    assert on_items == base_items + 4
    assert risky(session(True)).collect().equals(
        risky(session(False)).collect())
