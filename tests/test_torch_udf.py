"""The three UDF tiers against the JAX package.

Counterparts of the nine tests of the JAX package's ``tests/
test_udf.py``, with ``torch_udf`` in place of ``jax_udf`` (the same
function written in torch and in jnp): the compiler's arithmetic,
ternaries, if/return chains with ``None``, string methods, ``in`` and
chained comparisons, and the cast to a declared type, each compiled in
both packages and held against both JAX engines; the columnar UDF on
the device path (and on the port's CPU engine); a string input that
sends a torch UDF's node to the CPU engine; the opaque UDF on the CPU
engine, row by row; a function that does not compile and names no type.
Besides: a torch UDF whose result has another shape or lies on another
device raises, and ``explain()`` names each UDF's tier.
"""

import math

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.udf import jax_udf
from spark_rapids_tpu.udf import udf as judf

from differential import assert_tables_equal, gen_table
from spark_rapids_tpu_torch import TorchSession, col
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.cpu.engine import execute_cpu
from spark_rapids_tpu_torch.execs.fallback import CpuFallbackExec
from spark_rapids_tpu_torch.udf import UncompilableUDF, torch_udf, udf
from test_torch_q1 import _significant


@pytest.fixture(scope="module")
def sessions():
    return TorchSession(device="cpu"), TpuSession()


def _hold(got, jdf, approx_float=False):
    """Against both JAX engines; floats to 12 significant digits (an
    extreme value's square root differs in its last bits)."""
    for engine in ("tpu", "cpu"):
        want = jdf.collect(engine=engine)
        if approx_float:
            got, want = _significant(got), _significant(want)
        assert_tables_equal(got, want, ignore_order=False,
                            approx_float=approx_float)


def _no_cpu_node(df) -> None:
    text = df.explain()
    assert "CpuFallback" not in text
    assert not any(ln.lstrip().startswith("!") for ln in text.splitlines())


def _hyp(x, y):
    return math.sqrt(x * x + y * y) if x > 0 else 0.0


def test_compiled_arithmetic_ternary(sessions):
    ps, js = sessions
    hyp, jhyp = udf(T.DOUBLE)(_hyp), judf(JT.DOUBLE)(_hyp)
    assert hyp.tier == "compiled"
    t = gen_table({"a": "float64", "b": "float64"}, 300, seed=1)
    q = ps.create_dataframe(t).select(hyp(col("a"), col("b")).alias("h"))
    _no_cpu_node(q)
    _hold(q.collect(), js.create_dataframe(t).select(
        jhyp(jcol("a"), jcol("b")).alias("h")), approx_float=True)


def _bucket(x):
    if x is None:
        return -1
    if x < 10:
        return 0
    if x < 100:
        return 1
    return 2


def test_compiled_if_return_chain_and_none(sessions):
    ps, js = sessions
    bucket, jbucket = udf()(_bucket), judf()(_bucket)
    assert bucket.tier == "compiled"
    t = gen_table({"a": "int64"}, 500, seed=2)
    q = ps.create_dataframe(t).select(bucket(col("a")).alias("b"))
    _no_cpu_node(q)
    got = q.collect()
    _hold(got, js.create_dataframe(t).select(jbucket(jcol("a")).alias("b")))
    assert got.column("b").to_pylist() == [
        _bucket(v) for v in t.column("a").to_pylist()]


def _norm(s):
    return s.strip().upper() if s.startswith("a") else s.lower()


def test_compiled_string_methods(sessions):
    ps, js = sessions
    norm, jnorm = udf()(_norm), judf()(_norm)
    assert norm.tier == "compiled"
    t = pa.table({"s": pa.array(["abc", " aX ", "Hello", None, "a"])})
    q = ps.create_dataframe(t).select(norm(col("s")).alias("n"))
    _hold(q.collect(), js.create_dataframe(t).select(
        jnorm(jcol("s")).alias("n")))


def _in_range(x):
    return (0 < x < 50) or x in [100, 200]


def test_compiled_in_and_chained_compare(sessions):
    ps, js = sessions
    f, jf = udf()(_in_range), judf()(_in_range)
    assert f.tier == "compiled"
    t = gen_table({"a": "int64"}, 300, seed=3)
    q = ps.create_dataframe(t).select(f(col("a")).alias("m"))
    _no_cpu_node(q)
    _hold(q.collect(), js.create_dataframe(t).select(jf(jcol("a")).alias("m")))


@torch_udf(T.DOUBLE)
def smooth(x, y):
    return torch.tanh(x) * 0.5 + torch.abs(y) * 0.25


@jax_udf(JT.DOUBLE)
def jsmooth(x, y):
    return jnp.tanh(x) * 0.5 + jnp.abs(y) * 0.25


def test_torch_udf_columnar(sessions):
    ps, js = sessions
    assert smooth.tier == "torch"
    t = gen_table({"a": "float64", "b": "float64"}, 200, seed=4)
    q = ps.create_dataframe(t).select(smooth(col("a"), col("b")).alias("s"))
    _no_cpu_node(q)
    assert "udf smooth: tier torch" in q.explain()
    got = q.collect()
    _hold(got, js.create_dataframe(t).select(
        jsmooth(jcol("a"), jcol("b")).alias("s")), approx_float=True)
    # the port's CPU engine runs it on CPU tensors of the same values
    assert_tables_equal(execute_cpu(q._plan), got, ignore_order=False,
                        approx_float=True)


@torch_udf(T.LONG)
def broken(s):
    return torch.zeros_like(s)


@jax_udf(JT.LONG)
def jbroken(s):
    return jnp.zeros_like(s)


def test_torch_udf_string_input_falls_back(sessions):
    """A torch UDF sees fixed-width tensors: a string argument sends its
    node to the CPU engine at tagging, as in JAX."""
    ps, js = sessions
    t = pa.table({"s": pa.array(["a", "bb", None])})
    q = ps.create_dataframe(t).select(broken(col("s")).alias("z"))
    jq = js.create_dataframe(t).select(jbroken(jcol("s")).alias("z"))
    for text in (q.explain(), jq.explain()):
        assert any(ln.lstrip().startswith("!") for ln in text.splitlines())
    assert isinstance(q.physical_plan(), CpuFallbackExec)


_LOOKUP = {1: "one", 2: "two"}


def _name_of(x):
    return _LOOKUP.get(x, "other")


def test_opaque_fallback(sessions):
    ps, js = sessions
    name_of, jname_of = udf(T.STRING)(_name_of), judf(JT.STRING)(_name_of)
    assert name_of.tier == "opaque"
    t = pa.table({"a": pa.array([1, 2, 3, None], pa.int64())})
    q = ps.create_dataframe(t).select(name_of(col("a")).alias("n"))
    text = q.explain()
    assert "! Project [n]" in text
    assert "expression OpaquePythonUDF is not supported on the GPU" in text
    assert "udf _name_of: tier opaque" in text
    plan = q.physical_plan()
    got = q.collect()
    assert got.column("n").to_pylist() == ["one", "two", "other", "other"]
    _hold(got, js.create_dataframe(t).select(jname_of(jcol("a")).alias("n")))
    fb = [n for n in plan.walk() if isinstance(n, CpuFallbackExec)]
    assert len(fb) == 1


def test_uncompilable_without_type_raises():
    with pytest.raises((TypeError, UncompilableUDF)):
        @udf()
        def bad(x):
            return {"a": x}  # a dict is no expression


def _plus1(x):
    return x + 1


def test_compiled_cast_to_declared_type(sessions):
    ps, js = sessions
    plus1, jplus1 = udf(T.DOUBLE)(_plus1), judf(JT.DOUBLE)(_plus1)
    t = gen_table({"a": "int64"}, 50, seed=5, null_prob=0.0)
    got = ps.create_dataframe(t).select(plus1(col("a")).alias("p")).collect()
    assert got.schema.field("p").type == pa.float64()
    _hold(got, js.create_dataframe(t).select(jplus1(jcol("a")).alias("p")))


@torch_udf(T.LONG)
def wrong_shape(x):
    return x[:1]


@torch_udf(T.LONG)
def wrong_device(x):
    return x.to("meta")


@pytest.mark.parametrize("fn,match", [(wrong_shape, "shape"),
                                      (wrong_device, "on meta")])
def test_a_torch_udf_result_is_never_moved_or_reshaped(sessions, fn, match):
    ps, _ = sessions
    t = pa.table({"a": pa.array([1, 2, 3], pa.int64())})
    with pytest.raises(ValueError, match=match):
        ps.create_dataframe(t).select(fn(col("a")).alias("x")).collect()


@torch_udf(T.INT)
def add_cols(x, y):
    return x + y


def test_a_torch_udf_row_is_null_when_an_input_is(sessions):
    ps, _ = sessions
    t = pa.table({"a": pa.array([1, None, 3], pa.int64()),
                  "b": pa.array([10, 20, None], pa.int64())})
    q = ps.create_dataframe(t).select(add_cols(col("a"), col("b")).alias("s"))
    got = q.collect()
    assert got.schema.field("s").type == pa.int32()
    assert got.column("s").to_pylist() == [11, None, None]
    assert execute_cpu(q._plan).equals(got)


def test_udfs_in_a_filter_and_beside_each_other(sessions):
    """All three tiers in one plan: the compiled and torch UDFs on the
    device path, the opaque one in the one CPU node."""
    ps, _ = sessions
    plus1, name_of = udf(T.DOUBLE)(_plus1), udf(T.STRING)(_name_of)
    t = pa.table({"a": pa.array(np.arange(10) % 4, pa.int64()),
                  "b": pa.array(np.linspace(-1, 1, 10))})
    df = ps.create_dataframe(t).where(plus1(col("a")) > 1.5).select(
        smooth(col("b"), col("b")).alias("s"), name_of(col("a")).alias("n"))
    text = df.explain()
    assert "udf smooth: tier torch" in text
    assert "udf _name_of: tier opaque" in text
    got = df.collect()
    want = [(math.tanh(b) * 0.5 + abs(b) * 0.25, _LOOKUP.get(a, "other"))
            for a, b in zip(t["a"].to_pylist(), t["b"].to_pylist())
            if a + 1 > 1.5]
    assert [(round(s, 12), n) for s, n in zip(
        got.column("s").to_pylist(), got.column("n").to_pylist())] == [
        (round(s, 12), n) for s, n in want]


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
