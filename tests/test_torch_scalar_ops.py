"""Operators over the scalar types: the port against the JAX package.

- Sort: ORDER BY a TINYINT, SMALLINT, FLOAT (NaN, -0.0, +/-inf),
  TIMESTAMP (before 1970) and DECIMAL (negatives) key, ascending and
  descending, over three scan tasks (a range exchange whose bounds are
  rows of those types), against the JAX engine, order included.
- Group-by: the same columns as keys over an exchange (K1's plain
  version hashing them), FLOAT keys on the sort path (-0.0 one group
  with 0.0, every NaN one group), against the JAX engine.
- Window: rank over a TIMESTAMP order and a bounded RANGE frame over a
  FLOAT order key, partitioned by a SMALLINT, against the JAX engine.
- The CPU engine: the same plans through the port's
  ``cpu/engine.execute_cpu`` against the JAX engine's results.
- The scan's host path: a filter on a TIMESTAMP and on a DECIMAL column
  prunes row groups by their footer statistics, compiles to the host
  prefilter (``io/pa_filter.py``), runs with the native decoder on and
  off, and gives pyarrow's rows.
Exact, but the averages and float sums of a frame (9 decimals).
"""

import datetime as dt
import decimal

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.execs.sort import SortKey as JSortKey
from spark_rapids_tpu.exprs import window as JWX
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import count_star as jcount_star
from spark_rapids_tpu.session import max_ as jmax
from spark_rapids_tpu.session import sum_ as jsum

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import session as PS
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.cpu.engine import execute_cpu
from spark_rapids_tpu_torch.execs.sort import SortKey
from spark_rapids_tpu_torch.exprs import window as WX
from spark_rapids_tpu_torch.exprs.base import Literal
from spark_rapids_tpu_torch.io import pa_filter
from spark_rapids_tpu_torch.exprs.base import bind_references
from spark_rapids_tpu_torch.io.scan import ParquetScanExec

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
D = decimal.Decimal
UTC = dt.timezone.utc
KEYS = ["b", "h", "f", "t", "d"]


def _table(n=600, seed=12):
    rng = np.random.default_rng(seed)

    def mask():
        return rng.random(n) < 0.15

    f = np.round(rng.normal(0, 4, n)).astype(np.float32)
    f[::17] = -0.0
    f[1::19] = np.nan
    f[2::23] = np.inf
    f[3::29] = -np.inf
    f.view(np.int32)[4::31] = 0x7FC00001
    b = rng.integers(-4, 4, n).astype(np.int8)
    b[::37] = -128
    return pa.table({
        "b": pa.array(b, mask=mask()),
        "h": pa.array(rng.integers(-3, 3, n).astype(np.int16)),
        "f": pa.array(f, mask=mask()),
        "t": pa.array(rng.integers(-4, 4, n) * 3_600_000_000_000,
                      pa.timestamp("us", tz="UTC"), mask=mask()),
        "d": pa.array([D(int(v)).scaleb(-2) for v in
                       rng.integers(-500, 500, n)], pa.decimal128(9, 2),
                      mask=mask()),
        "v": pa.array(rng.integers(0, 100, n)),
    })


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("scalar_ops")
    t = _table()
    out = []
    for i in range(3):
        p = str(d / f"part-{i}.parquet")
        pq.write_table(t.slice(i * 200, 200), p, store_decimal_as_integer=True)
        out.append(p)
    return out


def _sessions(paths):
    return (TorchSession({TTB: 1}, device="cpu").read_parquet(*paths),
            TpuSession().read_parquet(*paths))


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
def test_order_by_equals_jax(paths, key, desc):
    port, jax = _sessions(paths)
    # v breaks the key's ties, so the order is fixed
    df = port.order_by(SortKey(PS.col(key), descending=desc),
                       SortKey(PS.col("v")), SortKey(PS.col("h")),
                       SortKey(PS.col("b")))
    got = df.collect()
    want = jax.order_by(JSortKey(jcol(key), descending=desc),
                        JSortKey(jcol("v")), JSortKey(jcol("h")),
                        JSortKey(jcol("b"))).collect(engine="tpu")
    assert "RangePartitioning" in df.physical_plan().tree_string() \
        or "range" in df.physical_plan().tree_string().lower()
    got_k, want_k = got.column(key), want.column(key)
    if key == "f":  # NaN payloads print alike; compare the values' order
        got_k, want_k = [str(v) for v in got_k.to_pylist()], \
            [str(v) for v in want_k.to_pylist()]
    else:
        got_k, want_k = got_k.to_pylist(), want_k.to_pylist()
    assert got_k == want_k
    assert got.column("v").to_pylist() == want.column("v").to_pylist()
    cpu = execute_cpu(df._plan)
    assert cpu.column("v").to_pylist() == want.column("v").to_pylist()


@pytest.mark.parametrize("keys", [["b", "h"], ["f"], ["t", "d"],
                                  ["b", "h", "f", "t", "d"]],
                         ids=lambda k: "+".join(k))
def test_group_by_keys_equal_jax(paths, keys):
    port, jax = _sessions(paths)
    df = port.group_by(*[PS.col(k) for k in keys]).agg(
        (PS.count_star(), "n"), (PS.sum_(PS.col("v")), "s"),
        (PS.max_(PS.col("f")), "mf"))
    got = df.collect()
    assert "Exchange" in df.physical_plan().tree_string()
    want = jax.group_by(*[jcol(k) for k in keys]).agg(
        (jcount_star(), "n"), (jsum(jcol("v")), "s"),
        (jmax(jcol("f")), "mf")).collect(engine="tpu")
    assert_tables_equal(got, want)
    # and the port's CPU engine, on the same logical plan
    assert_tables_equal(execute_cpu(df._plan), want)


def test_window_over_new_types_equals_jax(paths):
    port, jax = _sessions(paths)

    def wins(ns, F, col):
        w = ns.Window.partition_by(col("h")).order_by(col("t"))
        r = ns.Window.partition_by(col("h")).order_by(col("f")) \
            .range_between(-2, 1)
        return [ns.rank().over(w).alias("r"),
                F.sum_(col("v")).over(r).alias("s")]

    from spark_rapids_tpu import session as JF

    got_df = port.select(PS.col("h"), PS.col("t"), PS.col("f"),
                         PS.col("v"), *wins(WX, PS, PS.col))
    got = got_df.collect()
    want = jax.select(jcol("h"), jcol("t"), jcol("f"), jcol("v"),
                      *wins(JWX, JF, jcol)).collect(engine="tpu")
    assert "!" not in got_df.explain()
    assert_tables_equal(got, want, approx_float=True)
    assert_tables_equal(execute_cpu(got_df._plan), want, approx_float=True)


def _written(tmp_path):
    """4000 rows sorted on ``t`` (its NULL rows left out: a row group of
    NULLs alone is outside the native decoder's scope) in row groups of
    500."""
    t = _table(4000, 21)
    t = t.filter(pc.is_valid(t["t"])).sort_by([("t", "ascending")])
    p = str(tmp_path / "sorted.parquet")
    pq.write_table(t, p, row_group_size=500, store_decimal_as_integer=True)
    return t, p


@pytest.mark.parametrize("fast", [False, True], ids=["pyarrow", "fastpar"])
@pytest.mark.parametrize("which", ["timestamp", "decimal"])
def test_filters_on_new_types_prune_and_prefilter(tmp_path, fast, which):
    t, p = _written(tmp_path)
    if which == "timestamp":
        lit = Literal(dt.datetime(1970, 1, 1, 2, tzinfo=UTC), T.TIMESTAMP)
        cond = PS.col("t") >= lit
        mask = pc.greater_equal(t["t"], pa.scalar(
            dt.datetime(1970, 1, 1, 2, tzinfo=UTC),
            pa.timestamp("us", tz="UTC")))
    else:
        lit = Literal(D("1.25"), T.DecimalType(9, 2))
        cond = PS.col("d") < lit
        mask = pc.less(t["d"], pa.scalar(D("1.25"), pa.decimal128(9, 2)))
    s = TorchSession({C.FAST_DECODE: fast}, device="cpu")
    df = s.read_parquet(p).where(cond)
    plan = df.physical_plan()
    scan = next(n for n in plan.walk() if isinstance(n, ParquetScanExec))
    assert scan._pa_filter is not None  # compiled for the host
    got = df.collect()
    assert_tables_equal(got, t.filter(pc.fill_null(mask, False)),
                        ignore_order=False)
    list(scan.execute())
    if which == "timestamp":  # the file is sorted on t: groups prune
        assert scan.metrics["rowGroupsPruned"] > 0
    assert scan.metrics["fastDecodedFiles"] == int(fast)


def test_compiled_filter_equals_the_cpu_engine():
    from spark_rapids_tpu_torch.cpu.engine import cpu_eval

    t = _table(300, 5)
    schema = TorchSession(device="cpu").create_dataframe(t).schema
    some = t["d"].drop_null()[0].as_py()
    for cond in (PS.col("t") < Literal(0, T.TIMESTAMP),
                 PS.col("d").eq(Literal(some, T.DecimalType(9, 2))),
                 PS.col("d") >= PS.col("d"),
                 PS.col("f") > Literal(1.0, T.DOUBLE)):
        bound = bind_references(cond, schema)
        fn = pa_filter.compile_filter(bound)
        assert fn is not None, cond
        got = pc.fill_null(fn(t), False).to_pylist()
        want = pc.fill_null(cpu_eval(bound, t), False).to_pylist()
        assert got == want and any(got), cond
