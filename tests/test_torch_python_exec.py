"""The Python worker pool and the six Python execs against the JAX
package.

Counterparts of the JAX package's ``tests/test_python_worker.py`` (the
pool: a persistent child, a user error that leaves the worker alive;
mapInArrow) and ``tests/test_pandas_execs.py`` (mapInPandas,
applyInPandas over one partition and over a hash exchange,
agg_in_pandas, transform_in_pandas, cogroup, the keyless aggregate, the
CPU engine's run of the same wrappers), each result held against the
JAX package's ``engine="tpu"`` and ``engine="cpu"`` under
``assert_tables_equal`` (floats with ``approx_float``).  Besides: a
worker that dies is replaced, and the child imports neither torch nor
JAX and sees no card (``CUDA_VISIBLE_DEVICES`` empty).

The user functions live in ``torch_python_fns.py``, which imports
neither package, since the children import it to unpickle them.  Each
port collect starts at most one worker here (one partition a run, or
one at a time), and the pool tests share a module-scoped pool.
"""

import collections

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol

import torch_python_fns as F
from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession, col
from spark_rapids_tpu_torch.execs.fallback import CpuFallbackExec
from spark_rapids_tpu_torch.execs.python_exec import (
    TpuFlatMapGroupsInPandasExec,
    TpuMapInArrowExec,
    TpuMapInPandasExec,
)
from spark_rapids_tpu_torch.python_worker import PythonWorkerPool, UdfError
from spark_rapids_tpu_torch.exprs.base import lit

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
KV = pa.schema([("k", pa.int64()), ("v", pa.int64())])
SUMMARY = pa.schema([("k", pa.int64()), ("total", pa.int64()),
                     ("n", pa.int64())])
COGROUP = pa.schema([("k", pa.int64()), ("nl", pa.int64()),
                     ("nr", pa.int64()), ("sum_both", pa.float64())])


@pytest.fixture(scope="module")
def sessions():
    return TorchSession(device="cpu"), TpuSession()


@pytest.fixture(scope="module")
def double_pool():
    pool = PythonWorkerPool(F.double_v, max_workers=1)
    yield pool
    pool.close()


def _table(n=600, seed=3, nulls=False):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 6, n)
    v = rng.integers(0, 100, n)
    if nulls:
        k = pa.array([None if rng.random() < 0.1 else int(x) for x in k],
                     pa.int64())
    return pa.table({"k": k, "v": pa.array(v)})


def _hold(got, jdf, approx_float=False, ignore_order=True):
    """The port's table against both JAX engines' runs of ``jdf``."""
    for engine in ("tpu", "cpu"):
        assert_tables_equal(got, jdf.collect(engine=engine),
                            ignore_order=ignore_order,
                            approx_float=approx_float)


# ---------------------------------------------------------------------- #
# the pool (test_python_worker.py)
# ---------------------------------------------------------------------- #

def test_pool_runs_udf_in_subprocess(double_pool):
    t = pa.table({"v": [1.0, 2.5, -3.0]})
    assert double_pool.run(t).column("v").to_pylist() == [2.0, 5.0, -6.0]
    assert double_pool.run(t).num_rows == 3  # the same, persistent worker
    assert double_pool.spawns == 1


def test_udf_error_surfaces_and_worker_survives():
    pool = PythonWorkerPool(F.raises_on_negative, max_workers=1)
    try:
        with pytest.raises(UdfError, match="negative input"):
            pool.run(pa.table({"v": [-1.0]}))
        assert pool.run(pa.table({"v": [1.0]})).num_rows == 1
        assert pool.spawns == 1
    finally:
        pool.close()


def test_a_dead_worker_is_replaced():
    pool = PythonWorkerPool(F.child_facts, max_workers=1)
    try:
        first = pool.run(pa.table({"x": [1]})).column("pid").to_pylist()
        pool.kill_idle()
        again = pool.run(pa.table({"x": [1]})).column("pid").to_pylist()
        assert again != first and pool.spawns == 2
    finally:
        pool.close()


def test_the_child_imports_no_torch_and_sees_no_card(sessions):
    ps, _ = sessions
    t = pa.table({"x": [1, 2]})
    out = ps.create_dataframe(t).map_in_arrow(F.child_facts, pa.schema([
        ("torch", pa.bool_()), ("jax", pa.bool_()),
        ("cuda_visible", pa.string()), ("pid", pa.int64())])).collect()
    assert out.column("torch").to_pylist() == [False]
    assert out.column("jax").to_pylist() == [False]
    assert out.column("cuda_visible").to_pylist() == [""]


def test_map_in_arrow_differential(sessions):
    ps, js = sessions
    rng = np.random.default_rng(41)
    t = pa.table({"k": rng.integers(0, 5, 500), "v": rng.random(500)})
    df = ps.create_dataframe(t).where(col("v") > lit(0.2)) \
        .map_in_arrow(F.double_v, t.schema)
    got = df.collect()
    assert got.num_rows > 0
    jdf = js.create_dataframe(t).where(jcol("v") > 0.2) \
        .map_in_arrow(F.double_v, t.schema)
    _hold(got, jdf, approx_float=True)
    exec_ = df.physical_plan()
    assert isinstance(exec_, TpuMapInArrowExec)


def test_map_in_arrow_can_grow_rows(sessions):
    ps, js = sessions
    t = pa.table({"k": [1, 2], "v": [0.5, 0.75]})
    got = ps.create_dataframe(t).map_in_arrow(F.grow_rows, t.schema).collect()
    assert got.num_rows == 4
    _hold(got, js.create_dataframe(t).map_in_arrow(F.grow_rows, t.schema))


def test_explain_shows_python_exec(sessions):
    ps, _ = sessions
    t = pa.table({"k": [1], "v": [1.0]})
    text = ps.create_dataframe(t).map_in_arrow(F.double_v, t.schema).explain()
    assert "* MapInArrow [double_v]" in text
    assert "TpuMapInArrowExec [double_v]" in text


# ---------------------------------------------------------------------- #
# the pandas execs (test_pandas_execs.py)
# ---------------------------------------------------------------------- #

def test_map_in_pandas(sessions):
    ps, js = sessions
    t = _table()
    df = ps.create_dataframe(t).map_in_pandas(F.double_frame, KV)
    got = df.collect()
    assert got.column("v").to_pylist() == [v * 2 for v in t["v"].to_pylist()]
    assert "MapInPandas" in df.explain()
    _hold(got, js.create_dataframe(t).map_in_pandas(F.double_frame, KV),
          ignore_order=False)


def test_apply_in_pandas_grouped(sessions):
    ps, js = sessions
    t = _table(nulls=True)
    got = ps.create_dataframe(t).group_by("k").apply_in_pandas(
        F.group_summary, SUMMARY).collect()
    want = collections.defaultdict(lambda: [0, 0])
    for k, v in zip(t["k"].to_pylist(), t["v"].to_pylist()):
        want[k][0] += v
        want[k][1] += 1
    assert {r["k"]: (r["total"], r["n"]) for r in got.to_pylist()} == {
        k: tuple(v) for k, v in want.items()}
    _hold(got, js.create_dataframe(t).group_by(jcol("k")).apply_in_pandas(
        F.group_summary, SUMMARY))


def test_apply_in_pandas_multi_partition_exchange(sessions, tmp_path):
    """Five scan tasks: the planner puts a hash exchange on the key under
    the exec, so each group is whole in one worker call."""
    _, js = sessions
    t = _table(3000, seed=9)
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"p{i}.parquet"))
        pq.write_table(t.slice(i * 600, 600), paths[-1])
    ps = TorchSession({TTB: 1}, device="cpu")
    df = ps.read_parquet(*paths).group_by("k").apply_in_pandas(
        F.group_summary, SUMMARY)
    tree = df.physical_plan().tree_string()
    assert "TpuFlatMapGroupsInPandasExec" in tree, tree
    assert "TpuShuffleExchangeExec" in tree, tree
    got = df.collect()
    assert {r["k"]: r["n"] for r in got.to_pylist()} == collections.Counter(
        t["k"].to_pylist())
    _hold(got, js.read_parquet(*paths).group_by(jcol("k")).apply_in_pandas(
        F.group_summary, SUMMARY))


def test_aggregate_in_pandas(sessions):
    ps, js = sessions
    t = _table()
    got = ps.create_dataframe(t).group_by("k").agg_in_pandas(
        ("span", F.span, "v"), ("m", F.mean, "v")).collect()
    assert got.column_names == ["k", "span", "m"]
    kk, vv = t["k"].to_pylist(), t["v"].to_pylist()
    for r in got.to_pylist():
        vs = [v for k, v in zip(kk, vv) if k == r["k"]]
        assert r["span"] == max(vs) - min(vs)
        assert abs(r["m"] - sum(vs) / len(vs)) < 1e-9
    _hold(got, js.create_dataframe(t).group_by(jcol("k")).agg_in_pandas(
        ("span", F.span, "v"), ("m", F.mean, "v")), approx_float=True)


def test_window_in_pandas_unbounded(sessions):
    ps, js = sessions
    t = _table(400, seed=11)
    got = ps.create_dataframe(t).group_by("k").transform_in_pandas(
        ("gmean", F.mean, "v")).collect()
    assert got.num_rows == 400 and got.column_names == ["k", "v", "gmean"]
    kk, vv = t["k"].to_pylist(), t["v"].to_pylist()
    for r in got.to_pylist():
        vs = [v for k, v in zip(kk, vv) if k == r["k"]]
        assert abs(r["gmean"] - sum(vs) / len(vs)) < 1e-9
    _hold(got, js.create_dataframe(t).group_by(jcol("k")).transform_in_pandas(
        ("gmean", F.mean, "v")), approx_float=True)


def test_grouped_pandas_cpu_engine_matches(sessions):
    """The port's CPU engine runs the same wrappers: the node sent there
    by its switch gives the device path's rows and the JAX engines'."""
    ps, js = sessions
    t = _table(300, seed=13)
    got = ps.create_dataframe(t).group_by("k").agg_in_pandas(
        ("span", F.span, "v")).collect()
    off = TorchSession({"spark.rapids.tpu.sql.exec.GroupedPandas": False},
                       device="cpu")
    df = off.create_dataframe(t).group_by("k").agg_in_pandas(
        ("span", F.span, "v"))
    assert isinstance(df.physical_plan(), CpuFallbackExec)
    assert "! GroupedPandas[agg]" in df.explain()
    assert_tables_equal(df.collect(), got)
    _hold(got, js.create_dataframe(t).group_by(jcol("k")).agg_in_pandas(
        ("span", F.span, "v")))


def test_udf_error_surfaces(sessions):
    ps, _ = sessions
    df = ps.create_dataframe(_table(50)).map_in_pandas(F.failing, KV)
    with pytest.raises(UdfError, match="user code exploded"):
        df.collect()


def test_cogroup_apply_in_pandas(sessions):
    """Keys on only one side still make a group."""
    ps, js = sessions
    rng = np.random.default_rng(17)
    left = pa.table({"k": rng.integers(0, 5, 400),
                     "v": rng.integers(0, 50, 400)})
    right = pa.table({"k": pa.array([0, 1, 2, 9, 9]),
                      "w": pa.array([10, 20, 30, 40, 50])})
    got = ps.create_dataframe(left).group_by("k").cogroup(
        ps.create_dataframe(right).group_by("k")).apply_in_pandas(
            F.cogroup_merge, COGROUP).collect()
    rows = {r["k"]: r for r in got.to_pylist()}
    lc = collections.Counter(left["k"].to_pylist())
    for k in set(lc) | {9}:
        assert rows[k]["nl"] == lc.get(k, 0)
    assert rows[9]["nr"] == 2 and rows[9]["sum_both"] == 90.0
    _hold(got, js.create_dataframe(left).group_by(jcol("k")).cogroup(
        js.create_dataframe(right).group_by(jcol("k"))).apply_in_pandas(
            F.cogroup_merge, COGROUP))


def test_cogroup_different_key_names_and_big_int_keys(sessions):
    """The right side groups by its own key names, and int64 keys past
    2^53 stay exact."""
    ps, js = sessions
    big = 2 ** 53
    left = pa.table({"id": pa.array([big, big + 1], pa.int64()),
                     "v": pa.array([1, 2])})
    right = pa.table({"rid": pa.array([big + 1], pa.int64()),
                      "w": pa.array([10])})
    schema = pa.schema([("id", pa.int64()), ("nl", pa.int64()),
                        ("nr", pa.int64())])
    got = ps.create_dataframe(left).group_by("id").cogroup(
        ps.create_dataframe(right).group_by("rid")).apply_in_pandas(
            F.cg_diffkeys, schema).collect()
    assert {r["id"]: (r["nl"], r["nr"]) for r in got.to_pylist()} == {
        big: (1, 0), big + 1: (1, 1)}
    _hold(got, js.create_dataframe(left).group_by(jcol("id")).cogroup(
        js.create_dataframe(right).group_by(jcol("rid"))).apply_in_pandas(
            F.cg_diffkeys, schema))


def test_keyless_grouped_pandas(sessions):
    ps, js = sessions
    t = pa.table({"k": pa.array([1, 2]), "v": pa.array([3.0, 5.0])})
    got = ps.create_dataframe(t).group_by().agg_in_pandas(
        ("m", F.mean, "v")).collect()
    assert got.to_pylist() == [{"m": 4.0}]
    _hold(got, js.create_dataframe(t).group_by().agg_in_pandas(
        ("m", F.mean, "v")))


def test_map_in_pandas_plans_dedicated_exec(sessions):
    ps, js = sessions
    t = _table(50)
    df = ps.create_dataframe(t).map_in_pandas(F.double_frame, KV)
    assert isinstance(df.physical_plan(), TpuMapInPandasExec)
    off = TorchSession({"spark.rapids.tpu.sql.exec.MapInArrow": False},
                       device="cpu")
    cpu = off.create_dataframe(t).map_in_pandas(F.double_frame, KV)
    assert isinstance(cpu.physical_plan(), CpuFallbackExec)
    got = cpu.collect()
    assert got.column("v").to_pylist() == [v * 2 for v in t["v"].to_pylist()]
    _hold(got, js.create_dataframe(t).map_in_pandas(F.double_frame, KV),
          ignore_order=False)


def test_grouped_exec_reuses_a_hash_distribution(sessions, tmp_path):
    """A grouped exec over a child already hash-distributed on its keys
    (an aggregate's exchange) takes no second exchange."""
    from spark_rapids_tpu_torch import sum_
    from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec

    t = _table(1200, seed=21)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"a{i}.parquet"))
        pq.write_table(t.slice(i * 400, 400), paths[-1])
    ps = TorchSession({TTB: 1}, device="cpu")
    df = ps.read_parquet(*paths).group_by("k").agg(
        (sum_(col("v")), "v")).group_by("k").apply_in_pandas(
            F.group_summary, SUMMARY)
    plan = df.physical_plan()
    assert isinstance(plan, TpuFlatMapGroupsInPandasExec)
    assert sum(isinstance(n, TpuShuffleExchangeExec)
               for n in plan.walk()) == 1
    got = df.collect()
    want = collections.Counter(t["k"].to_pylist())
    assert {r["k"]: r["n"] for r in got.to_pylist()} == dict.fromkeys(want, 1)


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
