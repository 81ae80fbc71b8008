"""The session's and the planner's last surface against the JAX package.

The port runs on ``device="cpu"``; the JAX package on its engines (the
JAX CPU backend).  Inputs are numpy-seeded.  Integers, strings and
NULLs compare exactly, float aggregates under
``tests/differential.assert_tables_equal(approx_float=True)``.

- The export surface (``columnar/rows.py``, ``DataFrame.to_batches`` /
  ``rows`` / ``to_device_arrays``): the counterparts of JAX
  ``test_runtime_completeness.py::test_rows_and_batches_export`` and
  ``::test_rows_to_batch_round_trip`` and ``test_session.py::
  test_to_device_arrays_zero_copy_into_jax``, and a stream closed early.
- ``spark.rapids.tpu.sql.enabled`` off: every entry point equals the
  JAX CPU engine's result, ``explain()`` marks every node, and the
  device ledger counts no dispatch.
- The cost-based demotion: the three tests of ``tests/test_cbo.py``,
  through the port's Filter switch.
- ``sql.metrics.level``, ``sql.topn.maxRows``, the runtime filter's four
  keys (JAX ``test_runtime_filter.py::
  test_bloom_false_positive_path_joins_correctly`` and
  ``::test_unselective_build_skips_injection``), ``deviceOrdinal`` and
  ``memory.hostPool.maxBytes``.
- The conf surface: every key the JAX package registers that the port
  lacks stands in ``STILL_MISSING`` with its reason.
"""

import ast
import pathlib
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu.memory.device_manager as jdm
import spark_rapids_tpu.plan.cost as jcost
import spark_rapids_tpu.plan.runtime_filter as JRF
from spark_rapids_tpu import config as JC
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import rows as jrows
from spark_rapids_tpu.config import get_conf
from spark_rapids_tpu.frontends.sql import SqlSession as JSqlSession
from spark_rapids_tpu.frontends.substrait import SubstraitFrontend as JFront
from spark_rapids_tpu.plan import planner as jplanner
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import lit as jlit
from spark_rapids_tpu.session import sum_ as jsum
from tests.differential import assert_tables_equal, gen_table

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import tpch
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import rows
from spark_rapids_tpu_torch.execs.fallback import CpuFallbackExec
from spark_rapids_tpu_torch.execs.join import TpuRuntimeFilterBuildExec
from spark_rapids_tpu_torch.execs.sort import TpuSortExec, TpuTopNExec
from spark_rapids_tpu_torch.frontends.sql import SqlSession
from spark_rapids_tpu_torch.frontends.substrait import SubstraitFrontend
from spark_rapids_tpu_torch.memory.device_manager import (
    HostBufferPool,
    select_device,
)
from spark_rapids_tpu_torch.plan import cost
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan import runtime_filter as RF
from spark_rapids_tpu_torch.plan.planner import (
    EXEC_SWITCHES,
    SWITCH_OFF_REASON,
    Planner,
    collect_exec,
)
from spark_rapids_tpu_torch.serving import scheduler as scheduler_mod
from spark_rapids_tpu_torch.serving.scheduler import scheduler_stats
from spark_rapids_tpu_torch.session import TorchSession, col, lit, sum_
from spark_rapids_tpu_torch.trace import ledger as _ledger
from torch_plugin import sized_plugin

OFF = {C.SQL_ENABLED: False}


@pytest.fixture(autouse=True)
def _fresh_process_state():
    scheduler_mod.reset()
    RF.reset_stats()
    yield
    scheduler_mod.reset()
    RF.reset_stats()
    _ledger.disable()
    _ledger.reset_stats()


def _port(keys=None) -> TorchSession:
    return TorchSession(keys, device="cpu")


def _jax(keys=None) -> TpuSession:
    conf = get_conf()  # the test's keys on the JAX process conf
    for k, v in (keys or {}).items():
        conf.set(k, v)
    return TpuSession(conf)


def _sales(n=3000, seed=3) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, 12, n),
                     "v": np.round(rng.random(n) * 100, 2),
                     "s": [f"s{i % 17}" for i in range(n)]})


# -- the export surface -- #

def test_rows_and_batches_export():
    t = gen_table({"a": "int64", "s": "string"}, 300, seed=2)
    df = _port().create_dataframe(t).where(col("a").is_not_null())
    jdf = TpuSession().create_dataframe(t).where(jcol("a").is_not_null())
    rbs = list(df.to_batches(batch_rows=64))
    want = jdf.collect()
    assert sum(rb.num_rows for rb in rbs) == want.num_rows
    assert all(rb.num_rows <= 64 for rb in rbs)
    assert_tables_equal(pa.Table.from_batches(rbs), want)
    got_rows = list(df.rows())
    assert all(isinstance(r, tuple) and len(r) == 2 for r in got_rows)
    assert sorted(got_rows, key=repr) == sorted(jdf.rows(), key=repr)


def test_rows_to_batch_round_trip():
    schema = T.Schema([T.Field("i", T.LONG, True),
                       T.Field("s", T.STRING, True)])
    jschema = JT.Schema([JT.Field("i", JT.LONG, True),
                         JT.Field("s", JT.STRING, True)])
    data = [(1, "a"), (None, "β"), (3, None)]
    b = rows.rows_to_batch(data, schema)
    assert list(rows.batch_to_rows(b)) == data == list(
        jrows.batch_to_rows(jrows.rows_to_batch(data, jschema)))
    b2 = rows.rows_to_batch([{"i": 5, "s": "x"}, {"s": "y"}], schema)
    assert list(rows.batch_to_rows(b2)) == [(5, "x"), (None, "y")]


def test_to_device_arrays_hands_over_tensors():
    rng = np.random.default_rng(4)
    t = pa.table({"x": rng.random(500), "y": rng.random(500)})
    df = (_port().create_dataframe(t).where(col("x") > lit(0.5))
          .select(col("x"), (col("x") * col("y")).alias("xy")))
    batches = df.to_device_arrays()
    assert batches and all(isinstance(b["x"], torch.Tensor)
                           and b["x"].device.type == "cpu"
                           and b["xy__valid"].dtype == torch.bool
                           and len(b["xy"]) == b["__num_rows"]
                           for b in batches)
    total = sum(float(torch.where(b["xy__valid"], b["xy"], 0.0).sum())
                for b in batches)
    jbatches = (TpuSession().create_dataframe(t).where(jcol("x") > jlit(0.5))
                .select(jcol("x"), (jcol("x") * jcol("y")).alias("xy"))
                .to_device_arrays())
    want = sum(float(np.where(np.asarray(b["xy__valid"]), np.asarray(
        b["xy"]), 0.0).sum()) for b in jbatches)
    assert sum(b["__num_rows"] for b in batches) == sum(
        int(b["__num_rows"]) for b in jbatches)
    assert abs(total - want) < 1e-9 * max(1.0, abs(want))


def test_to_device_arrays_refuses_a_string_column():
    t = pa.table({"k": [1, 2], "s": ["a", "b"]})
    with pytest.raises(TypeError) as got:
        _port().create_dataframe(t).to_device_arrays()
    with pytest.raises(TypeError) as want:
        TpuSession().create_dataframe(t).to_device_arrays()
    assert str(got.value) == str(want.value)


def test_to_batches_closed_early_releases_its_slot():
    s = _port({C.BATCH_ROWS: 256, C.SERVING_MAX_CONCURRENT: 1})
    df = s.create_dataframe(_sales(4096)).where(col("k") >= lit(0))
    gen = df.to_batches(batch_rows=100)
    next(gen)
    gen.close()
    out: list = []
    th = threading.Thread(target=lambda: out.append(df.collect()))
    th.start()
    th.join(60.0)
    assert out and out[0].num_rows == 4096, "the closed export kept its slot"
    assert scheduler_stats()["running"] == 0
    assert s.store.leak_report() == []


def test_collect_takes_the_jax_engine_names():
    t = _sales(500)
    df = _port().create_dataframe(t).group_by(col("k")).agg(
        (sum_(col("v")), "sv"))
    assert_tables_equal(df.collect(engine="tpu"), df.collect(engine="cpu"),
                        approx_float=True)
    with pytest.raises(ValueError, match="engine"):
        df.collect(engine="gpu")


# -- the master switch off -- #

def _off_entries(tmp_path):
    """name -> (the port's result with the switch off, the JAX CPU
    engine's result of the same query)."""
    t = _sales()
    path = str(tmp_path / "sales.parquet")
    pq.write_table(t, path)
    text = ("select k, sum(v) as sv, count(*) as n from sales "
            "where v > (select avg(v) from sales) group by k")
    port, jport = _port(OFF), TpuSession()
    df = port.read_parquet(path).where(col("v") > lit(20.0)).group_by(
        col("k")).agg((sum_(col("v")), "sv"))
    jdf = jport.read_parquet(path).where(jcol("v") > jlit(20.0)).group_by(
        jcol("k")).agg((jsum(jcol("v")), "sv"))
    fe, jfe = SqlSession(session=port), JSqlSession()
    fe.register_parquet("sales", path)
    jfe.register_parquet("sales", path)
    want_sql = jfe.sql(text).collect(engine="cpu")
    li = tpch.make_lineitem(str(tmp_path), n_files=2, rows_per_file=4096,
                            with_q1_cols=True)
    sub = SubstraitFrontend(session=_port(OFF))
    jsub = JFront()
    sub.register_table("lineitem", li)
    jsub.register_table("lineitem", li)
    return {
        "collect": (lambda: df.collect(), jdf.collect(engine="cpu")),
        "to_batches": (lambda: pa.Table.from_batches(
            list(df.to_batches(batch_rows=3))), jdf.collect(engine="cpu")),
        "rows": (lambda: pa.Table.from_pylist(
            [dict(zip(("k", "sv"), r)) for r in df.rows()],
            schema=df.collect().schema), jdf.collect(engine="cpu")),
        "prepared": (lambda: port.prepare(df).execute(),
                     jdf.collect(engine="cpu")),
        "sql_text": (lambda: fe.sql(text).collect(), want_sql),
        "scalar_subquery_prepared": (lambda: fe.prepare(text).execute(),
                                     want_sql),
        "substrait": (lambda: sub.execute_plan(tpch.q6_substrait()),
                      jsub.execute_plan(tpch.q6_substrait(), engine="cpu")),
        "substrait_engine_cpu": (
            lambda: _substrait_on(li).execute_plan(tpch.q6_substrait(),
                                                   engine="cpu"),
            jsub.execute_plan(tpch.q6_substrait(), engine="cpu")),
    }


def _substrait_on(li) -> SubstraitFrontend:
    """A frontend whose session keeps the switch on: ``engine="cpu"``
    alone sends its plan to the CPU engine."""
    fe = SubstraitFrontend(device="cpu")
    fe.register_table("lineitem", li)
    return fe


OFF_ENTRIES = ("collect", "to_batches", "rows", "prepared", "sql_text",
               "scalar_subquery_prepared", "substrait",
               "substrait_engine_cpu")


@pytest.mark.parametrize("entry", OFF_ENTRIES)
def test_switch_off_equals_the_jax_cpu_engine(tmp_path, entry):
    run, want = _off_entries(tmp_path)[entry]
    _ledger.enable()
    before = _ledger.snapshot()
    got = run()
    moved = _ledger.delta(before, _ledger.snapshot())
    assert sum(p["dispatches"] for p in moved.values()) == 0, moved
    assert_tables_equal(got, want, approx_float=True)


def test_switch_off_marks_every_node_and_builds_no_device_exec(tmp_path):
    t = _sales()
    path = str(tmp_path / "sales.parquet")
    pq.write_table(t, path)
    s = _port(OFF)
    df = (s.read_parquet(path).where(col("v") > lit(20.0))
          .group_by(col("k")).agg((sum_(col("v")), "sv"))
          .order_by(col("k")).limit(5))
    plan, meta = df._planner().plan_with_meta(df._plan)
    nodes = list(meta.walk())
    assert len(nodes) == 5
    assert all(m.reasons == {SWITCH_OFF_REASON} for m in nodes)
    assert SWITCH_OFF_REASON == "disabled by spark.rapids.tpu.sql.enabled"
    assert all(isinstance(n, CpuFallbackExec) and n.device.type == "cpu"
               for n in plan.walk())
    text = df.explain()
    assert text.count("because " + SWITCH_OFF_REASON) == 5
    # JAX tags its root alone with the same words
    conf = get_conf()
    conf.set(JC.SQL_ENABLED.key, False)
    jdf = (TpuSession(conf).read_parquet(path).where(jcol("v") > jlit(20.0))
           .group_by(jcol("k")).agg((jsum(jcol("v")), "sv")))
    _root, jmeta = jplanner.plan_query(jdf._plan, conf)
    assert set(jmeta.reasons) == {SWITCH_OFF_REASON}
    assert not any(c.reasons for c in jmeta.children)


def test_switch_off_scalar_subquery_runs_on_the_cpu_engine(tmp_path,
                                                           monkeypatch):
    t = _sales()
    fe = SqlSession(OFF, device="cpu")
    fe.register_table("sales", t)
    planned = []
    real = Planner.plan
    monkeypatch.setattr(Planner, "plan", lambda self, p: planned.append(p)
                        or real(self, p))
    text = "select k, v from sales where v > (select max(v) from sales) - 1"
    got = fe.prepare(text).execute()
    jfe = JSqlSession()
    jfe.register_table("sales", t)
    assert_tables_equal(got, jfe.sql(text).collect(engine="cpu"))
    assert planned == []  # the subplan never went through the planner


# -- the cost-based demotion (tests/test_cbo.py) -- #

FILTER = EXEC_SWITCHES[L.Filter]


def _meta_marks(meta) -> list:
    """(node class, demoted) down a tagged tree, pre-order (the port's
    Parquet leaf ``Scan`` under JAX's name)."""
    name = type(meta.plan).__name__
    out = [("ParquetRelation" if name == "Scan" else name,
            cost.DEMOTION_REASON in set(meta.reasons))]
    for c in meta.children:
        out += _meta_marks(c)
    return out


def _device_nodes(plan) -> list:
    return [n for n in plan.walk() if not isinstance(n, CpuFallbackExec)]


def _jax_plan(jdf, keys):
    conf = get_conf()
    for k, v in keys.items():
        conf.set(k, v)
    return jplanner.plan_query(jdf._plan, conf)


def _sandwich(make, a_col, lit_, t):
    return (make(t).where(a_col("a") > lit_(10))
            .select((a_col("a") + a_col("a")).alias("a2"), a_col("b"))
            .where(a_col("a2") > lit_(50)))


def test_sandwiched_island_demoted():
    rng = np.random.default_rng(5)
    t = pa.table({"a": rng.integers(0, 100, 2000), "b": rng.random(2000)})
    keys = {C.CBO_ENABLED: True, FILTER: False}
    s = _port(keys)
    df = _sandwich(s.create_dataframe, col, lit, t)
    plan, meta = df._planner().plan_with_meta(df._plan)
    _jroot, jmeta = _jax_plan(
        _sandwich(TpuSession().create_dataframe, jcol, jlit, t), keys)
    assert cost.DEMOTION_REASON == jcost.DEMOTION_REASON
    assert _meta_marks(meta) == _meta_marks(jmeta)
    assert any(d for _n, d in _meta_marks(meta)), meta.explain()
    assert not _device_nodes(plan), plan.tree_string()
    assert cost.DEMOTION_REASON in df.explain()
    assert_tables_equal(df.collect(), df.collect(engine="cpu"))


def test_large_island_not_demoted():
    rng = np.random.default_rng(6)
    t = pa.table({"a": rng.integers(0, 100, 50_000),
                  "b": rng.random(50_000)})
    s = _port({C.CBO_ENABLED: True})
    df = s.create_dataframe(t).where(col("a") > lit(10)).agg(
        (sum_(col("b")), "s"))
    plan, meta = df._planner().plan_with_meta(df._plan)
    jdf = TpuSession().create_dataframe(t).where(jcol("a") > jlit(10)).agg(
        (jsum(jcol("b")), "s"))
    _jroot, jmeta = _jax_plan(jdf, {C.CBO_ENABLED: True})
    assert _meta_marks(meta) == _meta_marks(jmeta)
    assert not any(d for _n, d in _meta_marks(meta)), meta.explain()
    assert _device_nodes(plan)


def _large(make, c, lit_, total, t):
    return make(t).where(c("a") > lit_(10)).agg((total(c("b")), "s"))


@pytest.mark.parametrize("key,value,shape", [
    (C.TRANSFER_ROW_COST, 0.0, "sandwich"),
    (C.TPU_ROW_COST, 2.0, "large"),
    (C.CPU_ROW_COST, 0.01, "large")])
def test_cost_keys_move_the_decision_as_in_jax(key, value, shape):
    """Each cost key turns a decision of the two tests above: without
    transfer cost the sandwiched island stays; a dear device row or a
    cheap host row demotes the large one."""
    rng = np.random.default_rng(8)
    t = pa.table({"a": rng.integers(0, 100, 50_000),
                  "b": rng.random(50_000)})

    def marks(extra):
        keys = {C.CBO_ENABLED: True, **extra}
        if shape == "sandwich":
            keys[FILTER] = False
            df = _sandwich(_port(keys).create_dataframe, col, lit, t)
            jdf = _sandwich(TpuSession().create_dataframe, jcol, jlit, t)
        else:
            df = _large(_port(keys).create_dataframe, col, lit, sum_, t)
            jdf = _large(TpuSession().create_dataframe, jcol, jlit, jsum, t)
        _plan, meta = df._planner().plan_with_meta(df._plan)
        _jroot, jmeta = _jax_plan(jdf, keys)
        assert _meta_marks(meta) == _meta_marks(jmeta)
        return any(d for _n, d in _meta_marks(meta))

    default = marks({})
    assert default == (shape == "sandwich")
    assert marks({key: value}) != default


def test_cbo_off_keeps_island():
    rng = np.random.default_rng(7)
    t = pa.table({"a": rng.integers(0, 100, 2000)})
    s = _port({FILTER: False})
    df = (s.create_dataframe(t).where(col("a") > lit(10))
          .select((col("a") + col("a")).alias("a2"))
          .where(col("a2") > lit(50)))
    plan, meta = df._planner().plan_with_meta(df._plan)
    assert not any(d for _n, d in _meta_marks(meta))
    assert _device_nodes(plan)  # the island stays on the device


@pytest.mark.parametrize("shape", ["grouped", "grand"])
def test_scan_islands_demote_as_in_jax(tmp_path, shape):
    """A scan -> filter -> aggregate island under the JAX cost model: a
    grouped aggregate is estimated at its input's rows, so the exit
    transfer outweighs the card and the island demotes whole (q1's
    shape); a grand aggregate leaves one row and stays (q6's)."""
    paths = _parquet_files(tmp_path)
    keys = {C.CBO_ENABLED: True}

    def make(s, c, lit_, total):
        df = s.read_parquet(*paths).where(c("v") > lit_(0.25))
        if shape == "grouped":
            df = df.group_by(c("k"))
        return df.agg((total(c("v")), "s"))

    df = make(_port(keys), col, lit, sum_)
    plan, meta = df._planner().plan_with_meta(df._plan)
    _jroot, jmeta = _jax_plan(make(TpuSession(), jcol, jlit, jsum), keys)
    assert _meta_marks(meta) == _meta_marks(jmeta)
    assert all(d for _n, d in _meta_marks(meta)) == (shape == "grouped")
    assert bool(_device_nodes(plan)) == (shape == "grand")
    assert_tables_equal(df.collect(), df.collect(engine="cpu"),
                        approx_float=True)


def test_unknown_estimate_never_demotes(tmp_path):
    """A CSV scan has no row estimate: its island is never weighed."""
    import pyarrow.csv as pacsv

    path = str(tmp_path / "t.csv")
    pacsv.write_csv(pa.table({"a": np.arange(50)}), path)
    s = _port({C.CBO_ENABLED: True, FILTER: False})
    df = s.read_csv(path).select((col("a") + col("a")).alias("a2")).where(
        col("a2") > lit(4))
    _plan, meta = df._planner().plan_with_meta(df._plan)
    assert not any(d for _n, d in _meta_marks(meta))


# -- sql.metrics.level -- #

def _parquet_files(tmp_path, n_files=3) -> list:
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n_files):
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(pa.table({"k": rng.integers(0, 5, 1000),
                                 "v": rng.random(1000)}), p)
        paths.append(p)
    return paths


@pytest.mark.parametrize("level", ["ESSENTIAL", "MODERATE"])
def test_metric_level_key_sets_equal_the_jax_execs(tmp_path, level):
    paths = _parquet_files(tmp_path)
    keys = {C.METRICS_LEVEL: level, C.TASK_TARGET_BYTES: 1}
    s = _port(keys)
    plan = (s.read_parquet(*paths).where(col("v") > lit(0.5))
            .group_by(col("k")).agg((sum_(col("v")), "s"))).physical_plan()
    collect_exec(plan, s.conf)
    js = _jax(keys)
    jdf = (js.read_parquet(*paths).where(jcol("v") > jlit(0.5))
           .group_by("k").agg((jsum(jcol("v")), "s")))
    jroot, _ = jplanner.plan_query(jdf._plan, get_conf())
    jplanner.collect_exec(jroot)
    got = {k: sorted(v) for k, v in plan.collect_metrics().items()}
    assert got == {k: sorted(v) for k, v in jroot.collect_metrics().items()}
    assert set(plan.collect_metrics("DEBUG")["ParquetScanExec"]) > set(
        got["ParquetScanExec"])


# -- sql.topn.maxRows -- #

@pytest.mark.parametrize("max_rows", [5, 1 << 14])
def test_topn_max_rows_chooses_the_plan(max_rows):
    rng = np.random.default_rng(9)
    t = pa.table({"k": rng.permutation(4000), "v": rng.random(4000)})
    keys = {C.TOPN_MAX_ROWS: max_rows, C.BATCH_ROWS: 512}
    s = _port(keys)
    df = s.create_dataframe(t).order_by(col("k")).limit(10)
    plan = df.physical_plan()
    topn = any(isinstance(n, TpuTopNExec) for n in plan.walk())
    assert topn == (max_rows >= 10)
    assert any(isinstance(n, TpuSortExec) for n in plan.walk()) != topn
    got = df.collect()
    want = _jax(keys).create_dataframe(t).order_by(jcol("k")).limit(
        10).collect()
    assert got.to_pylist() == want.to_pylist()
    assert got.to_pylist() == _port().create_dataframe(t).order_by(
        col("k")).limit(10).collect().to_pylist()


# -- the runtime filter's keys (tests/test_runtime_filter.py) -- #

def _write(d, name, table):
    p = str(d / name)
    pq.write_table(table, p)
    return p


def _q3(make, c, lit_, li, op, date_lt=20):
    s = make
    return s.read_parquet(li).join(
        s.read_parquet(op).where(c("o_date") < lit_(date_lt)),
        left_on=[c("l_orderkey")], right_on=[c("o_orderkey")])


def _bloom_case(tmp_path):
    rng = np.random.default_rng(5)
    li = _write(tmp_path, "li.parquet", pa.table({
        "l_orderkey": rng.integers(0, 4096, 4096).astype(np.int64),
        "l_price": rng.random(4096)}))
    op = _write(tmp_path, "orders.parquet", pa.table({
        "o_orderkey": np.arange(0, 4096, 37, dtype=np.int64),
        "o_date": np.zeros(len(range(0, 4096, 37)), np.int32)}))
    return li, op


def _sorted(t: pa.Table) -> list:
    return sorted(map(tuple, zip(*t.to_pydict().values())),
                  key=lambda r: tuple((x is None, x) for x in r))


def test_bloom_false_positive_path_joins_correctly(tmp_path):
    li, op = _bloom_case(tmp_path)
    keys = {C.RF_MINMAX_ENABLED: False, C.RF_FPP: 0.5}
    df = _q3(_port(keys), col, lit, li, op, date_lt=1)
    got = df.collect()
    jdf = _q3(_jax(keys), jcol, jlit, li, op, date_lt=1)
    assert _sorted(got) == _sorted(jdf.collect(engine="cpu"))
    assert RF.stats()["filters_built"] >= 1
    [rf] = RF.plan_runtime_filters(df.physical_plan())
    assert (rf.use_minmax, rf.use_bloom) == (False, True)
    assert rf.n_bits == RF.bloom_params(len(range(0, 4096, 37)), 0.5)[0] \
        == JRF.bloom_params(len(range(0, 4096, 37)), 0.5)[0]
    assert "minmax" not in rf.describe() and "bloom[" in rf.describe()


def test_bloom_off_folds_no_hash_and_joins_correctly(tmp_path, monkeypatch):
    li, op = _bloom_case(tmp_path)
    hashed = []
    real = RF.device_key_hashes
    monkeypatch.setattr(RF, "device_key_hashes",
                        lambda c: hashed.append(len(c)) or real(c))
    keys = {C.RF_BLOOM_ENABLED: False}
    df = _q3(_port(keys), col, lit, li, op, date_lt=1)
    got = df.collect()
    assert hashed == [] and RF.stats()["filters_built"] >= 1
    assert _sorted(got) == _sorted(
        _q3(_jax(keys), jcol, jlit, li, op, date_lt=1).collect(engine="cpu"))
    both_off = {C.RF_BLOOM_ENABLED: False, C.RF_MINMAX_ENABLED: False}
    assert not RF.plan_runtime_filters(
        _q3(_port(both_off), col, lit, li, op).physical_plan())


def test_unselective_build_skips_injection(tmp_path):
    rng = np.random.default_rng(0)
    li = _write(tmp_path, "li.parquet", pa.table({
        "l_orderkey": rng.integers(0, 512, 512).astype(np.int64),
        "l_price": rng.random(512)}))
    op = _write(tmp_path, "orders.parquet", pa.table({
        "o_orderkey": np.arange(512, dtype=np.int64),
        "o_date": rng.integers(0, 100, 512).astype(np.int32)}))
    keys = {C.RF_MAX_BUILD_ROWS: 10}
    plan = _q3(_port(keys), col, lit, li, op).physical_plan()
    assert not any(isinstance(n, TpuRuntimeFilterBuildExec)
                   for n in plan.walk())
    assert not any(getattr(n, "runtime_filters", None) for n in plan.walk())
    jroot, _ = _jax_plan(_q3(TpuSession(), jcol, jlit, li, op), keys)
    assert not any(getattr(n, "runtime_filters", None)
                   for n in jroot._walk())
    assert "rf#" not in _q3(_port(keys), col, lit, li, op).explain()
    assert "rf#" in _q3(_port(), col, lit, li, op).explain()


# -- deviceOrdinal and memory.hostPool.maxBytes -- #

@pytest.mark.parametrize("ordinal,count", [(-1, 4), (0, 1), (2, 4), (3, 4),
                                           (4, 4), (7, 2), (-1, 1)])
def test_device_ordinal_picks_the_jax_card(monkeypatch, ordinal, count):
    import jax

    got = select_device(C.TorchConf({C.DEVICE_ORDINAL: ordinal}), count)
    monkeypatch.setattr(jax, "devices", lambda: list(range(count)))
    conf = get_conf()
    conf.set(jdm.DEVICE_ORDINAL.key, ordinal)
    assert got == torch.device("cuda", jdm.select_device(conf))


def test_a_session_with_no_device_needs_cuda():
    if torch.cuda.is_available():
        s = TorchSession({C.DEVICE_ORDINAL: 0})
        assert s.device == torch.device("cuda", 0)
        return
    for keys in (None, {C.DEVICE_ORDINAL: 1}):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            TorchSession(keys)


def test_host_pool_bound_reads_its_key():
    with sized_plugin({C.HOST_POOL_BYTES: 8192}):
        pool = HostBufferPool.get()
        assert pool.max_bytes == 8192
        held = [pool.take(4096) for _ in range(3)]
        for b in held:
            pool.give(b)
        assert pool._held == 8192  # the third buffer was not kept
    get_conf().set(jdm.HOST_POOL_BYTES.key, 8192)
    assert jdm.HostBufferPool().max_bytes == 8192
    with sized_plugin({}):
        assert HostBufferPool.get().max_bytes == 256 << 20


# -- the keys and the conf surface -- #

NEW_KEYS = (C.SQL_ENABLED, C.METRICS_LEVEL, C.TOPN_MAX_ROWS, C.CBO_ENABLED,
            C.CPU_ROW_COST, C.TPU_ROW_COST, C.TRANSFER_ROW_COST,
            C.RF_MINMAX_ENABLED, C.RF_BLOOM_ENABLED, C.RF_MAX_BUILD_ROWS,
            C.RF_FPP, C.DEVICE_ORDINAL, C.HOST_POOL_BYTES)


@pytest.mark.parametrize("key", NEW_KEYS)
def test_key_has_the_jax_default(key):
    entry = JC._REGISTRY[key]
    assert C.DEFAULTS[key] == entry.default
    assert type(C.DEFAULTS[key]) is type(entry.default)


@pytest.mark.parametrize("key,bad", [(C.RF_FPP, 0.0), (C.RF_FPP, 1.0),
                                     (C.METRICS_LEVEL, "moderate")])
def test_key_refuses_what_jax_refuses(key, bad):
    with pytest.raises(ValueError):
        C.TorchConf({key: bad})
    with pytest.raises(ValueError):
        JC._REGISTRY[key].convert(bad)


ITEM_9 = "ROADMAP item 9 (the rest of the throughput layers)"
ITEM_10 = "ROADMAP item 10 (multi-GPU: the mesh, collectives, network " \
          "shuffle)"
XLA_ONLY = "XLA-only: no torch counterpart"
UNREAD = "read by nothing in the JAX package"

#: every ``spark.rapids.tpu.*`` key the JAX package registers that the
#: port does not, with the reason: the record of what is left
STILL_MISSING = {
    "spark.rapids.tpu.memory.hbm.poolFraction": UNREAD,
    "spark.rapids.tpu.memory.spillDir": UNREAD,
    "spark.rapids.tpu.sql.explain": UNREAD,
    "spark.rapids.tpu.sql.hasNans": UNREAD,
    "spark.rapids.tpu.sql.incompatibleOps.enabled": UNREAD,
    "spark.rapids.tpu.sql.variableFloatAgg.enabled": UNREAD,
    "spark.rapids.tpu.sql.test.allowedNonTpu": UNREAD,
    "spark.rapids.tpu.sql.test.strictFallback": UNREAD,
    "spark.rapids.tpu.shuffle.transport.enabled": UNREAD,
    "spark.rapids.tpu.persist.xlaCache.enabled": XLA_ONLY,
    "spark.rapids.tpu.sql.pallas.enabled": XLA_ONLY,
    "spark.rapids.tpu.sql.fusion.donation.enabled": XLA_ONLY,
    "spark.rapids.tpu.sql.fusion.enabled": ITEM_9,
    "spark.rapids.tpu.sql.fusion.warmDispatchBudget": ITEM_9,
    "spark.rapids.tpu.sql.capacity.policy": ITEM_9,
    "spark.rapids.tpu.sql.capacity.liveRatioFloor": ITEM_9,
    "spark.rapids.tpu.sql.batchSizeRows.auto": ITEM_9,
    "spark.rapids.tpu.sql.maxBatchCapacity": ITEM_9,
    "spark.rapids.tpu.sql.recovery.cpuFallbackOnDeviceError": ITEM_9,
    "spark.rapids.tpu.sql.wireCompression.minRatio": ITEM_9,
    "spark.rapids.tpu.sql.wireCompression.blockRows": ITEM_9,
    "spark.rapids.tpu.serving.mesh.enabled": ITEM_10,
    "spark.rapids.tpu.serving.mesh.deviceBudget": ITEM_10,
    "spark.rapids.tpu.shuffle.collective.roundRows": ITEM_10,
    "spark.rapids.tpu.shuffle.collective.spmd.enabled": ITEM_10,
    "spark.rapids.tpu.shuffle.collective.spmd.bucketRounds": ITEM_10,
    "spark.rapids.tpu.shuffle.compression.codec": ITEM_10,
    "spark.rapids.tpu.shuffle.fetch.maxAttempts": ITEM_10,
    "spark.rapids.tpu.shuffle.fetch.retryWaitSeconds": ITEM_10,
    "spark.rapids.tpu.shuffle.fetch.timeoutSeconds": ITEM_10,
    "spark.rapids.tpu.shuffle.heartbeat.intervalSeconds": ITEM_10,
    "spark.rapids.tpu.shuffle.heartbeat.timeoutSeconds": ITEM_10,
    "spark.rapids.tpu.shuffle.registry.address": ITEM_10,
    "spark.rapids.tpu.shuffle.server.advertiseHost": ITEM_10,
    "spark.rapids.tpu.shuffle.transport": ITEM_10,
}


def _jax_registered_keys() -> set:
    """Every literal key a ``register(...)`` call of the JAX package's
    source names (read from the source: importing every JAX module is
    not needed to see them)."""
    root = pathlib.Path(JC.__file__).parent
    keys = set()
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and node.args and getattr(
                    node.func, "id", getattr(node.func, "attr", None)) \
                    == "register":
                a = node.args[0]
                if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                        and a.value.startswith("spark.rapids.tpu."):
                    keys.add(a.value)
    return keys


def test_conf_surface_lists_every_missing_jax_key():
    jax_keys = _jax_registered_keys()
    missing = {k for k in jax_keys if k not in C.DEFAULTS}
    assert missing == set(STILL_MISSING), (
        "unlisted: " + repr(sorted(missing - set(STILL_MISSING)))
        + "; ported or gone: " + repr(sorted(set(STILL_MISSING) - missing)))
    assert set(NEW_KEYS) <= jax_keys


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
