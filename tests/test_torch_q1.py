"""TPC-H q1 and q6 end to end: the port on the CPU against both JAX
engines, on the same small Parquet files.

``scan.taskTargetBytes`` = 1 makes every file its own scan task on both
engines, so q1 plans partial aggregate -> hash exchange on the string
keys -> final aggregate, and the exchange hashes the keys through K1
(its plain version here).  The JAX shuffle layer reads the
process-global conf, so the conf goes through ``set_conf`` as well as
``TpuSession`` and is restored afterwards.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import bench
from spark_rapids_tpu.config import get_conf, set_conf
from spark_rapids_tpu.execs.exchange import TpuShuffleExchangeExec as JX
from spark_rapids_tpu.ops.partition import HashPartitioning as JHP
from spark_rapids_tpu.plan.planner import plan_query
from spark_rapids_tpu.session import TpuSession

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession, tpch
from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
from spark_rapids_tpu_torch.ops import kernels
from spark_rapids_tpu_torch.ops.partition import HashPartitioning

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
ROWS = 4096


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("lineitem")
    return tpch.make_lineitem(str(d), n_files=3, with_q1_cols=True,
                              rows_per_file=ROWS)


@pytest.fixture
def jax_session():
    conf = get_conf()
    saved = dict(conf._values)
    conf.set(TTB, 1)
    set_conf(conf)
    try:
        yield TpuSession(conf)
    finally:
        conf._values.clear()
        conf._values.update(saved)
        set_conf(conf)


@pytest.fixture
def port_session():
    return TorchSession({TTB: 1}, device="cpu")


def _significant(table: pa.Table, digits: int = 12) -> pa.Table:
    """Float columns rounded to ``digits`` significant digits.  Float
    sums differ between engines only in summation order (the JAX
    engine's own map tasks commit in thread order), which moves a sum
    of ~1e8 by an ulp or two, ~1e-8 absolute: more than the 9 decimals
    ``approx_float`` keeps.  12 significant digits is a relative
    tolerance of ~1e-12; keys, strings and counts stay exact."""
    cols = []
    for c in table.columns:
        if pa.types.is_floating(c.type):
            vals = [None if v is None else float(f"{v:.{digits - 1}e}")
                    for v in c.to_pylist()]
            c = pa.array(vals, c.type)
        cols.append(c)
    return pa.Table.from_arrays(cols, names=table.schema.names)


def _jax_walk(node):
    yield node
    for c in node.children:
        yield from _jax_walk(c)


def test_make_lineitem_copies_bench(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "ROWS_PER_FILE", ROWS)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    want = bench.make_lineitem(str(tmp_path / "a"), n_files=2,
                               with_q1_cols=True)
    got = tpch.make_lineitem(str(tmp_path / "b"), n_files=2,
                             with_q1_cols=True, rows_per_file=ROWS)
    for g, w in zip(got, want):
        assert pq.read_table(g).equals(pq.read_table(w))
    # q3's lineitem: the order key drawn last, from the same generator
    (tmp_path / "c").mkdir()
    (tmp_path / "d").mkdir()
    want = bench.make_lineitem(str(tmp_path / "c"), n_files=2,
                               with_q1_cols=True, with_orderkey=True,
                               n_orders=1000)
    got = tpch.make_lineitem(str(tmp_path / "d"), n_files=2,
                             with_q1_cols=True, with_orderkey=True,
                             n_orders=1000, rows_per_file=ROWS)
    for g, w in zip(got, want):
        assert pq.read_table(g).equals(pq.read_table(w))
        assert "l_orderkey" in pq.read_schema(g).names


@pytest.mark.parametrize("query", ["q1", "q6"])
def test_query_matches_both_jax_engines(query, paths, jax_session,
                                        port_session):
    qfn = getattr(tpch, f"{query}_dataframe")
    jfn = getattr(bench, f"{query}_dataframe")
    got = qfn(port_session, paths).collect()
    jdf = jfn(jax_session, paths)
    assert got.num_rows == (6 if query == "q1" else 1)
    for engine in ("tpu", "cpu"):
        assert_tables_equal(_significant(got),
                            _significant(jdf.collect(engine=engine)),
                            approx_float=True)


def test_q1_plans_a_hash_exchange_and_hashes_strings(paths, jax_session,
                                                     port_session,
                                                     monkeypatch):
    jexec, _ = plan_query(bench.q1_dataframe(jax_session, paths)._plan,
                          jax_session.conf)
    assert any(isinstance(n, JX) and isinstance(n.partitioning, JHP)
               for n in _jax_walk(jexec))
    df = tpch.q1_dataframe(port_session, paths)
    plan = df.physical_plan()
    exchanges = [n for n in plan.walk()
                 if isinstance(n, TpuShuffleExchangeExec)]
    assert len(exchanges) == 1
    assert isinstance(exchanges[0].partitioning, HashPartitioning)
    assert plan.children[0] is exchanges[0]
    assert exchanges[0].children[0].mode == "partial"

    calls = []
    real = kernels.hash_columns

    def spy(cols, num_rows, device, seed=42, num_partitions=0):
        calls.append(([c.chars.shape[1] for c in cols], num_rows,
                      num_partitions))
        return real(cols, num_rows, device, seed, num_partitions)

    monkeypatch.setattr(kernels, "hash_columns", spy)
    df.collect()
    # one hash of the whole key tuple per map task: two one-byte string
    # keys, at most 6 (returnflag, linestatus) groups per partial
    assert len(calls) == len(paths)
    assert all(w == [1, 1] and 0 < n <= 6 and p > 1 for w, n, p in calls)


def test_single_file_q1_aggregates_completely(paths, port_session):
    df = tpch.q1_dataframe(port_session, paths[:1])
    plan = df.physical_plan()
    assert plan.mode == "complete"
    assert not any(isinstance(n, TpuShuffleExchangeExec)
                   for n in plan.walk())
    many = tpch.q1_dataframe(port_session, paths).collect()
    one = df.collect()
    assert one.num_rows == 6
    assert sum(one["count_order"].to_pylist()) < \
        sum(many["count_order"].to_pylist())


def test_default_task_target_packs_small_files_into_one_task(paths):
    s = TorchSession(device="cpu")
    plan = tpch.q6_dataframe(s, paths).physical_plan()
    scan = list(plan.walk())[-1]
    assert scan.num_partitions == 1
    assert plan.mode == "complete"


def test_q1_grand_total_matches_numpy(paths, port_session):
    t = [pq.read_table(p) for p in paths]
    ship = np.concatenate([x["l_shipdate"].to_numpy() for x in t])
    qty = np.concatenate([x["l_quantity"].to_numpy() for x in t])
    got = tpch.q1_dataframe(port_session, paths).collect()
    assert sum(got["count_order"].to_pylist()) == int((ship <= 10471).sum())
    assert sum(got["sum_qty"].to_pylist()) == pytest.approx(
        float(qty[ship <= 10471].sum()), rel=1e-12)
