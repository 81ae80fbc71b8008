"""TPC-DS q67 end to end: the port on the CPU against both JAX engines,
on the same small Parquet files, and the port's physical plan for it.

``scan.taskTargetBytes`` = 1 makes every file its own scan task, so the
port plans, as the JAX package does: partial aggregate -> hash exchange
on (store, item) -> final aggregate -> hash exchange on the store (the
window's partition key) -> a per-partition window -> the rank filter ->
a range exchange -> a partition-scoped sort.  The two hash exchanges
hash their keys through K1 (its plain version here); the range exchange
hashes nothing.  The JAX shuffle layer reads the process-global conf,
which goes through ``set_conf`` and is restored afterwards.

The engines add a group's sales in different orders, so sums are
compared to 12 significant digits; on these files (seed 67, 3 x 4096
rows) no two sums of a store's top 11 lie within rel 1e-9 of each other,
which ``test_no_near_ties_at_the_rank_boundary`` checks, so the ranks
cannot flip with the order of addition.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import bench
from spark_rapids_tpu.config import get_conf, set_conf
from spark_rapids_tpu.session import TpuSession

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession, tpcds
from spark_rapids_tpu_torch.execs.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.execs.basic import TpuFilterExec, TpuProjectExec
from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
from spark_rapids_tpu_torch.execs.sort import TpuSortExec
from spark_rapids_tpu_torch.execs.window import TpuWindowExec
from spark_rapids_tpu_torch.ops import kernels
from spark_rapids_tpu_torch.ops.partition import (
    HashPartitioning,
    RangePartitioning,
)

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
N_FILES = 3
ROWS = N_FILES * 4096


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("q67")
    return tpcds.make_store_sales(str(d), n_rows=ROWS, n_files=N_FILES)


@pytest.fixture(scope="module")
def jax_results(paths):
    conf = get_conf()
    saved = dict(conf._values)
    conf.set(TTB, 1)
    set_conf(conf)
    try:
        df = bench.q67_dataframe(TpuSession(conf), paths)
        return {e: df.collect(engine=e) for e in ("tpu", "cpu")}
    finally:
        conf._values.clear()
        conf._values.update(saved)
        set_conf(conf)


@pytest.fixture
def port_session():
    return TorchSession({TTB: 1}, device="cpu")


def _significant(table: pa.Table, digits: int = 12) -> pa.Table:
    """Float columns rounded to ``digits`` significant digits (see
    test_torch_q1)."""
    cols = []
    for c in table.columns:
        if pa.types.is_floating(c.type):
            c = pa.array([None if v is None else float(f"{v:.{digits - 1}e}")
                          for v in c.to_pylist()], c.type)
        cols.append(c)
    return pa.Table.from_arrays(cols, names=table.schema.names)


def test_make_store_sales_copies_bench(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    want = bench.make_store_sales(str(tmp_path / "a"), n_rows=ROWS,
                                  n_files=N_FILES)
    got = tpcds.make_store_sales(str(tmp_path / "b"), n_rows=ROWS,
                                 n_files=N_FILES)
    assert len(got) == len(want) == N_FILES
    for g, w in zip(got, want):
        assert pq.read_table(g).equals(pq.read_table(w))


def test_no_near_ties_at_the_rank_boundary(paths):
    t = pa.concat_tables([pq.read_table(p) for p in paths])
    sales = np.asarray(t["ss_sales_price"]) * np.asarray(t["ss_quantity"])
    keys = np.asarray(t["ss_store_sk"]) * 10000 + np.asarray(t["ss_item_sk"])
    groups, inv = np.unique(keys, return_inverse=True)
    sums = np.bincount(inv, weights=sales)
    for store in np.unique(groups // 10000):
        top = np.sort(sums[groups // 10000 == store])[::-1][:11]
        gaps = np.abs(np.diff(top)) / top[1:]
        assert np.all((gaps == 0) | (gaps > 1e-9)), store


@pytest.mark.parametrize("engine", ["tpu", "cpu"])
def test_q67_matches_both_jax_engines(engine, paths, jax_results,
                                      port_session):
    got = tpcds.q67_dataframe(port_session, paths).collect()
    assert got.schema.names == ["ss_store_sk", "ss_item_sk", "sumsales",
                                "rk"]
    assert got.num_rows >= 80 and got["rk"].to_pylist().count(1) >= 8
    assert_tables_equal(_significant(got),
                        _significant(jax_results[engine]),
                        ignore_order=False, approx_float=True)


def test_q67_plan(paths, port_session):
    plan = tpcds.q67_dataframe(port_session, paths).physical_plan()
    assert isinstance(plan, TpuSortExec) and plan.scope == "partition"
    rex = plan.children[0]
    assert isinstance(rex, TpuShuffleExchangeExec)
    assert isinstance(rex.partitioning, RangePartitioning)
    assert [k.expr.name for k in rex.partitioning.keys] == [
        "ss_store_sk", "rk", "ss_item_sk"]
    filt = rex.children[0]
    assert isinstance(filt, TpuFilterExec)
    assert isinstance(filt.children[0], TpuProjectExec)
    window = filt.children[0].children[0]
    assert isinstance(window, TpuWindowExec) and window.partitioned
    wex = window.children[0]
    assert isinstance(wex.partitioning, HashPartitioning)
    assert [e.name for e in wex.partitioning.exprs] == ["ss_store_sk"]
    final = wex.children[0]
    assert isinstance(final, TpuHashAggregateExec) and final.mode == "final"
    aex = final.children[0]
    assert isinstance(aex.partitioning, HashPartitioning)
    assert [e.name for e in aex.partitioning.exprs] == [
        "ss_store_sk", "ss_item_sk"]
    partial = aex.children[0]
    assert partial.mode == "partial"
    assert partial.children[0].num_partitions == N_FILES
    assert wex.num_partitions == aex.num_partitions == rex.num_partitions \
        == 8


def test_q67_hashes_once_per_hash_map_batch(paths, port_session,
                                            monkeypatch):
    df = tpcds.q67_dataframe(port_session, paths)
    plan = df.physical_plan()
    final = next(n for n in plan.walk()
                 if isinstance(n, TpuHashAggregateExec) and n.mode == "final")
    planned = sum(1 for p in range(final.num_partitions)
                  for b in final.execute_partition(p) if b.num_rows)
    for node in plan.walk():
        if hasattr(node, "close"):
            node.close()
    calls, strings = [], []
    real = kernels.hash_columns

    def spy(cols, num_rows, device, seed=42, num_partitions=0):
        calls.append((tuple(c.dtype.name for c in cols), num_rows,
                      num_partitions))
        return real(cols, num_rows, device, seed, num_partitions)

    monkeypatch.setattr(kernels, "hash_columns", spy)
    monkeypatch.setattr(kernels, "hash_string",
                        lambda *a: strings.append(a))
    df.collect()
    # one per scan task's partial, one per non-empty final partition;
    # the range exchange hashes nothing
    assert sorted({c[0] for c in calls}) == [("bigint",),
                                            ("bigint", "bigint")]
    assert sum(1 for c in calls if c[0] == ("bigint", "bigint")) == N_FILES
    assert sum(1 for c in calls if c[0] == ("bigint",)) == planned == 8
    assert all(n > 0 and p == 8 for _, n, p in calls)
    assert strings == []


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
