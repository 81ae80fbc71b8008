"""TPC-H q3 end to end: the port on the CPU against both JAX engines,
on the same small Parquet files, and the port's physical plan for it.

``scan.taskTargetBytes`` = 1 makes every file its own scan task, so the
port plans a hash exchange on each join side, a partition-wise join,
partial aggregate -> hash exchange -> final aggregate, and a top-n on
top; each exchange hashes its keys through K1 (its plain version
here).  The JAX results are computed once for the module: the JAX
shuffle layer reads the process-global conf, which goes through
``set_conf`` and is restored afterwards.
"""

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import bench
from spark_rapids_tpu.config import get_conf, set_conf
from spark_rapids_tpu.session import TpuSession

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession, col, lit, tpch
from spark_rapids_tpu_torch.execs.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
from spark_rapids_tpu_torch.execs.join import (
    TpuRuntimeFilterBuildExec,
    TpuShuffledHashJoinExec,
)
from spark_rapids_tpu_torch.execs.sort import TpuTopNExec
from spark_rapids_tpu_torch.ops import kernels
from spark_rapids_tpu_torch.ops.partition import HashPartitioning

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
#: -1 turns broadcast joins off: the orders side would broadcast
BCAST = "spark.rapids.tpu.sql.autoBroadcastJoinThresholdBytes"
ADAPTIVE = "spark.rapids.tpu.sql.adaptive.enabled"
ROWS = 4096
N_ORDERS = 2048
N_FILES = 3


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("q3")
    li = tpch.make_lineitem(str(d), n_files=N_FILES, with_orderkey=True,
                            n_orders=N_ORDERS, rows_per_file=ROWS)
    return li, tpch.make_orders(str(d), n_orders=N_ORDERS)


@pytest.fixture(scope="module")
def jax_results(data):
    conf = get_conf()
    saved = dict(conf._values)
    conf.set(TTB, 1)
    set_conf(conf)
    try:
        df = bench.q3_dataframe(TpuSession(conf), *data)
        return {e: df.collect(engine=e) for e in ("tpu", "cpu")}
    finally:
        conf._values.clear()
        conf._values.update(saved)
        set_conf(conf)


@pytest.fixture
def port_session():
    return TorchSession({TTB: 1, BCAST: -1}, device="cpu")


def _significant(table: pa.Table, digits: int = 12) -> pa.Table:
    """Float columns rounded to ``digits`` significant digits: the
    engines sum revenue in different orders (see test_torch_q1)."""
    cols = []
    for c in table.columns:
        if pa.types.is_floating(c.type):
            vals = [None if v is None else float(f"{v:.{digits - 1}e}")
                    for v in c.to_pylist()]
            c = pa.array(vals, c.type)
        cols.append(c)
    return pa.Table.from_arrays(cols, names=table.schema.names)


def test_make_orders_copies_bench(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    want = bench.make_orders(str(tmp_path / "a"), n_orders=N_ORDERS)
    got = tpch.make_orders(str(tmp_path / "b"), n_orders=N_ORDERS)
    assert pq.read_table(got).equals(pq.read_table(want))


@pytest.mark.parametrize("engine", ["tpu", "cpu"])
def test_q3_matches_both_jax_engines(engine, data, jax_results,
                                     port_session):
    got = tpch.q3_dataframe(port_session, *data).collect()
    assert got.num_rows == 10
    assert got.schema.names == ["l_orderkey", "o_orderdate",
                                "o_shippriority", "revenue"]
    assert_tables_equal(_significant(got),
                        _significant(jax_results[engine]),
                        ignore_order=False, approx_float=True)


def test_q3_plan_and_its_hashes(data, port_session, monkeypatch):
    # the static plan; the adaptive join's is the test below
    static = TorchSession({TTB: 1, BCAST: -1, ADAPTIVE: False}, device="cpu")
    df = tpch.q3_dataframe(static, *data)
    plan = df.physical_plan()
    assert isinstance(plan, TpuTopNExec) and plan.n == 10
    final = plan.children[0]
    assert isinstance(final, TpuHashAggregateExec) and final.mode == "final"
    agg_ex = final.children[0]
    assert isinstance(agg_ex, TpuShuffleExchangeExec)
    assert [e.name for e in agg_ex.partitioning.exprs] == [
        "l_orderkey", "o_orderdate", "o_shippriority"]
    partial = agg_ex.children[0]
    assert partial.mode == "partial"
    join = partial.children[0]
    assert isinstance(join, TpuShuffledHashJoinExec)
    assert join.partition_wise and join.join_type == "inner"
    sides = join.children
    assert all(isinstance(s, TpuShuffleExchangeExec)
               and isinstance(s.partitioning, HashPartitioning)
               for s in sides)
    assert [s.partitioning.exprs[0].name for s in sides] == [
        "l_orderkey", "o_orderkey"]
    assert sides[0].num_partitions == sides[1].num_partitions == 8
    # each scan reads only the columns q3 uses; its Filter is elided,
    # so it emits only what the plan reads above it
    scans = [n for n in plan.walk() if not n.children]
    assert [s._read_schema.names for s in scans] == [
        ["l_extendedprice", "l_discount", "l_shipdate", "l_orderkey"],
        ["o_orderkey", "o_orderdate", "o_shippriority"]]
    assert [s._schema.names for s in scans] == [
        ["l_extendedprice", "l_discount", "l_orderkey"],
        ["o_orderkey", "o_orderdate", "o_shippriority"]]
    assert all(s.exact_prefilter for s in scans)

    # the runtime filter: orders' keys prune the lineitem scan
    rf_build = sides[1].children[0]
    assert isinstance(rf_build, TpuRuntimeFilterBuildExec)
    assert [(s.name, n) for s in scans for n, _ in s.runtime_filters] == [
        ("ParquetScanExec", "l_orderkey")]

    calls = []
    real = kernels.hash_columns

    def spy(cols, num_rows, device, seed=42, num_partitions=0):
        calls.append(([c.dtype.name for c in cols], num_rows,
                      num_partitions, seed))
        return real(cols, num_rows, device, seed, num_partitions)

    monkeypatch.setattr(kernels, "hash_columns", spy)
    df.collect()
    # one hash per non-empty map batch: a lineitem file each, the orders
    # file, and the partial aggregate of each join partition
    ex = [c for c in calls if c[2] == 8]
    kinds = sorted({tuple(c[0]) for c in ex})
    assert kinds == [("bigint",), ("bigint", "int", "int")]
    by_kind = [sum(1 for c in ex if tuple(c[0]) == k) for k in kinds]
    assert by_kind == [N_FILES + 1, 8]
    assert all(n > 0 for _, n, _, _ in ex)
    # and the filter's two seeded lanes over the one orders batch, then
    # over the orders keys' range for its range table
    lanes = [(c[0], c[2], c[3]) for c in calls if c[2] != 8]
    assert lanes == [(["bigint"], 0, 42), (["bigint"], 0, 0x9747B28C)] * 2


def test_q3_adaptive_plan_and_its_hashes(data, port_session, monkeypatch):
    """The default plan: the join is a TpuAdaptiveJoinExec over the two
    exchanges, the runtime filter's build under the orders exchange,
    whose map stage runs first.  With broadcast off it decides on a
    shuffled join over coalesced reduce groups; K1 hashes each map batch
    of the join's exchanges once, and the aggregate's exchange once a
    non-empty group."""
    from spark_rapids_tpu_torch.execs.adaptive import TpuAdaptiveJoinExec
    from spark_rapids_tpu_torch.plan.planner import collect_exec

    df = tpch.q3_dataframe(port_session, *data)
    plan = df.physical_plan()
    partial = plan.children[0].children[0].children[0]
    assert partial.mode == "partial"
    join = partial.children[0]
    assert isinstance(join, TpuAdaptiveJoinExec)
    assert join.join_type == "inner" and join.decision == "undecided"
    assert join.rf_build_first == "right"
    sides = join.children
    assert [s.partitioning.exprs[0].name for s in sides] == [
        "l_orderkey", "o_orderkey"]
    assert isinstance(sides[1].children[0], TpuRuntimeFilterBuildExec)
    calls = []
    real = kernels.hash_columns

    def spy(cols, num_rows, device, seed=42, num_partitions=0):
        calls.append(([c.dtype.name for c in cols], num_partitions))
        return real(cols, num_rows, device, seed, num_partitions)

    monkeypatch.setattr(kernels, "hash_columns", spy)
    got = collect_exec(plan, port_session.conf)
    assert join.decision.startswith("shuffled"), join.decision
    groups = len(join.readers()[0].groups) if join.readers() else 8
    assert join.metrics["coalescedPartitions"] == 8 - groups
    ex = [tuple(c) for c, parts in calls if parts == 8]
    assert ex.count(("bigint",)) == N_FILES + 1
    assert 0 < ex.count(("bigint", "int", "int")) <= groups
    want = tpch.q3_dataframe(TorchSession(
        {TTB: 1, BCAST: -1, ADAPTIVE: False}, device="cpu"), *data).collect()
    assert_tables_equal(_significant(got), _significant(want),
                        ignore_order=False, approx_float=True)


def test_q3_in_one_partition_a_side_joins_wide(data, port_session):
    # small files pack into one task
    s = TorchSession({BCAST: -1}, device="cpu")
    df = tpch.q3_dataframe(s, *data)
    join = next(n for n in df.physical_plan().walk()
                if isinstance(n, TpuShuffledHashJoinExec))
    assert not join.partition_wise
    assert not any(isinstance(c, TpuShuffleExchangeExec)
                   for c in join.children)
    want = tpch.q3_dataframe(port_session, *data).collect()
    assert_tables_equal(_significant(df.collect()), _significant(want),
                        ignore_order=False, approx_float=True)


def test_unported_joins_raise(data, port_session):
    """A residual condition or a missing key on an outer, semi or anti
    join has no device exec (it would raise): the planner tags the join
    and plans it on the CPU engine, as the JAX planner does."""
    from spark_rapids_tpu_torch.execs.fallback import CpuFallbackExec

    li = port_session.read_parquet(*data[0])
    orders = port_session.read_parquet(data[1])
    residual = li.join(orders, how="left_outer",
                       left_on=[col("l_orderkey")],
                       right_on=[col("o_orderkey")],
                       condition=col("l_shipdate") > col("o_orderdate"))
    keyless = li.join(orders, how="left_semi")
    for df, reason in ((residual, "residual condition"),
                       (keyless, "without keys")):
        root = df.physical_plan()
        assert isinstance(root, CpuFallbackExec)
        assert any(reason in r for r in root.reasons)
    with pytest.raises(ValueError):
        li.join(orders, how="sideways", left_on=[col("l_orderkey")],
                right_on=[lit(1)])


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
