"""Adaptive execution: the port's ``execs/adaptive.py`` against the JAX
package's, on the same numpy-seeded tables.

Counterparts of ``tests/test_adaptive.py``'s ten tests (``slow`` there,
unmarked here at their small sizes), of ``tests/test_join_strategies.py::
test_partition_wise_join_when_both_sides_large``'s adaptive on / off
case and of ``tests/test_runtime_filter.py::
test_adaptive_exchange_path_prunes``.  Every result is held against
both JAX engines (``engine="tpu"`` on the JAX CPU backend and
``engine="cpu"``).  A decision is asserted only where both packages
take it by construction: the port measures the store's bytes of live
rows, the JAX package its padded device buffers, so near a threshold
the two may differ.

Then the cases where the port's exchange could go wrong: a partition
read once a skew slice maps once, every slice holds rows, the static
width drains a wider split, the store gets its bytes back after a
runtime broadcast, and planning or ``explain()`` runs no map stage.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import session as JS
from spark_rapids_tpu.config import BATCH_SIZE_ROWS as J_BATCH_ROWS
from spark_rapids_tpu.config import SHUFFLE_PARTITIONS as J_SHUFFLE_PARTS
from spark_rapids_tpu.config import get_conf
from spark_rapids_tpu.execs import adaptive as JA
from spark_rapids_tpu.plan.planner import BROADCAST_THRESHOLD as J_BCAST
from spark_rapids_tpu.plan.planner import collect_exec as j_collect_exec
from spark_rapids_tpu.plan.planner import plan_query as j_plan_query

from spark_rapids_tpu_torch import TorchSession, col, count_star, lit, sum_
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.execs import adaptive as A
from spark_rapids_tpu_torch.execs.adaptive import (
    CoalescedShuffleReaderExec,
    TpuAdaptiveJoinExec,
)
from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
from spark_rapids_tpu_torch.execs.join import (
    TpuBroadcastHashJoinExec,
    TpuRuntimeFilterBuildExec,
    TpuShuffledHashJoinExec,
)
from spark_rapids_tpu_torch.io.scan import ParquetScanExec
from spark_rapids_tpu_torch.ops import kernels
from spark_rapids_tpu_torch.plan.planner import collect_exec
from differential import assert_tables_equal

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"


# --------------------------------------------------------------------- #
# The two packages on one set of tables
# --------------------------------------------------------------------- #

@pytest.fixture
def jax_conf():
    """Set JAX conf keys for one test (the JAX conf is process-wide);
    the test's batches are the JAX test's 1 000 rows."""
    conf = get_conf()
    saved = {}

    def put(key, value):
        if key.key not in saved:
            saved[key.key] = conf.get(key)
        conf.set(key.key, value)

    put(J_BATCH_ROWS, 1000)
    yield put
    for k, v in saved.items():
        conf.set(k, v)


@pytest.fixture
def joined_tables():
    """The JAX test's fact (5 000 rows, 200 keys) and dimension (200
    rows, a selectivity column)."""
    rng = np.random.default_rng(21)
    n = 5000
    fact = pa.table({"k": rng.integers(0, 200, n),
                     "v": rng.random(n),
                     "sel": rng.integers(0, 100, n)})
    dim = pa.table({"k": np.arange(200, dtype=np.int64),
                    "name": pa.array([f"name-{i}" for i in range(200)]),
                    "sel2": rng.integers(0, 100, 200)})
    return fact, dim


def _port_session(**keys) -> TorchSession:
    conf = {C.BATCH_ROWS: 1000}
    conf.update({getattr(C, k): v for k, v in keys.items()})
    return TorchSession(conf, device="cpu")


def _adaptive_nodes(plan) -> list:
    return [n for n in plan.walk() if isinstance(n, TpuAdaptiveJoinExec)]


def _jax_adaptive_nodes(exec_) -> list:
    out = []

    def walk(e):
        if isinstance(e, JA.TpuAdaptiveJoinExec):
            out.append(e)
        for c in e.children:
            walk(c)
    walk(exec_)
    return out


def _run_port(df):
    """(the plan after its run, its adaptive nodes, the result)."""
    plan = df.physical_plan()
    nodes = _adaptive_nodes(plan)
    return plan, nodes, collect_exec(plan, df._session.conf)


def _jax_decisions(jdf) -> tuple:
    """The JAX device engine's result and its adaptive decisions."""
    exec_, _ = j_plan_query(jdf._plan)
    nodes = _jax_adaptive_nodes(exec_)
    out = j_collect_exec(exec_)
    return out, [n._decision for n in nodes]


def _against_jax(got, jdf, approx_float=True) -> list:
    """Hold ``got`` against both JAX engines; the JAX decisions."""
    jtpu, decisions = _jax_decisions(jdf)
    assert_tables_equal(got, jtpu, approx_float=approx_float)
    assert_tables_equal(got, jdf.collect(engine="cpu"),
                        approx_float=approx_float)
    return decisions


# --------------------------------------------------------------------- #
# Counterparts of tests/test_adaptive.py
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("part_bytes,target", [
    ([10, 10, 10, 10], 20), ([0, 0, 0, 50], 20), ([100, 0, 0, 0], 20),
    ([5, 99, 5], 20), ([], 20), ([7], 1), ([0, 0], 1 << 30)])
def test_plan_coalesced_groups(part_bytes, target):
    got = A.plan_coalesced_groups(part_bytes, target)
    assert got == JA.plan_coalesced_groups(part_bytes, target)
    want = {(10, 20): [[0, 1], [2, 3]], (0, 20): [[0, 1, 2, 3]],
            (100, 20): [[0], [1, 2, 3]], (5, 20): [[0, 1], [2]]}
    if part_bytes and (part_bytes[0], target) in want:
        assert got == want[(part_bytes[0], target)]
    if not part_bytes:
        assert got == [[0]]


def test_adaptive_broadcast_switch(joined_tables, jax_conf):
    """Estimates say both sides are big (a Filter keeps its child's
    estimate); the filtered dimension's measured map output is tiny, so
    the join runs as a runtime broadcast in both packages."""
    fact, dim = joined_tables
    jax_conf(J_BCAST, 4 << 10)
    s = _port_session(BROADCAST_THRESHOLD=4 << 10)
    df = s.create_dataframe(fact).join(
        s.create_dataframe(dim).where(col("sel2") < lit(5)), on="k")
    plan, nodes, got = _run_port(df)
    assert len(nodes) == 1 and nodes[0] is plan
    assert nodes[0].decision.startswith("broadcast[right "), \
        nodes[0].decision
    assert nodes[0].metrics["adaptiveBroadcasts"] == 1
    assert isinstance(nodes[0]._decided, TpuBroadcastHashJoinExec)
    js = JS.TpuSession()
    jdf = js.create_dataframe(fact).join(
        js.create_dataframe(dim).where(JS.col("sel2") < 5), on="k")
    [jdec] = _against_jax(got, jdf)
    assert jdec.startswith("broadcast[right ")
    assert got.num_rows > 0


def test_adaptive_partition_coalescing(joined_tables, jax_conf):
    """Broadcast off and a 1 GiB advisory target: the 8 reduce
    partitions run as one coalesced group."""
    fact, dim = joined_tables
    jax_conf(J_BCAST, -1)
    jax_conf(JA.ADVISORY_PARTITION_BYTES, 1 << 30)
    s = _port_session(BROADCAST_THRESHOLD=-1,
                      ADVISORY_PARTITION_BYTES=1 << 30)
    df = s.create_dataframe(fact).join(s.create_dataframe(dim), on="k")
    plan, [node], got = _run_port(df)
    assert node.decision == "shuffled[8->1 parts]"
    assert node.metrics["coalescedPartitions"] == 7
    assert node.num_partitions == 8  # static, whatever was decided
    readers = node.readers()
    assert [r.node_desc() for r in readers] == [
        "CoalescedShuffleReaderExec [8 -> 1 partitions]"] * 2
    assert "CoalescedShuffleReaderExec [8 -> 1 partitions]" in \
        plan.tree_string()
    js = JS.TpuSession()
    jdf = js.create_dataframe(fact).join(js.create_dataframe(dim), on="k")
    [jdec] = _against_jax(got, jdf)
    assert "->1 parts" in jdec


def test_adaptive_disabled_keeps_static_plan(joined_tables, jax_conf):
    fact, dim = joined_tables
    jax_conf(JA.ADAPTIVE_ENABLED, False)
    jax_conf(J_BCAST, -1)
    s = _port_session(ADAPTIVE_ENABLED=False, BROADCAST_THRESHOLD=-1)
    df = s.create_dataframe(fact).join(s.create_dataframe(dim), on="k")
    plan = df.physical_plan()
    assert not _adaptive_nodes(plan)
    assert isinstance(plan, TpuShuffledHashJoinExec) and plan.partition_wise
    js = JS.TpuSession()
    jdf = js.create_dataframe(fact).join(js.create_dataframe(dim), on="k")
    assert _against_jax(df.collect(), jdf) == []


def test_plan_query_does_not_materialize(joined_tables):
    """Planning and explain() run no map stage: the node stays
    undecided, its exchanges unmapped, while a parent reads its
    static width."""
    fact, dim = joined_tables
    s = _port_session(BROADCAST_THRESHOLD=-1)
    df = (s.create_dataframe(fact).join(s.create_dataframe(dim), on="k")
          .group_by(col("name")).agg((sum_(col("v")), "s")))
    plan = df.physical_plan()
    nodes = _adaptive_nodes(plan)
    assert nodes and all(n._decided is None for n in nodes)
    assert all(n.num_partitions == 8 for n in nodes)
    text = df.explain()
    assert "TpuAdaptiveJoinExec [inner] strategy=undecided" in text
    for n in nodes:
        assert n._decided is None and n.decision == "undecided"
        for ex in n.children:
            assert ex._shuffle_id is None
            assert ex.metrics["mapBatches"] == 0
    for node in plan.walk():
        if hasattr(node, "close"):
            node.close()


def test_adaptive_broadcast_releases_build(joined_tables):
    """The runtime broadcast is not a child of the adaptive node; after
    the query its build is out of the store, and the store holds the
    device bytes it held before."""
    fact, dim = joined_tables
    s = _port_session(BROADCAST_THRESHOLD=4 << 10)
    df = s.create_dataframe(fact).join(
        s.create_dataframe(dim).where(col("sel2") < lit(5)), on="k")
    before = s.store.spill_stats()["device_used"]
    entries = set(s.store._entries)
    plan = df.physical_plan()
    [node] = _adaptive_nodes(plan)
    it = plan.execute()
    first = next(it)
    assert first.num_rows > 0
    # mid-run, the build is held at BROADCAST priority
    assert node._decided._build is not None
    assert s.store.spill_stats()["device_used"] > before
    it.close()
    collect_exec(plan, s.conf)  # drains and closes
    assert node.decision.startswith("broadcast")
    assert set(s.store._entries) == entries
    assert s.store.spill_stats()["device_used"] == before
    assert node._decided._build is None


@pytest.mark.parametrize("thr", [4 << 10, 1 << 30])
def test_adaptive_left_outer_differential(joined_tables, jax_conf, thr):
    """A left outer join with unmatched rows, under each strategy."""
    fact, dim = joined_tables
    half = dim.slice(0, 100)
    jax_conf(J_BCAST, thr)
    s = _port_session(BROADCAST_THRESHOLD=thr)
    df = s.create_dataframe(fact).join(s.create_dataframe(half), on="k",
                                       how="left_outer")
    plan, nodes, got = _run_port(df)
    js = JS.TpuSession()
    jdf = js.create_dataframe(fact).join(js.create_dataframe(half), on="k",
                                         how="left_outer")
    _against_jax(got, jdf)
    assert got.num_rows == fact.num_rows
    # 1 GiB: the static estimate broadcasts already; 4 KiB: adaptive,
    # which may build only the right side of a left outer join
    assert bool(nodes) == (thr == 4 << 10)
    if nodes:
        assert nodes[0].decision != "undecided"
        assert not nodes[0].decision.startswith("broadcast[left")


def test_plan_skew_groups_unit():
    lb = [10, 1000, 10, 10]
    rb = [10, 10, 10, 10]
    out = A.plan_skew_groups(lb, rb, target=300, factor=5.0, threshold=100,
                             join_type="inner")
    assert out == JA.plan_skew_groups(lb, rb, target=300, factor=5.0,
                                      threshold=100, join_type="inner")
    lg, rg, n = out
    assert n >= 2 and len(lg) == len(rg)
    slices = [g for g in lg if any(k > 1 for (_r, _i, k) in g)]
    assert slices and all(r == 1 for g in slices for (r, _i, _k) in g)
    for li, ri in zip(lg, rg):
        if any(k > 1 for (_r, _i, k) in li):
            assert ri == [(1, 0, 1)]
    assert A.plan_skew_groups(lb, rb, 300, 5.0, 100, "full_outer") is None
    assert A.plan_skew_groups(rb, lb, 300, 5.0, 100, "left_outer") is None


def _skewed_tables(seed, n, share, hot, n_keys):
    rng = np.random.default_rng(seed)
    keys = np.where(rng.random(n) < share, hot,
                    rng.integers(0, n_keys, n)).astype(np.int64)
    fact = pa.table({"k": keys, "v": rng.random(n)})
    dim = pa.table({"k": np.arange(n_keys, dtype=np.int64),
                    "name": pa.array([f"n{i}" for i in range(n_keys)])})
    return fact, dim


SKEW_KEYS = dict(BROADCAST_THRESHOLD=1, SKEW_THRESHOLD_BYTES=8 << 10,
                 SKEW_FACTOR=3.0, ADVISORY_PARTITION_BYTES=32 << 10)


def _jax_skew_conf(put, **keys):
    names = {"BROADCAST_THRESHOLD": J_BCAST,
             "SKEW_THRESHOLD_BYTES": JA.SKEW_THRESHOLD_BYTES,
             "SKEW_FACTOR": JA.SKEW_FACTOR,
             "ADVISORY_PARTITION_BYTES": JA.ADVISORY_PARTITION_BYTES,
             "SHUFFLE_PARTITIONS": J_SHUFFLE_PARTS}
    for k, v in keys.items():
        put(names[k], v)


def test_adaptive_skew_split_differential(jax_conf):
    """85 % of the fact rows share one key: the hot reduce partition is
    sliced, block-wise, and the result is the JAX engines'."""
    fact, dim = _skewed_tables(99, 20_000, 0.85, 7, 200)
    _jax_skew_conf(jax_conf, **SKEW_KEYS)
    s = _port_session(**SKEW_KEYS)
    df = s.create_dataframe(fact).join(s.create_dataframe(dim), on="k")
    plan, [node], got = _run_port(df)
    assert node.decision.startswith("shuffled[skew: "), node.decision
    assert node.metrics["skewSplits"] >= 2
    left, right = node.readers()
    assert "skew slices" in left.node_desc()
    assert all(r > 0 for r in left.slice_rows())
    js = JS.TpuSession()
    jdf = js.create_dataframe(fact).join(js.create_dataframe(dim), on="k")
    [jdec] = _against_jax(got, jdf)
    assert "skew" in jdec
    assert got.num_rows == fact.num_rows


def test_skew_split_wider_than_static_width(jax_conf):
    """Two static partitions and a split into more tasks: the last
    static partition runs the overflow, through a parent that iterates
    the static width on the session's pool.  (Of two partitions neither
    passes twice their median, the JAX test's factor: a factor of 1
    makes the hot one skewed.)"""
    fact, dim = _skewed_tables(7, 12_000, 0.9, 1, 40)
    keys = dict(SHUFFLE_PARTITIONS=2, BROADCAST_THRESHOLD=1,
                SKEW_THRESHOLD_BYTES=4 << 10, SKEW_FACTOR=1.0,
                ADVISORY_PARTITION_BYTES=16 << 10)
    _jax_skew_conf(jax_conf, **keys)
    s = _port_session(**keys)
    df = s.create_dataframe(fact).join(s.create_dataframe(dim), on="k")
    total = df.agg((count_star(), "n"))
    plan = total.physical_plan()
    [node] = _adaptive_nodes(plan)
    got = collect_exec(plan, s.conf)
    assert node.num_partitions == 2
    assert node._decided.num_partitions > 2, node.decision
    assert got.to_pydict()["n"] == [12_000]
    js = JS.TpuSession()
    jtotal = js.create_dataframe(fact).join(
        js.create_dataframe(dim), on="k").agg((JS.count_star(), "n"))
    assert jtotal.collect(engine="tpu").to_pydict()["n"] == [12_000]
    assert jtotal.collect(engine="cpu").to_pydict()["n"] == [12_000]
    # and with the pool off, the same count
    serial = _port_session(**keys)
    serial.conf.set(C.TASK_THREADS, 1)
    assert serial.create_dataframe(fact).join(
        serial.create_dataframe(dim), on="k").agg(
        (count_star(), "n")).collect().to_pydict()["n"] == [12_000]


# --------------------------------------------------------------------- #
# The plans of the other JAX tests
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("adaptive", [True, False], ids=["default", "off"])
def test_partition_wise_join_when_both_sides_large(jax_conf, adaptive):
    """``test_join_strategies.py``'s case: both sides too big to
    broadcast.  Under the default the planner defers the partition-wise
    shape behind an adaptive join over two exchanges; off, the static
    partition-wise join."""
    rng = np.random.default_rng(9)
    a = pa.table({"k": rng.integers(0, 50, 4000),
                  "va": rng.integers(0, 100, 4000).astype(np.int64)})
    b = pa.table({"k": rng.integers(0, 50, 4000),
                  "vb": rng.integers(0, 100, 4000).astype(np.int64)})
    jax_conf(J_BCAST, 0)
    jax_conf(J_BATCH_ROWS, 512)
    jax_conf(JA.ADAPTIVE_ENABLED, adaptive)
    s = TorchSession({C.BROADCAST_THRESHOLD: 0, C.BATCH_ROWS: 512,
                      C.ADAPTIVE_ENABLED: adaptive}, device="cpu")
    df = s.create_dataframe(a).join(s.create_dataframe(b), on="k")
    plan = df.physical_plan()
    if adaptive:
        assert isinstance(plan, TpuAdaptiveJoinExec)
        assert all(isinstance(c, TpuShuffleExchangeExec)
                   for c in plan.children)
    else:
        assert isinstance(plan, TpuShuffledHashJoinExec)
        assert plan.partition_wise and plan.num_partitions > 1
    got = collect_exec(plan, s.conf)
    js = JS.TpuSession()
    jdf = js.create_dataframe(a).join(js.create_dataframe(b), on="k")
    decisions = _against_jax(got, jdf, approx_float=False)
    assert len(decisions) == int(adaptive)
    if adaptive:
        # 4 000 x 4 000 rows over 50 keys: no side fits 0 bytes
        assert plan.decision.startswith("shuffled")
        assert decisions[0].startswith("shuffled")


def _q3_files(tmp_path):
    """The JAX runtime-filter test's q3 shape: 4 lineitem files, one
    orders file whose date filter keeps a tenth of the orders."""
    rng = np.random.default_rng(0)
    li = []
    for i in range(4):
        p = str(tmp_path / f"li{i}.parquet")
        pq.write_table(pa.table({
            "l_orderkey": rng.integers(0, 4000, 4096).astype(np.int64),
            "l_price": rng.random(4096)}), p, row_group_size=1024)
        li.append(p)
    orders = str(tmp_path / "orders.parquet")
    pq.write_table(pa.table({
        "o_orderkey": np.arange(4000, dtype=np.int64),
        "o_date": rng.integers(0, 100, 4000).astype(np.int32)}), orders)
    return li, orders


def _q3(session, li, orders, jax=False):
    c, s, ten = (JS.col, JS.sum_, 10) if jax else (col, sum_, lit(10))
    o = session.read_parquet(orders).where(c("o_date") < ten)
    return (session.read_parquet(*li)
            .join(o, left_on=[c("l_orderkey")], right_on=[c("o_orderkey")])
            .group_by(c("l_orderkey"))
            .agg((s(c("l_price")), "rev")))


def test_adaptive_exchange_path_prunes(tmp_path, jax_conf):
    """Broadcast off: the build collector rides the right exchange's map
    stage, which the adaptive join runs first (``rf_build_first``), so
    the left scan is pruned; the rows are the JAX engines'."""
    li, orders = _q3_files(tmp_path)
    s = TorchSession({TTB: 1, C.BROADCAST_THRESHOLD: -1}, device="cpu")
    df = _q3(s, li, orders)
    plan = df.physical_plan()
    [node] = _adaptive_nodes(plan)
    assert node.rf_build_first == "right"
    [build] = [n for n in plan.walk()
               if isinstance(n, TpuRuntimeFilterBuildExec)]
    assert isinstance(node.children[1], TpuShuffleExchangeExec)
    assert node.children[1].children[0] is build
    got = collect_exec(plan, s.conf)
    scans = [n for n in plan.walk()
             if isinstance(n, ParquetScanExec) and n.runtime_filters]
    assert scans and sum(sc.metrics["rfPrunedRows"] for sc in scans) > 0
    jax_conf(J_BCAST, -1)
    _against_jax(got, _q3(JS.TpuSession(), li, orders, jax=True))


# --------------------------------------------------------------------- #
# Where the port's exchange could go wrong
# --------------------------------------------------------------------- #

@pytest.fixture
def k1_calls(monkeypatch):
    """Calls of K1's wrapper (the plain version runs here: count calls,
    one per map batch of a hash exchange)."""
    calls = []
    real = kernels.hash_columns

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(kernels, "hash_columns", counting)
    return calls


def test_skew_read_maps_once(k1_calls):
    """The hot partition is read once a slice, and the whole build
    partition once a slice, without a second map stage: mapBatches and
    K1's calls are one map stage's."""
    fact, dim = _skewed_tables(99, 20_000, 0.85, 7, 200)
    s = _port_session(RF_ENABLED=False, **SKEW_KEYS)
    df = s.create_dataframe(fact).join(s.create_dataframe(dim), on="k")
    plan, [node], got = _run_port(df)
    assert node.decision.startswith("shuffled[skew")
    lex, rex = node.children
    # fact: 20 map batches of 1 000 rows; dim: one
    assert lex.metrics["mapBatches"] == 20
    assert rex.metrics["mapBatches"] == 1
    assert len(k1_calls) == 20 + 1
    left, right = node.readers()
    n_slices = len(left.slice_rows())
    assert n_slices == node.metrics["skewSplits"] >= 2
    # the build partition was read whole once a slice, from one stage
    hot = next(r for grp in left.groups for r, _i, k in grp if k > 1)
    assert sum(1 for grp in right.groups for r, _i, _k in grp
               if r == hot) == n_slices
    assert got.num_rows == 20_000


def test_every_slice_holds_rows():
    """Slices deal blocks: each of k slices of a partition of at least k
    blocks reads rows, and together they read the partition once."""
    fact, dim = _skewed_tables(3, 16_000, 0.8, 5, 100)
    s = _port_session(BATCH_ROWS=500, **SKEW_KEYS)
    df = s.create_dataframe(fact).join(s.create_dataframe(dim), on="k")
    plan, [node], got = _run_port(df)
    left, _right = node.readers()
    rows = left.slice_rows()
    assert len(rows) >= 2 and all(r > 0 for r in rows), rows
    sliced = {r for grp in left.groups for r, _i, k in grp if k > 1}
    assert len(sliced) == 1  # the hot key's partition only
    assert got.num_rows == 16_000


@pytest.mark.parametrize("rf", [True, False], ids=["rf_on", "rf_off"])
def test_build_side_maps_first_when_filtered(tmp_path, rf):
    """With a runtime filter the right map stage runs first; without,
    the left one (the order the decision reads its stats)."""
    li, orders = _q3_files(tmp_path)
    s = TorchSession({TTB: 1, C.BROADCAST_THRESHOLD: -1,
                      C.RF_ENABLED: rf}, device="cpu")
    plan = _q3(s, li, orders).physical_plan()
    [node] = _adaptive_nodes(plan)
    order = []
    for side, ex in zip(("left", "right"), node.children):
        real = ex._ensure_map_stage

        def traced(real=real, side=side):
            if not order or order[-1] != side:
                order.append(side)
            return real()
        ex._ensure_map_stage = traced
    collect_exec(plan, s.conf)
    assert order[:2] == (["right", "left"] if rf else ["left", "right"])


def test_decision_in_tree_string_after_a_run(joined_tables):
    fact, dim = joined_tables
    s = _port_session(BROADCAST_THRESHOLD=-1,
                      ADVISORY_PARTITION_BYTES=1 << 30)
    df = s.create_dataframe(fact).join(s.create_dataframe(dim), on="k")
    plan = df.physical_plan()
    assert plan.tree_string().splitlines()[0] == \
        "TpuAdaptiveJoinExec [inner] strategy=undecided"
    collect_exec(plan, s.conf)
    lines = plan.tree_string().splitlines()
    assert lines[0] == \
        "TpuAdaptiveJoinExec [inner] strategy=shuffled[8->1 parts]"
    assert lines[1] == "  CoalescedShuffleReaderExec [8 -> 1 partitions]"
    assert lines[2].startswith("    TpuShuffleExchangeExec hashpartitioning(")


def test_readers_and_static_width_feed_the_runtime_filter_walk(tmp_path):
    """``_probe_scan_targets`` walks through a coalesced reader to the
    scans under it, as through an exchange."""
    from spark_rapids_tpu_torch.plan.runtime_filter import (
        _probe_scan_targets,
    )

    li, _orders = _q3_files(tmp_path)
    s = TorchSession({TTB: 1}, device="cpu")
    scan_plan = s.read_parquet(*li).physical_plan()
    from spark_rapids_tpu_torch.ops.partition import HashPartitioning
    from spark_rapids_tpu_torch.exprs.base import ColumnReference

    ex = TpuShuffleExchangeExec(HashPartitioning([ColumnReference(
        "l_orderkey")], 4), scan_plan, s.shuffle_manager)
    reader = CoalescedShuffleReaderExec(ex, [[0, 1], [2, 3]])
    targets = _probe_scan_targets(reader, 0)
    assert [(type(n).__name__, c) for n, c in targets] == [
        ("ParquetScanExec", "l_orderkey")]
    assert reader.num_partitions == 2
    assert reader.node_desc() == \
        "CoalescedShuffleReaderExec [4 -> 2 partitions]"
    rows = sum(b.num_rows for p in range(2)
               for b in reader.execute_partition(p))
    assert rows == 4 * 4096
    ex.close()


def test_adopted_counters_read_live():
    """``_adopt_metrics`` reads the decided exec's counters through the
    adaptive node's (``Metrics.adopt``): live, its own kept first."""
    from spark_rapids_tpu_torch.execs.base import Metrics

    own = Metrics("skewSplits", "numOutputRows")
    theirs = Metrics("numOutputRows", "joinTime")
    own.adopt(theirs)
    theirs.add("joinTime", 5)
    theirs.add("numOutputRows", 7)
    own.add("skewSplits", 2)
    assert dict(own) == {"skewSplits": 2, "numOutputRows": 0,
                         "joinTime": 5}
    theirs.add("joinTime", 1)
    assert own["joinTime"] == 6 and len(own) == 3
    with pytest.raises(KeyError):
        own["missing"]


@pytest.mark.parametrize("seed", range(12))
def test_skew_and_coalesce_groups_equal_jax(seed):
    """Seeded byte and block lists through both packages' planners."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    lb = rng.integers(0, 1000, n)
    rb = rng.integers(0, 1000, n)
    lb[rng.integers(0, n)] *= int(rng.integers(1, 40))
    lb, rb = [int(x) for x in lb], [int(x) for x in rb]
    lblocks = [int(x) for x in rng.integers(0, 6, n)]
    rblocks = [int(x) for x in rng.integers(0, 6, n)]
    target = int(rng.integers(50, 2000))
    assert A.plan_coalesced_groups(lb, target) == \
        JA.plan_coalesced_groups(lb, target)
    for jt in ("inner", "left_outer", "right_outer", "full_outer",
               "left_semi", "left_anti"):
        for blocks in ((None, None), (lblocks, rblocks)):
            got = A.plan_skew_groups(lb, rb, target, 3.0, 100, jt, *blocks)
            want = JA.plan_skew_groups(lb, rb, target, 3.0, 100, jt,
                                       *blocks)
            assert got == want, (jt, blocks)


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
