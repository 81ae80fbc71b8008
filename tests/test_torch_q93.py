"""TPC-DS q93 (store_sales LEFT OUTER JOIN store_returns, the reason
join, a CASE per row) end to end: the port on the CPU against both JAX
engines and the JAX SQL frontend, on the JAX package's mini catalog;
a variant without the reason join, which keeps the sales no return
matched (the outer join's NULL-extended rows and the CASE's ELSE
branch, which q93 itself never reaches); the plan; K1's launches; the
partition-wise left outer join's edge cases; and the port's copies of
the catalog's store_returns and reason generators.

The catalog is ``tpcds_schema.generate(0.9, seed=7)``: below 0.9 it has
fewer than nine reasons, so "Did not like the model" (key 9) is missing
and q93 is empty; at 0.9 it has 100 rows.  store_sales is split into 3
files and ``scan.taskTargetBytes`` = 1 makes each its own scan task.
The broadcast threshold (4 KiB) keeps store_returns (2 700 rows)
shuffled and lets the one filtered reason row broadcast.  The JAX
engines read the process-global conf, which goes through ``set_conf``
and is restored afterwards.  Float sums compare with ``approx_float``
(9 decimals); everything else exactly.
"""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.config import get_conf, set_conf
from spark_rapids_tpu.execs.join import (
    TpuRuntimeFilterBuildExec as JRFBuild,
)
from spark_rapids_tpu.exprs import predicates as JP
from spark_rapids_tpu.plan.planner import plan_query
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import count_star as jcount_star
from spark_rapids_tpu.session import lit as jlit
from spark_rapids_tpu.session import sum_ as jsum
from spark_rapids_tpu.tools import tpcds_schema
from spark_rapids_tpu.tools.sweep import build_session
from spark_rapids_tpu.tools.tpcds_queries import QUERIES

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession, col, count_star, lit, sum_
from spark_rapids_tpu_torch import tpcds
from spark_rapids_tpu_torch.execs.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
from spark_rapids_tpu_torch.execs.join import (
    TpuBroadcastHashJoinExec,
    TpuRuntimeFilterBuildExec,
    TpuShuffledHashJoinExec,
)
from spark_rapids_tpu_torch.execs.sort import TpuTopNExec
from spark_rapids_tpu_torch.exprs.predicates import CaseWhen
from spark_rapids_tpu_torch.io.scan import ParquetScanExec
from spark_rapids_tpu_torch.ops import kernels
from spark_rapids_tpu_torch.plan import runtime_filter as RF

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
BCAST = "spark.rapids.tpu.sql.autoBroadcastJoinThresholdBytes"
CHUNK = "spark.rapids.tpu.sql.join.outputChunkRows"
SCALE, SEED, N_FILES, THRESHOLD = 0.9, 7, 3, 4096
NAMES = ["ss_customer_sk", "sumsales"]
CONF = {TTB: 1, BCAST: THRESHOLD}


@pytest.fixture(scope="module")
def catalog():
    return tpcds_schema.generate(SCALE, seed=SEED)


@pytest.fixture(scope="module")
def data(tmp_path_factory, catalog):
    d = tmp_path_factory.mktemp("q93")
    sr, reason = str(d / "store_returns.parquet"), str(d / "reason.parquet")
    pq.write_table(catalog["store_returns"], sr)
    pq.write_table(catalog["reason"], reason)
    ss = catalog["store_sales"]
    per = -(-ss.num_rows // N_FILES)
    paths = []
    for i in range(N_FILES):
        p = str(d / f"store_sales-{i}.parquet")
        pq.write_table(ss.slice(i * per, per), p)
        paths.append(p)
    return paths, sr, reason


def _q93(ns, session, ss_paths, sr_path, reason_path, with_reason=True):
    """q93 as ``tpcds.q93_dataframe`` writes it, against either package
    (``ns``: its ``col``, ``lit``, ``sum_`` and ``CaseWhen``);
    ``with_reason=False`` drops the reason join, so every sale counts,
    returned or not."""
    c, lit_ = ns["col"], ns["lit"]
    ss = session.read_parquet(*ss_paths)
    sr = session.read_parquet(sr_path).select(
        c("sr_item_sk"), c("sr_ticket_number"), c("sr_reason_sk"),
        c("sr_return_quantity"))
    joined = ss.join(sr, left_on=[c("ss_item_sk"), c("ss_ticket_number")],
                     right_on=[c("sr_item_sk"), c("sr_ticket_number")],
                     how="left_outer")
    if with_reason:
        reason = (session.read_parquet(reason_path)
                  .where(c("r_reason_desc").eq(lit_(tpcds.Q93_REASON)))
                  .select(c("r_reason_sk")))
        joined = joined.join(reason, left_on=[c("sr_reason_sk")],
                             right_on=[c("r_reason_sk")])
    qty, price = c("ss_quantity"), c("ss_sales_price")
    act = ns["CaseWhen"](
        ((c("sr_return_quantity").is_not_null(),
          (qty - c("sr_return_quantity")) * price),), qty * price)
    return (joined.select(c("ss_customer_sk"), act.alias("act_sales"))
            .group_by(c("ss_customer_sk"))
            .agg((ns["sum_"](c("act_sales")), "sumsales"))
            .order_by(c("sumsales"), c("ss_customer_sk"))
            .limit(100))


JAX = {"col": jcol, "lit": jlit, "sum_": jsum, "CaseWhen": JP.CaseWhen}
PORT = {"col": col, "lit": lit, "sum_": sum_, "CaseWhen": CaseWhen}


def _unmatched_counts(ns, session, ss_paths, sr_path, count):
    """Rows of the outer join by whether a return matched (IsNull of
    the NULL-extended side)."""
    c = ns["col"]
    ss = session.read_parquet(*ss_paths)
    sr = session.read_parquet(sr_path)
    return (ss.join(sr, left_on=[c("ss_item_sk"), c("ss_ticket_number")],
                    right_on=[c("sr_item_sk"), c("sr_ticket_number")],
                    how="left_outer")
            .select(c("sr_return_quantity").is_null().alias("unmatched"))
            .group_by(c("unmatched"))
            .agg((count(), "n")))


@pytest.fixture(scope="module")
def jax_side(data):
    """Both JAX engines' q93 and no-reason results, the SQL frontend's
    q93, the JAX plan, and the outer join's matched / unmatched
    counts."""
    conf = get_conf()
    saved = dict(conf._values)
    for k, v in CONF.items():
        conf.set(k, v)
    set_conf(conf)
    try:
        session = TpuSession(conf)
        df = _q93(JAX, session, *data)
        out = {"root": plan_query(df._plan, conf)[0]}
        for engine in ("tpu", "cpu"):
            out[engine] = df.collect(engine=engine)
            out[f"no_reason_{engine}"] = _q93(
                JAX, session, *data, with_reason=False).collect(
                    engine=engine)
            out[f"unmatched_{engine}"] = _unmatched_counts(
                JAX, session, data[0], data[1], jcount_star).collect(
                    engine=engine)
        sql = build_session(SCALE, SEED).sql(QUERIES[93]).collect()
        out["sql"] = sql.rename_columns(NAMES)
        return out
    finally:
        conf._values.clear()
        conf._values.update(saved)
        set_conf(conf)


@pytest.fixture
def port_session():
    return TorchSession(CONF, device="cpu")


@pytest.mark.parametrize("engine", ["tpu", "cpu", "sql"])
def test_q93_matches_the_jax_engines_and_sql(engine, data, jax_side,
                                             port_session):
    got = tpcds.q93_dataframe(port_session, *data).collect()
    assert got.schema.names == NAMES
    assert got.num_rows == 100
    assert_tables_equal(got, jax_side[engine], ignore_order=False,
                        approx_float=True)


@pytest.mark.parametrize("engine", ["tpu", "cpu"])
def test_q93_without_the_reason_join_matches_both_jax_engines(
        engine, data, jax_side, port_session):
    got = _q93(PORT, port_session, *data, with_reason=False).collect()
    assert got.num_rows == 100
    assert_tables_equal(got, jax_side[f"no_reason_{engine}"],
                        ignore_order=False, approx_float=True)


@pytest.mark.parametrize("engine", ["tpu", "cpu"])
def test_outer_join_keeps_the_unmatched_sales(engine, data, jax_side,
                                              port_session, catalog):
    got = _unmatched_counts(PORT, port_session, data[0], data[1],
                            count_star).collect()
    want = jax_side[f"unmatched_{engine}"]
    assert_tables_equal(got, want)
    n = dict(zip(got.column("unmatched").to_pylist(),
                 got.column("n").to_pylist()))
    # a matched row per (sale, return) pair; every other sale once,
    # NULL-extended
    ss, sr = catalog["store_sales"], catalog["store_returns"]
    keys = ["ss_item_sk", "ss_ticket_number"]
    rkeys = ["sr_item_sk", "sr_ticket_number"]
    assert n[False] == ss.join(sr, keys, rkeys, join_type="inner").num_rows
    assert n[True] == ss.join(sr, keys, rkeys,
                              join_type="left anti").num_rows
    assert n[False] >= sr.num_rows and n[True] > 0


def test_the_plan_is_a_partition_wise_outer_join_under_a_broadcast(
        data, jax_side, port_session):
    plan = tpcds.q93_dataframe(port_session, *data).physical_plan()
    assert isinstance(plan, TpuTopNExec) and plan.n == 100
    final = plan.children[0]
    assert isinstance(final, TpuHashAggregateExec) and final.mode == "final"
    ex = final.children[0]
    assert isinstance(ex, TpuShuffleExchangeExec)
    assert [e.dtype.name for e in ex.partitioning.exprs] == ["bigint"]
    joins = [n for n in plan.walk() if hasattr(n, "build_is_right")]
    assert [(type(j), j.join_type, j.build_is_right) for j in joins] == [
        (TpuBroadcastHashJoinExec, "inner", True),
        (TpuShuffledHashJoinExec, "left_outer", True)]
    reason_join, outer = joins
    # the reason join probes the outer join's output, not a scan
    assert reason_join.children[0] is outer
    assert outer.partition_wise
    for side in outer.children:
        assert isinstance(side, TpuShuffleExchangeExec)
        assert [e.dtype.name for e in side.partitioning.exprs] == [
            "bigint", "bigint"]
    # no runtime filter: the outer join is not eligible, and the reason
    # join's probe side is a join, which the filter does not pass
    assert not any(isinstance(n, TpuRuntimeFilterBuildExec)
                   for n in plan.walk())
    assert RF.plan_runtime_filters(plan) == []
    assert not any(n.runtime_filters for n in plan.walk()
                   if isinstance(n, ParquetScanExec))
    assert not [n for n in jax_side["root"]._walk()
                if isinstance(n, JRFBuild)]


def _map_batches(plan):
    """Non-empty batches each hash exchange's child makes (each drained
    on its own)."""
    n = 0
    for ex in plan.walk():
        if isinstance(ex, TpuShuffleExchangeExec):
            child = ex.children[0]
            n += sum(1 for p in range(child.num_partitions)
                     for b in child.execute_partition(p) if b.num_rows)
    return n


def test_k1_hashes_each_map_batch_of_the_three_exchanges_once(
        data, port_session, monkeypatch):
    planned = _map_batches(tpcds.q93_dataframe(port_session, *data)
                           .physical_plan())
    # 3 store_sales tasks, 1 store_returns batch, the partial aggregates
    assert N_FILES + 1 < planned <= N_FILES + 1 + 8
    calls = []
    real = kernels.hash_columns

    def spy(cols, num_rows, device, seed=42, num_partitions=0):
        calls.append(([c.dtype.name for c in cols], num_partitions))
        return real(cols, num_rows, device, seed, num_partitions)

    monkeypatch.setattr(kernels, "hash_columns", spy)
    tpcds.q93_dataframe(port_session, *data).collect()
    assert len(calls) == planned
    assert all(parts == 8 for _, parts in calls)
    kinds = [tuple(c) for c, _ in calls]
    assert kinds.count(("bigint", "bigint")) == N_FILES + 1
    assert kinds.count(("bigint",)) == planned - N_FILES - 1


# --------------------------------------------------------------------- #
# The partition-wise left outer join's edge cases
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def edge_files(tmp_path_factory):
    """A stream side in two files and a build side whose keys hash into
    few of the 8 partitions: stream rows matching two build rows, rows
    matching none, NULL keys on both sides."""
    d = tmp_path_factory.mktemp("outer_edges")
    rng = np.random.default_rng(93)
    n = 400
    item = rng.integers(1, 6, n)
    ticket = rng.integers(1, 30, n)
    stream = pa.table({
        "s_item": pa.array(item, pa.int64(), mask=rng.random(n) < 0.05),
        "s_ticket": pa.array(ticket, pa.int64(), mask=rng.random(n) < 0.05),
        "s_v": pa.array(rng.integers(-50, 50, n), pa.int64()),
    })
    # three distinct keys, one of them twice, and a NULL-keyed row
    build = pa.table({
        "b_item": pa.array([int(item[0]), int(item[0]), int(item[1]),
                            int(item[2]), None], pa.int64()),
        "b_ticket": pa.array([int(ticket[0]), int(ticket[0]),
                              int(ticket[1]), int(ticket[2]), 7],
                             pa.int64()),
        "b_q": pa.array([1, 2, 3, 4, 5], pa.int64()),
    })
    paths = []
    for i, part in enumerate((stream.slice(0, 250), stream.slice(250))):
        p = str(d / f"stream-{i}.parquet")
        pq.write_table(part, p)
        paths.append(p)
    bp = str(d / "build.parquet")
    pq.write_table(build, bp)
    return paths, bp


def _outer_edges(c, session, files):
    stream_paths, build_path = files
    return session.read_parquet(*stream_paths).join(
        session.read_parquet(build_path),
        left_on=[c("s_item"), c("s_ticket")],
        right_on=[c("b_item"), c("b_ticket")], how="left_outer")


@pytest.mark.parametrize("chunk", [1 << 22, 7])
def test_partition_wise_left_outer_join_edges(chunk, edge_files):
    conf = {TTB: 1, BCAST: -1, CHUNK: chunk}
    port = TorchSession(conf, device="cpu")
    plan = _outer_edges(col, port, edge_files).physical_plan()
    [join] = [n for n in plan.walk() if hasattr(n, "build_is_right")]
    assert isinstance(join, TpuShuffledHashJoinExec) and join.partition_wise
    assert join.build_is_right
    # some partitions have no build row at all
    build_ex = join.children[1]
    sizes = [sum(b.num_rows for b in build_ex.execute_partition(p))
             for p in range(build_ex.num_partitions)]
    assert sum(sizes) == 5 and sizes.count(0) >= 4
    batches = list(plan.execute())
    if chunk == 7:
        assert max(b.num_rows for b in batches) <= 7
    got = _outer_edges(col, port, edge_files).collect()
    stream = pa.concat_tables([pq.read_table(p) for p in edge_files[0]])
    build = pq.read_table(edge_files[1])
    want_rows = stream.join(build, ["s_item", "s_ticket"],
                            ["b_item", "b_ticket"],
                            join_type="left outer").num_rows
    unmatched = pc.sum(pc.is_null(got["b_q"])).as_py()
    # stream rows matching two build rows give two rows each
    assert got.num_rows == want_rows > stream.num_rows
    assert 0 < unmatched < stream.num_rows

    jconf = get_conf()
    saved = dict(jconf._values)
    for k, v in conf.items():
        jconf.set(k, v)
    set_conf(jconf)
    try:
        jdf = _outer_edges(jcol, TpuSession(jconf), edge_files)
        for engine in ("tpu", "cpu"):
            assert_tables_equal(got, jdf.collect(engine=engine))
    finally:
        jconf._values.clear()
        jconf._values.update(saved)
        set_conf(jconf)


# --------------------------------------------------------------------- #
# The generators
# --------------------------------------------------------------------- #


def test_make_reason_copies_the_mini_catalog():
    assert tpcds.make_reason(10).equals(tpcds_schema._reason(10))
    assert tpcds.make_reason().column("r_reason_desc")[8].as_py() == \
        tpcds.Q93_REASON


class _Recording:
    """A Generator that records its state just before the draw that
    starts the catalog's store_returns (``ridx``)."""

    def __init__(self, rng, signature):
        self._rng = rng
        self._signature = signature
        self.state = None

    def integers(self, *args, **kwargs):
        if args == self._signature and self.state is None:
            self.state = self._rng.bit_generator.state
        return self._rng.integers(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._rng, name)


def test_store_returns_table_copies_the_mini_catalog(monkeypatch):
    rows = {k: max(4, int(v * SCALE)) for k, v in tpcds_schema.ROWS.items()}
    real = np.random.default_rng
    made = []

    def recording(seed=None):
        made.append(_Recording(real(seed), (0, rows["store_sales"],
                                            rows["store_returns"])))
        return made[-1]

    monkeypatch.setattr(np.random, "default_rng", recording)
    catalog = tpcds_schema.generate(SCALE, seed=SEED)
    monkeypatch.undo()
    [rec] = made
    assert rec.state is not None
    rng = np.random.Generator(np.random.PCG64())
    rng.bit_generator.state = rec.state
    got = tpcds.store_returns_table(rng, catalog["store_sales"],
                                    rows["store_returns"], rows)
    want = catalog["store_returns"]
    assert got.schema.equals(want.schema)
    assert got.equals(want)


def test_store_returns_name_their_sales(tmp_path):
    rows = {**tpcds.SF1_ROWS, "reason": 10}
    paths = tpcds.make_catalog_store_sales(str(tmp_path), 2, 5000)
    sr_path, reason_path = tpcds.write_q93_tables(str(tmp_path), paths)
    meta = pq.read_metadata(sr_path)
    assert meta.num_row_groups == 1
    assert meta.num_rows == round(10000 * 287_514 / 2_880_404)
    assert pq.read_table(reason_path).equals(tpcds_schema._reason(10))
    sr = pq.read_table(sr_path)
    ss = pa.concat_tables([pq.read_table(p) for p in paths])
    assert sr.schema.equals(tpcds_schema.generate(SCALE, seed=SEED)[
        "store_returns"].schema)
    sales = {(r["ss_item_sk"], r["ss_ticket_number"]):
             (r["ss_customer_sk"], r["ss_store_sk"])
             for r in ss.select(["ss_item_sk", "ss_ticket_number",
                                 "ss_customer_sk", "ss_store_sk"])
             .to_pylist()}
    for r in sr.select(["sr_item_sk", "sr_ticket_number", "sr_customer_sk",
                        "sr_store_sk"]).to_pylist():
        assert sales[(r["sr_item_sk"], r["sr_ticket_number"])] == (
            r["sr_customer_sk"], r["sr_store_sk"])
    reason = sr.column("sr_reason_sk").to_numpy()
    assert reason.min() == 1 and reason.max() == 10
    qty = sr.column("sr_return_quantity").to_numpy()
    assert qty.min() >= 1 and qty.max() <= 19
    days = sr.column("sr_returned_date_sk").to_numpy()
    assert days.min() >= tpcds.DATE_SK_EPOCH
    assert days.max() < tpcds.DATE_SK_EPOCH + 365 * 5
    t = sr.column("sr_return_time_sk").to_numpy()
    assert t.min() >= 0 and t.max() < 86400
    for name, dim in (("sr_cdemo_sk", "customer_demographics"),
                      ("sr_hdemo_sk", "household_demographics"),
                      ("sr_addr_sk", "customer_address")):
        v = sr.column(name).to_numpy()
        assert v.min() >= 1 and v.max() <= rows[dim]
    assert sr.column("sr_customer_sk").null_count > 0
