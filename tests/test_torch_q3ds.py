"""TPC-DS q3 (a star join) end to end: the port on the CPU against both
JAX engines and the JAX SQL frontend, on the JAX package's mini
catalog; the plans both engines make for it; what its runtime filter
lets through; and the port's copies of the catalog's generators.

The catalog is ``tpcds_schema.generate(0.5, seed=7)``, the smallest
scale at which q3 has at least 10 rows.  store_sales is split into 3
files and ``scan.taskTargetBytes`` = 1 makes each its own scan task.
The JAX engines read the process-global conf, which goes through
``set_conf`` and is restored afterwards.
"""

import datetime

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.config import get_conf, set_conf
from spark_rapids_tpu.execs.join import (
    TpuBroadcastHashJoinExec as JBroadcast,
)
from spark_rapids_tpu.execs.join import (
    TpuRuntimeFilterBuildExec as JRFBuild,
)
from spark_rapids_tpu.execs.sort import SortKey as JSortKey
from spark_rapids_tpu.exprs.base import lit as jlit
from spark_rapids_tpu.plan import runtime_filter as JRF
from spark_rapids_tpu.plan.planner import plan_query
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import sum_ as jsum
from spark_rapids_tpu.tools import tpcds_schema
from spark_rapids_tpu.tools.sweep import build_session
from spark_rapids_tpu.tools.tpcds_queries import QUERIES

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession, tpcds
from spark_rapids_tpu_torch.execs.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
from spark_rapids_tpu_torch.execs.join import (
    TpuBroadcastHashJoinExec,
    TpuRuntimeFilterBuildExec,
)
from spark_rapids_tpu_torch.execs.sort import TpuTopNExec
from spark_rapids_tpu_torch.io.scan import ParquetScanExec
from spark_rapids_tpu_torch.ops import kernels
from spark_rapids_tpu_torch.plan import runtime_filter as RF

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
RF_ON = "spark.rapids.tpu.sql.runtimeFilter.enabled"
SCALE, SEED, N_FILES = 0.5, 7, 3
NAMES = ["d_year", "i_brand_id", "i_brand", "sum_agg"]


@pytest.fixture(scope="module")
def catalog():
    return tpcds_schema.generate(SCALE, seed=SEED)


@pytest.fixture(scope="module")
def data(tmp_path_factory, catalog):
    d = tmp_path_factory.mktemp("q3ds")
    dd, item = str(d / "date_dim.parquet"), str(d / "item.parquet")
    pq.write_table(catalog["date_dim"], dd)
    pq.write_table(catalog["item"], item)
    ss = catalog["store_sales"]
    per = -(-ss.num_rows // N_FILES)
    paths = []
    for i in range(N_FILES):
        p = str(d / f"store_sales-{i}.parquet")
        pq.write_table(ss.slice(i * per, per), p)
        paths.append(p)
    return dd, paths, item


def _jax_q3(session, dd, ss_paths, item):
    """The port's q3 DataFrame, written against the JAX session."""
    dt = (session.read_parquet(dd).where(jcol("d_moy").eq(jlit(11)))
          .select(jcol("d_date_sk"), jcol("d_year")))
    ss = session.read_parquet(*ss_paths)
    it = (session.read_parquet(item)
          .where(jcol("i_manufact_id").eq(jlit(128)))
          .select(jcol("i_item_sk"), jcol("i_brand_id"), jcol("i_brand")))
    return (dt.join(ss, left_on=[jcol("d_date_sk")],
                    right_on=[jcol("ss_sold_date_sk")])
            .join(it, left_on=[jcol("ss_item_sk")],
                  right_on=[jcol("i_item_sk")])
            .group_by(jcol("d_year"), jcol("i_brand_id"), jcol("i_brand"))
            .agg((jsum(jcol("ss_ext_sales_price")), "sum_agg"))
            .order_by(JSortKey(jcol("d_year")),
                      JSortKey(jcol("sum_agg"), True, True),
                      JSortKey(jcol("i_brand_id")))
            .limit(100))


@pytest.fixture(scope="module")
def jax_side(data):
    """Both JAX engines' results, the SQL frontend's, the JAX plan and
    its runtime-filter counts."""
    conf = get_conf()
    saved = dict(conf._values)
    conf.set(TTB, 1)
    set_conf(conf)
    try:
        df = _jax_q3(TpuSession(conf), *data)
        root, _meta = plan_query(df._plan, conf)
        JRF.reset_stats()
        out = {"tpu": df.collect(engine="tpu")}
        out["rf"] = JRF.stats()
        out["cpu"] = df.collect(engine="cpu")
        out["root"] = root
        sql = build_session(SCALE, SEED).sql(QUERIES[3]).collect()
        out["sql"] = sql.rename_columns(NAMES)
        return out
    finally:
        conf._values.clear()
        conf._values.update(saved)
        set_conf(conf)
        JRF.reset_stats()


@pytest.fixture
def port_session():
    return TorchSession({TTB: 1}, device="cpu")


@pytest.mark.parametrize("engine", ["tpu", "cpu", "sql"])
def test_q3_matches_the_jax_engines_and_sql(engine, data, jax_side,
                                            port_session):
    got = tpcds.q3_dataframe(port_session, *data).collect()
    assert got.schema.names == NAMES
    assert got.num_rows >= 10
    want = jax_side[engine]
    assert got.select(NAMES[:3]).equals(want.select(NAMES[:3]))
    assert_tables_equal(got, want, ignore_order=False, approx_float=True)


def _joins(root, cls, walk):
    return [n for n in walk(root) if isinstance(n, cls)]


def test_both_engines_plan_two_broadcasts_and_one_filter(data, jax_side,
                                                         port_session):
    plan = tpcds.q3_dataframe(port_session, *data).physical_plan()
    # top-n <- final aggregate <- K1 hash exchange <- partial aggregate
    assert isinstance(plan, TpuTopNExec) and plan.n == 100
    final = plan.children[0]
    assert isinstance(final, TpuHashAggregateExec) and final.mode == "final"
    ex = final.children[0]
    assert isinstance(ex, TpuShuffleExchangeExec)
    assert [e.dtype.name for e in ex.partitioning.exprs] == [
        "bigint", "bigint", "string"]
    partial = ex.children[0]
    assert partial.mode == "partial"
    item_join = partial.children[0]
    date_join = item_join.children[0]
    assert isinstance(item_join, TpuBroadcastHashJoinExec)
    assert isinstance(date_join, TpuBroadcastHashJoinExec)
    port_sides = [date_join.build_is_right, item_join.build_is_right]
    assert port_sides == [False, True]  # date_dim left, item right
    jax_joins = _joins(jax_side["root"], JBroadcast, lambda r: r._walk())
    assert sorted(j.build_is_right for j in jax_joins) == sorted(port_sides)
    # one filter, built from date_dim's keys, on the store_sales scan
    [build] = [n for n in plan.walk()
               if isinstance(n, TpuRuntimeFilterBuildExec)]
    assert date_join.children[0] is build
    [(key, rf)] = build.entries
    assert key.name == "d_date_sk" and rf.key_name == "ss_sold_date_sk"
    scans = [n for n in plan.walk()
             if isinstance(n, ParquetScanExec) and n.runtime_filters]
    assert len(scans) == 1 and scans[0].paths == data[1]
    jax_builds = _joins(jax_side["root"], JRFBuild, lambda r: r._walk())
    assert [rf.key_name for b in jax_builds for _k, rf in b.entries] == [
        "ss_sold_date_sk"]
    assert (rf.n_bits, rf.n_hashes) == (jax_builds[0].entries[0][1].n_bits,
                                        jax_builds[0].entries[0][1].n_hashes)


def test_store_sales_scan_lets_through_what_the_jax_scan_does(
        data, jax_side, port_session, monkeypatch):
    plan = tpcds.q3_dataframe(port_session, *data).physical_plan()
    calls = []
    real = kernels.hash_columns

    def spy(cols, num_rows, device, seed=42, num_partitions=0):
        calls.append((num_rows, seed, num_partitions))
        return real(cols, num_rows, device, seed, num_partitions)

    monkeypatch.setattr(kernels, "hash_columns", spy)
    list(plan.execute())
    [scan] = [n for n in plan.walk()
              if isinstance(n, ParquetScanExec) and n.runtime_filters]
    total = sum(pq.read_metadata(p).num_rows for p in data[1])
    jrf = jax_side["rf"]
    assert jrf["filters_built"] == 1 and jrf["pruned_rows"] > 0
    assert scan.metrics["rfPrunedRows"] == jrf["pruned_rows"]
    assert scan.metrics["rfRowGroupsPruned"] == jrf["row_groups_pruned"]
    assert scan.metrics["numOutputRows"] == total - jrf["pruned_rows"]
    [rf] = RF.plan_runtime_filters(plan)
    assert rf.n_keys == jrf["build_rows"] > 0
    # K1: the filter's two seeded lanes over the one date_dim batch, the
    # same two over its key range for the range table, then one launch
    # per map batch of the aggregate's exchange
    lanes = [c for c in calls if c[2] == 0]
    assert [c[1] for c in lanes] == [RF.BLOOM_SEED1, RF.BLOOM_SEED2] * 2
    span = rf.max_val - rf.min_val + 1
    assert [c[0] for c in lanes] == [rf.n_keys] * 2 + [span] * 2
    assert len(rf.range_table) == span + 2
    assert len([c for c in calls if c[2] == 8]) == N_FILES


def test_q3_without_the_filter_gives_the_same_rows(data, port_session):
    off = TorchSession({TTB: 1, RF_ON: False}, device="cpu")
    plan = tpcds.q3_dataframe(off, *data).physical_plan()
    assert not any(isinstance(n, TpuRuntimeFilterBuildExec)
                   for n in plan.walk())
    assert_tables_equal(tpcds.q3_dataframe(off, *data).collect(),
                        tpcds.q3_dataframe(port_session, *data).collect(),
                        ignore_order=False, approx_float=True)


# --------------------------------------------------------------------- #
# The generators
# --------------------------------------------------------------------- #


def test_make_date_dim_copies_the_mini_catalog():
    got = tpcds.make_date_dim(datetime.date(1998, 1, 1),
                              datetime.date(2003, 12, 31))
    assert got.equals(tpcds_schema._date_dim())


def test_whole_calendar_keys_are_julian_day_numbers():
    t = tpcds.make_date_dim()
    assert t.num_rows == 73049
    sk = t.column("d_date_sk").to_numpy()
    days = t.column("d_date").cast(pa.int32()).to_numpy()
    # 1970-01-01 is Julian day 2440588
    np.testing.assert_array_equal(sk, days.astype(np.int64) + 2440588)
    assert t.column("d_date")[0].as_py() == datetime.date(1900, 1, 2)
    assert t.column("d_date")[-1].as_py() == datetime.date(2100, 1, 1)
    nov = int(np.sum(t.column("d_moy").to_numpy() == 11))
    assert nov == 200 * 30


@pytest.mark.parametrize("seed,n", [(0, 1000), (7, 18000)])
def test_make_item_copies_the_mini_catalog(seed, n):
    got = tpcds.make_item(np.random.default_rng(seed), n)
    want = tpcds_schema._item(np.random.default_rng(seed), n)
    assert got.equals(want)


def test_store_sales_has_the_catalog_schema_and_ranges(catalog, tmp_path):
    rows = {k: max(4, int(v * SCALE)) for k, v in tpcds_schema.ROWS.items()}
    rng = np.random.default_rng(1)
    got = tpcds.store_sales_table(rng, 20000, 0, rows)
    want = catalog["store_sales"]
    assert got.schema.equals(want.schema)
    for name in ("ss_item_sk", "ss_customer_sk", "ss_cdemo_sk",
                 "ss_hdemo_sk", "ss_addr_sk", "ss_store_sk", "ss_promo_sk",
                 "ss_sold_date_sk", "ss_quantity"):
        g = got.column(name).to_numpy(zero_copy_only=False)
        w = want.column(name).to_numpy(zero_copy_only=False)
        g, w = g[~np.isnan(g.astype(float))], w[~np.isnan(w.astype(float))]
        assert w.min() <= g.min() and g.max() <= w.max(), name
        assert g.max() - g.min() >= 0.9 * (w.max() - w.min()), name
    nulls = got.column("ss_sold_date_sk").null_count / got.num_rows
    assert 0.01 < nulls < 0.03
    paths = tpcds.make_catalog_store_sales(str(tmp_path), 2, 1000, rows=rows)
    meta = [pq.read_metadata(p) for p in paths]
    assert [m.num_rows for m in meta] == [1000, 1000]
    assert all(m.num_row_groups == 1 for m in meta)
    tickets = pq.read_table(paths[1]).column("ss_ticket_number").to_numpy()
    assert tickets[0] == 1000 // 4 + 1


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
