"""TPC-DS q42, q52 and q55 (the star join of date_dim, store_sales and
item under other filters, group keys and orders) end to end: the port
on the CPU against both JAX engines and the JAX SQL frontend's run of
each query text on the JAX package's mini catalog, and against both
JAX engines on the port's own generated tables (the whole calendar,
18 000 items and 3 store_sales files), where each query has more
groups; the plans (two broadcasts, one runtime filter on the
store_sales scan, the aggregate's exchange keyed by the group keys,
STRING ones included); and K1's launches.

The catalog is ``tpcds_schema.generate(1.0, seed=7)``, the largest
scale it generates (it has five ship modes and ten reasons); there the
queries have 2-5 rows.  store_sales is split into 3 files and
``scan.taskTargetBytes`` = 1 makes each its own scan task.  Float sums
compare with ``approx_float`` (9 decimals); everything else exactly.
"""

import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.config import get_conf, set_conf
from spark_rapids_tpu.execs.sort import SortKey as JSortKey
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import lit as jlit
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
SCALE, SEED, N_FILES = 1.0, 7, 3

#: query -> (port DataFrame, output names, (year, manager), item columns,
#: the aggregate exchange's key types)
QUERY = {
    42: (tpcds.q42_dataframe, ["d_year", "i_category_id", "i_category",
                               "sum_agg"], (2000, 1),
         ["i_category_id", "i_category"], ["bigint", "bigint", "string"]),
    52: (tpcds.q52_dataframe, ["d_year", "brand_id", "brand", "ext_price"],
         (2000, 1), ["i_brand_id", "i_brand"],
         ["bigint", "string", "bigint"]),
    55: (tpcds.q55_dataframe, ["brand_id", "brand", "ext_price"],
         (1999, 28), ["i_brand_id", "i_brand"], ["string", "bigint"]),
}


def _jax_star(q, session, dd, ss_paths, item):
    """The port's q42 / q52 / q55 DataFrame, against the JAX session."""
    (year, manager), item_cols = QUERY[q][2], QUERY[q][3]
    dt = (session.read_parquet(dd)
          .where(jcol("d_moy").eq(jlit(11)) & jcol("d_year").eq(jlit(year)))
          .select(jcol("d_date_sk"), jcol("d_year")))
    it = (session.read_parquet(item)
          .where(jcol("i_manager_id").eq(jlit(manager)))
          .select(jcol("i_item_sk"), *[jcol(c) for c in item_cols]))
    j = (dt.join(session.read_parquet(*ss_paths),
                 left_on=[jcol("d_date_sk")],
                 right_on=[jcol("ss_sold_date_sk")])
         .join(it, left_on=[jcol("ss_item_sk")],
               right_on=[jcol("i_item_sk")]))
    sales = jsum(jcol("ss_ext_sales_price"))
    if q == 42:
        return (j.group_by(jcol("d_year"), jcol("i_category_id"),
                           jcol("i_category"))
                .agg((sales, "sum_agg"))
                .order_by(JSortKey(jcol("sum_agg"), True, True),
                          JSortKey(jcol("d_year")),
                          JSortKey(jcol("i_category_id")),
                          JSortKey(jcol("i_category")))
                .limit(100))
    keys = [jcol("i_brand"), jcol("i_brand_id")]
    out = [jcol("i_brand_id").alias("brand_id"),
           jcol("i_brand").alias("brand"), jcol("ext_price")]
    order = [JSortKey(jcol("ext_price"), True, True),
             JSortKey(jcol("brand_id"))]
    if q == 52:
        keys, out = [jcol("d_year"), *keys], [jcol("d_year"), *out]
        order = [JSortKey(jcol("d_year")), *order]
    return (j.group_by(*keys).agg((sales, "ext_price")).select(*out)
            .order_by(*order).limit(100))


def _write(d, date_dim, item, store_sales):
    dd, it = str(d / "date_dim.parquet"), str(d / "item.parquet")
    pq.write_table(date_dim, dd)
    pq.write_table(item, it)
    per = -(-store_sales.num_rows // N_FILES)
    paths = []
    for i in range(N_FILES):
        p = str(d / f"store_sales-{i}.parquet")
        pq.write_table(store_sales.slice(i * per, per), p)
        paths.append(p)
    return dd, paths, it


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """name -> (date_dim path, store_sales paths, item path)."""
    cat = tpcds_schema.generate(SCALE, seed=SEED)
    out = {"catalog": _write(tmp_path_factory.mktemp("star_catalog"),
                             cat["date_dim"], cat["item"],
                             cat["store_sales"])}
    d = tmp_path_factory.mktemp("star_generated")
    dd, ss, item = tpcds.write_q3_tables(str(d), n_files=N_FILES,
                                         rows_per_file=20_000)
    out["generated"] = (dd, ss, item)
    return out


@pytest.fixture(scope="module")
def jax_side(datasets):
    """(dataset, query, engine) -> the JAX result; engine "sql" is the
    SQL frontend's run of the query text on the catalog."""
    conf = get_conf()
    saved = dict(conf._values)
    conf.set(TTB, 1)
    set_conf(conf)
    out = {}
    try:
        session = TpuSession(conf)
        for name, data in datasets.items():
            for q in QUERY:
                df = _jax_star(q, session, *data)
                for engine in ("tpu", "cpu"):
                    out[name, q, engine] = df.collect(engine=engine)
        fe = build_session(SCALE, SEED)
        for q, spec in QUERY.items():
            out["catalog", q, "sql"] = fe.sql(QUERIES[q]).collect() \
                .rename_columns(spec[1])
        return out
    finally:
        conf._values.clear()
        conf._values.update(saved)
        set_conf(conf)


@pytest.fixture
def port_session():
    return TorchSession({TTB: 1}, device="cpu")


CASES = [(d, q, e) for q in QUERY for d, e in (
    ("catalog", "tpu"), ("catalog", "cpu"), ("catalog", "sql"),
    ("generated", "tpu"), ("generated", "cpu"))]


@pytest.mark.parametrize("dataset,q,engine", CASES)
def test_star_query_matches_jax(dataset, q, engine, datasets, jax_side,
                                port_session):
    make, names = QUERY[q][:2]
    got = make(port_session, *datasets[dataset]).collect()
    assert got.schema.names == names
    assert got.num_rows >= (2 if dataset == "catalog" else 8)
    assert_tables_equal(got, jax_side[dataset, q, engine],
                        ignore_order=False, approx_float=True)


@pytest.mark.parametrize("q", list(QUERY))
def test_plan_two_broadcasts_a_filter_and_the_key_types(q, datasets,
                                                        port_session):
    make, _, _, _, key_types = QUERY[q]
    dd, ss_paths, item = datasets["catalog"]
    plan = make(port_session, dd, ss_paths, item).physical_plan()
    assert isinstance(plan, TpuTopNExec) and plan.n == 100
    [ex] = [n for n in plan.walk() if isinstance(n, TpuShuffleExchangeExec)]
    assert [e.dtype.name for e in ex.partitioning.exprs] == key_types
    assert isinstance(ex.children[0], TpuHashAggregateExec)
    joins = [n for n in plan.walk() if hasattr(n, "build_is_right")]
    assert all(isinstance(j, TpuBroadcastHashJoinExec) for j in joins)
    assert [j.build_is_right for j in joins] == [True, False]
    [build] = [n for n in plan.walk()
               if isinstance(n, TpuRuntimeFilterBuildExec)]
    [(key, rf)] = build.entries
    assert key.name == "d_date_sk" and rf.key_name == "ss_sold_date_sk"
    [scan] = [n for n in plan.walk()
              if isinstance(n, ParquetScanExec) and n.runtime_filters]
    assert scan.paths == ss_paths


@pytest.mark.parametrize("q", list(QUERY))
def test_k1_launches(q, datasets, port_session, monkeypatch):
    make = QUERY[q][0]
    calls = []
    real = kernels.hash_columns

    def spy(cols, num_rows, device, seed=42, num_partitions=0):
        calls.append((num_rows, seed, num_partitions))
        return real(cols, num_rows, device, seed, num_partitions)

    monkeypatch.setattr(kernels, "hash_columns", spy)
    plan = make(port_session, *datasets["generated"]).physical_plan()
    list(plan.execute())
    [rf] = RF.plan_runtime_filters(plan)
    # the filter's two lanes over the 30 November keys of one year, the
    # same two over their range (a range table), then one launch per
    # map batch of the aggregate's exchange
    assert rf.n_keys == 30 and rf.max_val - rf.min_val == 29
    lanes = [c for c in calls if c[2] == 0]
    assert [c[1] for c in lanes] == [RF.BLOOM_SEED1, RF.BLOOM_SEED2] * 2
    assert [c[0] for c in lanes] == [30] * 4
    assert len([c for c in calls if c[2] == 8]) == N_FILES
    assert len(calls) == len(lanes) + N_FILES
