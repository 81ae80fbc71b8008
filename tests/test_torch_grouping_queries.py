"""TPC-DS q67 as written, q5 and q27 end to end: the port on the CPU
against both JAX engines and the JAX SQL frontend's run of
``QUERIES[n]``, on the JAX package's mini catalog; the plans both
engines make; and the port's copies of the catalog's store and
customer_demographics generators.

The catalog is ``tpcds_schema.generate(0.5, seed=7)``, q3's.
store_sales is split into 3 files and ``scan.taskTargetBytes`` = 1
makes each its own scan task; 2 shuffle partitions keep the JAX
engine's compiles few.  q27's text asks for stores in Tennessee,
and the catalog's stores lie in the first eight of its states, so the
text gives no row (``SWEEP_r01.json`` has it at 0 rows too); the
variant asks for the first store's state and gives rows.  The JAX
engines read the process-global conf, which goes through ``set_conf``
and is restored afterwards.
"""

import types

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.config import get_conf, set_conf
from spark_rapids_tpu.execs.join import (
    TpuBroadcastHashJoinExec as JBroadcast,
)
from spark_rapids_tpu.execs.join import (
    TpuRuntimeFilterBuildExec as JRFBuild,
)
from spark_rapids_tpu.execs.sort import SortKey as JSortKey
from spark_rapids_tpu.exprs.base import Literal as JLiteral
from spark_rapids_tpu.exprs.predicates import Coalesce as JCoalesce
from spark_rapids_tpu.exprs.predicates import In as JIn
from spark_rapids_tpu.exprs.window import Window as JWindow
from spark_rapids_tpu.exprs.window import rank as jrank
from spark_rapids_tpu.plan.planner import plan_query
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import avg as javg
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import lit as jlit
from spark_rapids_tpu.session import sum_ as jsum
from spark_rapids_tpu.tools import tpcds_schema
from spark_rapids_tpu.tools.sweep import build_session
from spark_rapids_tpu.tools.tpcds_queries import QUERIES

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession, tpcds
from spark_rapids_tpu_torch.execs.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.execs.basic import TpuUnionExec
from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
from spark_rapids_tpu_torch.execs.expand import TpuExpandExec
from spark_rapids_tpu_torch.execs.join import TpuBroadcastHashJoinExec
from spark_rapids_tpu_torch.execs.window import TpuWindowExec
from spark_rapids_tpu_torch.ops import kernels
from spark_rapids_tpu_torch.ops.partition import HashPartitioning
from spark_rapids_tpu_torch.plan import runtime_filter as RF

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
PARTS = "spark.rapids.tpu.sql.shuffle.partitions"
SCALE, SEED, N_FILES = 0.5, 7, 3


def _significant(table: pa.Table, digits: int = 12) -> pa.Table:
    """Float columns rounded to ``digits`` significant digits: the
    engines sum in other orders, which moves a sum by an ulp or two."""
    cols = []
    for c in table.columns:
        if pa.types.is_floating(c.type):
            c = pa.array([None if v is None else float(f"{v:.{digits - 1}e}")
                          for v in c.to_pylist()], c.type)
        cols.append(c)
    return pa.Table.from_arrays(cols, names=table.schema.names)


@pytest.fixture(scope="module")
def catalog():
    return tpcds_schema.generate(SCALE, seed=SEED)


@pytest.fixture(scope="module")
def paths(tmp_path_factory, catalog):
    d = tmp_path_factory.mktemp("grouping_queries")
    out = {}
    for name in ("date_dim", "item", "store", "customer_demographics",
                 "store_returns"):
        out[name] = str(d / f"{name}.parquet")
        pq.write_table(catalog[name], out[name])
    ss = catalog["store_sales"]
    per = -(-ss.num_rows // N_FILES)
    out["store_sales"] = []
    for i in range(N_FILES):
        p = str(d / f"store_sales-{i}.parquet")
        pq.write_table(ss.slice(i * per, per), p)
        out["store_sales"].append(p)
    return out


#: the JAX package's DataFrame API, for the builders below
JAX = types.SimpleNamespace(
    col=jcol, lit=jlit, sum_=jsum, avg=javg, Coalesce=JCoalesce, In=JIn,
    Window=JWindow, rank=jrank, SortKey=JSortKey,
    date=lambda days: JLiteral(days, JT.DATE))


def _q67(a, s, p):
    """The port's q67_rollup_dataframe, written against API ``a``."""
    keys = tpcds.Q67_KEYS
    dd = (s.read_parquet(p["date_dim"])
          .where((a.col("d_month_seq") >= a.lit(1200))
                 & (a.col("d_month_seq") <= a.lit(1211)))
          .select(a.col("d_date_sk"), a.col("d_year"), a.col("d_qoy"),
                  a.col("d_moy")))
    st = s.read_parquet(p["store"]).select(a.col("s_store_sk"),
                                           a.col("s_store_id"))
    it = s.read_parquet(p["item"]).select(
        a.col("i_item_sk"), a.col("i_category"), a.col("i_class"),
        a.col("i_brand"), a.col("i_product_name"))
    sales = (s.read_parquet(*p["store_sales"])
             .join(dd, left_on=[a.col("ss_sold_date_sk")],
                   right_on=[a.col("d_date_sk")])
             .join(st, left_on=[a.col("ss_store_sk")],
                   right_on=[a.col("s_store_sk")])
             .join(it, left_on=[a.col("ss_item_sk")],
                   right_on=[a.col("i_item_sk")])
             .select(*[a.col(k) for k in keys], a.Coalesce(
                 a.col("ss_sales_price") * a.col("ss_quantity"),
                 a.lit(0.0)).alias("sales")))
    dw1 = sales.rollup(*keys).agg((a.sum_(a.col("sales")), "sumsales"))
    spec = a.Window.partition_by("i_category").order_by("sumsales",
                                                       desc=True)
    return (dw1.select(*[a.col(k) for k in keys], a.col("sumsales"),
                       a.rank().over(spec).alias("rk"))
            .where(a.col("rk") <= a.lit(100))
            .order_by(*[a.col(k) for k in keys], a.col("sumsales"),
                      a.col("rk"))
            .limit(100))


def _q5(a, s, p):
    sales = s.read_parquet(*p["store_sales"]).select(
        a.col("ss_store_sk").alias("store_sk"),
        a.col("ss_sold_date_sk").alias("date_sk"),
        a.col("ss_ext_sales_price").alias("sales_price"),
        a.col("ss_net_profit").alias("profit"),
        a.lit(0.0).alias("return_amt"), a.lit(0.0).alias("net_loss"))
    returns = s.read_parquet(p["store_returns"]).select(
        a.col("sr_store_sk"), a.col("sr_returned_date_sk"),
        a.lit(0.0).alias("sales_price"), a.lit(0.0).alias("profit"),
        a.col("sr_return_amt"), a.col("sr_net_loss"))
    dd = (s.read_parquet(p["date_dim"])
          .where((a.col("d_date") >= a.date(tpcds.Q5_DATES[0]))
                 & (a.col("d_date") <= a.date(tpcds.Q5_DATES[1])))
          .select(a.col("d_date_sk")))
    st = s.read_parquet(p["store"]).select(a.col("s_store_sk"),
                                           a.col("s_store_id"))
    ssr = (sales.union(returns)
           .join(dd, left_on=[a.col("date_sk")],
                 right_on=[a.col("d_date_sk")])
           .join(st, left_on=[a.col("store_sk")],
                 right_on=[a.col("s_store_sk")])
           .group_by(a.col("s_store_id"))
           .agg((a.sum_(a.col("sales_price")), "sales"),
                (a.sum_(a.col("profit")), "profit"),
                (a.sum_(a.col("return_amt")), "returns_amt"),
                (a.sum_(a.col("net_loss")), "profit_loss")))
    return (ssr.select(a.col("s_store_id"), a.col("sales"),
                       a.col("returns_amt"),
                       (a.col("profit") - a.col("profit_loss"))
                       .alias("profit"))
            .order_by(a.col("s_store_id")).limit(100))


def _q27(a, s, p, states):
    gender, marital, education = tpcds.Q27_DEMOGRAPHICS
    cd = (s.read_parquet(p["customer_demographics"])
          .where(a.col("cd_gender").eq(a.lit(gender))
                 & a.col("cd_marital_status").eq(a.lit(marital))
                 & a.col("cd_education_status").eq(a.lit(education)))
          .select(a.col("cd_demo_sk")))
    dd = (s.read_parquet(p["date_dim"]).where(a.col("d_year").eq(a.lit(2002)))
          .select(a.col("d_date_sk")))
    st = (s.read_parquet(p["store"]).where(a.In(a.col("s_state"),
                                                tuple(states)))
          .select(a.col("s_store_sk"), a.col("s_state")))
    it = s.read_parquet(p["item"]).select(a.col("i_item_sk"),
                                          a.col("i_item_id"))
    joined = (s.read_parquet(*p["store_sales"])
              .join(cd, left_on=[a.col("ss_cdemo_sk")],
                    right_on=[a.col("cd_demo_sk")])
              .join(dd, left_on=[a.col("ss_sold_date_sk")],
                    right_on=[a.col("d_date_sk")])
              .join(st, left_on=[a.col("ss_store_sk")],
                    right_on=[a.col("s_store_sk")])
              .join(it, left_on=[a.col("ss_item_sk")],
                    right_on=[a.col("i_item_sk")]))
    keys = ("i_item_id", "s_state")
    return (joined.grouping_sets([keys, keys[:1], ()], keys)
            .agg((a.avg(a.col("ss_quantity")), "agg1"),
                 (a.avg(a.col("ss_list_price")), "agg2"),
                 (a.avg(a.col("ss_coupon_amt")), "agg3"),
                 (a.avg(a.col("ss_sales_price")), "agg4"))
            .order_by(a.SortKey(a.col("i_item_id"), False, True),
                      a.SortKey(a.col("s_state"), False, True))
            .limit(100))


def _variant_state(catalog) -> str:
    return catalog["store"]["s_state"][0].as_py()


#: query -> (the JAX builder, the port's DataFrame, the SQL text's
#: number or None)
def _queries(catalog):
    state = _variant_state(catalog)
    return {
        "q67": (_q67, lambda s, p: tpcds.q67_rollup_dataframe(
            s, p["date_dim"], p["store_sales"], p["item"], p["store"]), 67),
        "q5": (_q5, lambda s, p: tpcds.q5_dataframe(
            s, p["date_dim"], p["store_sales"], p["store_returns"],
            p["store"]), 5),
        "q27": (lambda a, s, p: _q27(a, s, p, tpcds.Q27_STATES),
                lambda s, p: tpcds.q27_dataframe(
                    s, p["date_dim"], p["store_sales"], p["item"],
                    p["store"], p["customer_demographics"]), 27),
        "q27_present_state": (
            lambda a, s, p: _q27(a, s, p, (state,)),
            lambda s, p: tpcds.q27_dataframe(
                s, p["date_dim"], p["store_sales"], p["item"], p["store"],
                p["customer_demographics"], states=(state,)), None),
    }


@pytest.fixture(scope="module")
def jax_side(catalog, paths):
    """Each query's JAX results (both engines and, for the texts, the
    SQL frontend) and its JAX plan."""
    conf = get_conf()
    saved = dict(conf._values)
    conf.set(TTB, 1)
    conf.set(PARTS, 2)
    set_conf(conf)
    try:
        sql = build_session(SCALE, SEED)
        out = {}
        for name, (jax_fn, _, text) in _queries(catalog).items():
            df = jax_fn(JAX, TpuSession(conf), paths)
            out[name] = {"root": plan_query(df._plan, conf)[0],
                         "tpu": df.collect(engine="tpu")}
            if (name, "cpu") in CASES:
                out[name]["cpu"] = df.collect(engine="cpu")
            if text is not None:
                out[name]["sql"] = sql.sql(QUERIES[text]).collect()
        return out
    finally:
        conf._values.clear()
        conf._values.update(saved)
        set_conf(conf)


@pytest.fixture
def port_session():
    return TorchSession({TTB: 1, PARTS: 2}, device="cpu")


#: (query, JAX engine); the CPU engine cannot run q5: it concatenates
#: the union's members with pyarrow, which refuses their schemas (a
#: literal 0.0 column is not null in one member and nullable in the
#: other)
CASES = [(q, e) for q in ("q67", "q5", "q27", "q27_present_state")
         for e in ("tpu", "cpu", "sql")
         if not (q.endswith("state") and e == "sql")
         and (q, e) != ("q5", "cpu")]


@pytest.mark.parametrize("query,engine", CASES)
def test_queries_match_the_jax_engines_and_sql(query, engine, catalog, paths,
                                               jax_side, port_session):
    _, port_fn, _ = _queries(catalog)[query]
    got = port_fn(port_session, paths).collect()
    want = jax_side[query][engine]
    if engine == "sql":
        want = want.rename_columns(got.schema.names)
    rows = {"q67": 100, "q5": 6, "q27": 0}.get(query)
    assert got.num_rows == (rows if rows is not None else want.num_rows)
    if query == "q27_present_state":
        assert got.num_rows >= 10
    assert_tables_equal(_significant(got), _significant(want),
                        ignore_order=False, approx_float=True)


def _jax_walk(node):
    yield node
    for c in node.children:
        yield from _jax_walk(c)


def _broadcast_sides(root, cls, walk) -> list:
    return sorted(j.build_is_right for j in walk(root) if isinstance(j, cls))


@pytest.mark.parametrize("query", ["q67", "q5", "q27"])
def test_both_engines_plan_the_same_joins_and_filters(query, catalog, paths,
                                                      jax_side,
                                                      port_session):
    """Every join broadcasts its dimension, built on the same side; the
    runtime filters sit where the JAX planner puts them (q5's union
    stops them: its date filter reaches no scan)."""
    plan = _queries(catalog)[query][1](port_session, paths).physical_plan()
    jroot = jax_side[query]["root"]
    assert _broadcast_sides(plan, TpuBroadcastHashJoinExec,
                            lambda r: r.walk()) == _broadcast_sides(
        jroot, JBroadcast, _jax_walk)
    got = sorted(rf.key_name for rf in RF.plan_runtime_filters(plan))
    want = sorted(rf.key_name for b in _jax_walk(jroot)
                  if isinstance(b, JRFBuild) for _k, rf in b.entries)
    assert got == want
    assert got == {"q67": ["ss_sold_date_sk"], "q5": [],
                   "q27": ["ss_cdemo_sk"]}[query]
    applied = [(tuple(n.paths), c) for n in plan.walk()
               for c, _ in getattr(n, "runtime_filters", ())]
    assert applied == [(tuple(paths["store_sales"]), k) for k in got]


def test_q67_expands_under_the_partial_aggregate(catalog, paths,
                                                 port_session):
    plan = _queries(catalog)["q67"][1](port_session, paths).physical_plan()
    [window] = [n for n in plan.walk() if isinstance(n, TpuWindowExec)]
    ex = window.children[0]
    assert isinstance(ex, TpuShuffleExchangeExec)
    assert [e.dtype.name for e in ex.partitioning.exprs] == ["string"]
    final = ex.children[0].children[0]
    assert isinstance(final, TpuHashAggregateExec) and final.mode == "final"
    agg_ex = final.children[0]
    assert [e.dtype.name for e in agg_ex.partitioning.exprs] == [
        "string"] * 4 + ["bigint"] * 3 + ["string", "bigint"]
    partial = agg_ex.children[0]
    assert partial.mode == "partial"
    expand = partial.children[0]
    assert isinstance(expand, TpuExpandExec)
    assert len(expand.projections) == len(tpcds.Q67_KEYS) + 1
    assert expand.schema.names == [*tpcds.Q67_KEYS, "sales", "__gid"]


def test_q5_unions_by_position_and_k1_hashes_each_map_batch(
        catalog, paths, port_session, monkeypatch):
    plan = _queries(catalog)["q5"][1](port_session, paths).physical_plan()
    [union] = [n for n in plan.walk() if isinstance(n, TpuUnionExec)]
    assert union.schema.names == ["store_sk", "date_sk", "sales_price",
                                  "profit", "return_amt", "net_loss"]
    assert [c.schema.names[0] for c in union.children] == [
        "store_sk", "sr_store_sk"]
    assert union.num_partitions == N_FILES + 1
    launches = []
    real = kernels.hash_columns

    def spy(cols, num_rows, device, seed=42, num_partitions=0):
        launches.append(num_rows)
        return real(cols, num_rows, device, seed, num_partitions)

    monkeypatch.setattr(kernels, "hash_columns", spy)
    exchanges = [n for n in plan.walk()
                 if isinstance(n, TpuShuffleExchangeExec)
                 and isinstance(n.partitioning, HashPartitioning)]
    assert len(exchanges) == 1
    list(plan.execute())
    # the partial aggregate makes one batch per union partition
    assert len(launches) == union.num_partitions


@pytest.mark.parametrize("table", ["store", "customer_demographics"])
def test_generators_copy_the_mini_catalog(table):
    ref = {"store": tpcds_schema._store,
           "customer_demographics": tpcds_schema._customer_demographics}
    port = {"store": tpcds.make_store,
            "customer_demographics": tpcds.make_customer_demographics}
    n = {"store": 12, "customer_demographics": 5000}[table]
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    want, got = ref[table](a, n), port[table](b, n)
    assert got.equals(want)
    assert a.integers(0, 1 << 30) == b.integers(0, 1 << 30)


def test_the_sf1_store_states_leave_q27s_text_empty():
    store = tpcds.make_store(np.random.default_rng(12), 12)
    states = set(store["s_state"].to_pylist())
    assert states <= set(tpcds._STATES[:8])
    assert not states & set(tpcds.Q27_STATES)


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
