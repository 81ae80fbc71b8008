"""Plan rewriting with CPU fallback: the port's tags, ``explain()`` and
``CpuFallbackExec`` against the JAX package's planner.

- For the 51 TPC-DS texts the JAX sweep runs correctly, over the JAX
  mini catalog (in-memory tables on both sides): the port's tagged tree
  equals the JAX package's line for line, marks and nodes, and the only
  node either keeps off the accelerator is q37's date_dim Filter, for
  the same cast (STRING to DATE).  The texts whose CASE the JAX
  frontend misreads (``test_torch_tpcds_channels.CASE_TEXTS``) compare
  their marks and node kinds.
- Each point where the port raised before it had a CPU engine (a
  residual condition on an outer, semi or anti join, a keyless outer
  join, min / max / first / last over a string, the windows and casts
  the device path lacks) now plans a ``CpuFallbackExec`` with its
  reason; its rows equal the JAX package's ``collect()``, or, where the
  JAX CPU engine departs from Spark (it drops an outer join's unmatched
  rows under a residual condition and cannot join without keys, see
  ``ROADMAP.md`` section 3), a nested-loop reference here.
- Each exec switch turned off moves exactly its nodes to the CPU engine
  and gives the same rows; adjacent CPU nodes fuse; a Filter streams.
- No plan of the earlier workloads holds a ``CpuFallbackExec``.
"""

import re

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import first as jfirst
from spark_rapids_tpu.session import last as jlast
from spark_rapids_tpu.session import max_ as jmax
from spark_rapids_tpu.session import min_ as jmin
from spark_rapids_tpu.session import count as jcount
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.exprs.cast import Cast as JCast
from spark_rapids_tpu.exprs.window import Window as JWindow
from spark_rapids_tpu.exprs.window import lead as jlead
from spark_rapids_tpu.tools import tpcds_schema
from spark_rapids_tpu.tools.sweep import build_session

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession, Window, col, lit, tpcds, tpch
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.execs.fallback import CpuFallbackExec
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.window import lead
from spark_rapids_tpu_torch.frontends.sql import SqlSession
from spark_rapids_tpu_torch.plan import planner as PL
from spark_rapids_tpu_torch.session import count, first, last, max_, min_
from spark_rapids_tpu_torch.tpcds_queries import (
    CATALOG_WEB,
    QUERIES,
    STORE_CHANNEL,
)
from test_torch_tpcds_channels import CASE_TEXTS

TAG = re.compile(r"^(\s*)([*!]) (.*?)(?:  <-- cannot run on (.*))?$")


def tagged(explain: str) -> list:
    """(indent, mark, node, reasons) of each tagged-tree line."""
    return [m.groups() for m in map(TAG.match, explain.splitlines()) if m]


@pytest.fixture(scope="module")
def texts():
    port = SqlSession(device="cpu")
    for name, t in tpcds_schema.generate(1.0, 7).items():
        port.register_table(name, t)
    return port, build_session(1.0, 7)


@pytest.mark.parametrize("q", sorted(CATALOG_WEB + STORE_CHANNEL))
def test_explain_marks_the_nodes_the_jax_package_marks(q, texts):
    port, jax = texts
    ours = tagged(port.sql(QUERIES[q]).explain())
    theirs = tagged(jax.sql(QUERIES[q]).explain())
    if q in CASE_TEXTS:
        ours = [(i, m, n.split()[0], r) for i, m, n, r in ours]
        theirs = [(i, m, n.split()[0], r) for i, m, n, r in theirs]
    assert [t[:3] for t in ours] == [t[:3] for t in theirs]
    off = [t for t in ours if t[1] == "!"]
    if q != 37:
        assert not off
        return
    (_, _, node, reasons), = off
    (_, _, _, jreasons), = [t for t in theirs if t[1] == "!"]
    assert node.startswith("Filter [") and "d_date" in node
    assert "cast string -> date" in reasons
    assert "cast string -> date" in jreasons


def test_q37_crosses_to_the_host_and_back_through_its_filter(texts):
    port, _ = texts
    df = port.sql(QUERIES[37])
    plan = df.physical_plan()
    cpu = [n for n in plan.walk() if isinstance(n, CpuFallbackExec)]
    assert len(cpu) == 1 and cpu[0].streaming
    (fb,) = cpu
    it = plan.execute()
    for _ in it:
        pass
    dd = tpcds_schema.generate(1.0, 7)["date_dim"]
    lo = pc.cast(pc.strptime(pa.scalar("2000-02-01"), "%Y-%m-%d", "s"),
                 pa.date32())
    hi = pc.cast(pc.strptime(pa.scalar("2000-04-01"), "%Y-%m-%d", "s"),
                 pa.date32())
    kept = pc.sum(pc.and_(pc.greater_equal(dd["d_date"], lo),
                          pc.less_equal(dd["d_date"], hi))).as_py()
    m = fb.metrics
    assert m["toHostRows"] == dd.num_rows and m["toHostBatches"] >= 1
    assert m["toDeviceRows"] == kept and m["toDeviceBatches"] >= 1
    assert m["cpuTime"] > 0


# --------------------------------------------------------------------- #
# The former raise points
# --------------------------------------------------------------------- #

LEFT = pa.table({"k": pa.array([1, 1, 2, 3, None, 4], pa.int64()),
                 "a": pa.array([10, 20, 30, 40, 50, None], pa.int64()),
                 "s": pa.array(["x", "b\0", None, "a", "", "é"])})
RIGHT = pa.table({"k2": pa.array([1, 1, 2, 4, None], pa.int64()),
                  "b": pa.array([5, 25, 100, 7, 1], pa.int64())})


def _pair_rows(how, keyed, cond):
    """A nested-loop join of LEFT and RIGHT as Spark defines it: a pair
    matches when the keys are equal (and not NULL) and the condition is
    true; an outer join keeps unmatched rows NULL-extended."""
    lrows, rrows = LEFT.to_pylist(), RIGHT.to_pylist()

    def match(l, r):
        if keyed and (l["k"] is None or l["k"] != r["k2"]):
            return False
        if cond and (l["a"] is None or r["b"] is None
                     or not l["a"] > r["b"]):
            return False
        return True

    out, rhit = [], set()
    for l in lrows:
        hits = [j for j, r in enumerate(rrows) if match(l, r)]
        rhit.update(hits)
        if how == "left_semi":
            out += [l] if hits else []
        elif how == "left_anti":
            out += [] if hits else [l]
        else:
            out += [{**l, **rrows[j]} for j in hits]
            if not hits and how in ("left_outer", "full_outer"):
                out.append({**l, "k2": None, "b": None})
    if how in ("right_outer", "full_outer"):
        out += [{"k": None, "a": None, "s": None, **r}
                for j, r in enumerate(rrows) if j not in rhit]
    names = list(LEFT.schema.names) + ([] if how in ("left_semi",
                                                      "left_anti")
                                       else list(RIGHT.schema.names))
    return pa.Table.from_pylist(out, schema=pa.schema(
        [f for f in list(LEFT.schema) + list(RIGHT.schema)
         if f.name in names]))


def _port():
    return TorchSession(device="cpu")


def _off(df):
    """The nodes ``explain()`` marks ``!``: (node kind, reasons)."""
    return [(n.split()[0], r) for _, m, n, r in tagged(df.explain())
            if m == "!"]


@pytest.mark.parametrize("how", ["left_outer", "right_outer", "full_outer",
                                 "left_semi", "left_anti"])
@pytest.mark.parametrize("keyed,cond", [(True, True), (False, True),
                                        (False, False)])
def test_conditional_and_keyless_joins_fall_back(how, keyed, cond):
    s = _port()
    df = s.create_dataframe(LEFT).join(
        s.create_dataframe(RIGHT), how=how,
        left_on=[col("k")] if keyed else None,
        right_on=[col("k2")] if keyed else None,
        condition=(col("a") > col("b")) if cond else None)
    (kind, reason), = _off(df)
    assert kind == "Join"
    assert ("residual condition" if keyed else "without keys") in reason
    assert any(isinstance(n, CpuFallbackExec)
               for n in df.physical_plan().walk())
    assert_tables_equal(df.collect(), _pair_rows(how, keyed, cond))


def _string_aggregates(S, c, mn, mx, fst, lst):
    df = S.create_dataframe(LEFT)
    return [df.group_by(c("k")).agg((mn(c("s")), "mn"), (mx(c("s")), "mx"),
                                    (fst(c("s")), "f"), (lst(c("s")), "l")),
            df.agg((mn(c("s")), "mn"), (mx(c("s")), "mx"))]


def test_string_min_max_first_last_fall_back_and_equal_the_jax_package():
    ours = _string_aggregates(_port(), col, min_, max_, first, last)
    theirs = _string_aggregates(TpuSession(), jcol, jmin, jmax, jfirst,
                                jlast)
    for got, want in zip(ours, theirs):
        assert [k for k, _ in _off(got)] == ["Aggregate"]
        assert "string" in _off(got)[0][1]
        assert_tables_equal(got.collect(), want.collect())


def _windows(S, c, W, mn, cnt, ld):
    df = S.create_dataframe(LEFT)
    spec = W.partition_by("k").order_by("a")
    return [
        df.select(c("k"), c("a"), mn(c("a")).over(
            W.partition_by("k").order_by("a").rows_between(-1, 1))
            .alias("m")),
        df.select(c("k"), c("s"), cnt(c("s")).over(spec).alias("n")),
        df.select(c("k"), c("a"), ld(c("s"), 1, c("s")).over(spec)
                  .alias("n")),
    ]


def test_unported_windows_fall_back_and_equal_the_jax_package():
    ours = _windows(_port(), col, Window, min_, count, lead)
    theirs = _windows(TpuSession(), jcol, JWindow, jmin, jcount, jlead)
    for got, want in zip(ours, theirs):
        assert [k for k, _ in _off(got)] == ["Window"]
        assert "not ported" in _off(got)[0][1]
        assert_tables_equal(got.collect(), want.collect())


def _cast_dates(S, c, cast, dtype, texts):
    return S.create_dataframe(pa.table({"s": pa.array(texts)})).select(
        c("s"), cast(c("s"), dtype).alias("d"))


def test_unported_casts_fall_back_and_equal_the_jax_package():
    texts = ["2000-02-01", " 1999-12-31 ", "nope", None, "2001-02-29",
             "2000-13-01", "0001-01-01"]
    got = _cast_dates(_port(), col, Cast, T.DATE, texts)
    want = _cast_dates(TpuSession(), jcol, JCast, JT.DATE, texts)
    (kind, reason), = _off(got)
    assert kind == "Project" and "cast string -> date" in reason
    assert_tables_equal(got.collect(), want.collect(engine="cpu"))


def test_string_to_date_takes_sparks_forms():
    """Spark casts yyyy, yyyy-[m]m and yyyy-[m]m-[d]d, then an optional
    time part; the JAX CPU engine takes only ISO dates (its
    ``date.fromisoformat``, ROADMAP.md section 3)."""
    import datetime as dt

    texts = ["2000-2-3", "2000", "2000-7", "1999-12-31 23:59",
             "2000-02-01T10:00:00", "20000203"]
    got = _cast_dates(_port(), col, Cast, T.DATE, texts).collect()
    assert got["d"].to_pylist() == [dt.date(2000, 2, 3), dt.date(2000, 1, 1),
                                    dt.date(2000, 7, 1),
                                    dt.date(1999, 12, 31),
                                    dt.date(2000, 2, 1), None]


# --------------------------------------------------------------------- #
# The exec switches
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def facts(tmp_path_factory):
    d = tmp_path_factory.mktemp("fallback")
    rng = np.random.default_rng(5)
    n = 3000
    t = pa.table({"k": rng.integers(0, 20, n),
                  "v": np.round(rng.uniform(-5, 5, n), 2),
                  "g": pa.array(np.array(["p", "q", "r"])[
                      rng.integers(0, 3, n)])})
    paths = []
    for i in range(3):
        p = str(d / f"f-{i}.parquet")
        pq.write_table(t.slice(i * 1000, 1000), p)
        paths.append(p)
    return paths


def _workloads(s, paths):
    """node kind -> a DataFrame that has such nodes."""
    f = s.read_parquet(*paths)
    dim = s.create_dataframe(pa.table({"k": np.arange(20),
                                       "w": np.arange(20) * 1.5}))
    spec = Window.partition_by("g").order_by("v")
    from spark_rapids_tpu_torch import rank

    return {
        "Scan": f.where(col("v") > lit(0.0)).select(col("k"), col("g")),
        "InMemoryRelation": dim.where(col("w") > lit(3.0)),
        "RangeRel": s.range(0, 50, 3).select((col("id") * lit(2))
                                             .alias("x")),
        "Project": f.select(col("k"), (col("v") * lit(2.0)).alias("v2")),
        "Filter": f.where(col("k") < lit(5)),
        "Aggregate": f.group_by(col("g")).agg((min_(col("v")), "mn"),
                                              (count(col("k")), "n")),
        "Expand": f.rollup("g", "k").agg((max_(col("v")), "mx")),
        "Join": f.join(dim, left_on=[col("k")], right_on=[col("k")]),
        "Window": f.select(col("g"), col("v"),
                           rank().over(spec).alias("r")),
        "Sort": f.order_by(col("v"), col("k")),
        "Limit": f.order_by(col("v"), col("k"), col("g")).limit(7),
        "Union": f.select(col("k")).union(dim.select(col("k"))),
    }


#: the first word of a node's line in ``explain()``, where it is not
#: the class name
DESC = {"RangeRel": "Range"}


def _switch(kind):
    cls = next(c for c in PL.EXEC_SWITCHES if c.__name__ == kind)
    return PL.EXEC_SWITCHES[cls]


KINDS = ("Scan", "InMemoryRelation", "RangeRel", "Project", "Filter",
         "Aggregate", "Expand", "Join", "Window", "Sort", "Limit", "Union")


@pytest.mark.parametrize("kind", KINDS)
def test_an_exec_switch_off_moves_its_nodes_and_keeps_the_rows(kind,
                                                                facts):
    on = _workloads(_port(), facts)[kind]
    off_session = TorchSession({_switch(kind): False}, device="cpu")
    off = _workloads(off_session, facts)[kind]
    lines = tagged(off.explain())
    marked = [n.split()[0] for _, m, n, _ in lines if m == "!"]
    desc = DESC.get(kind, kind)
    assert marked and set(marked) == {desc}
    assert len(marked) == sum(n.split()[0] == desc for _, _, n, _ in lines)
    assert all(f"disabled by {_switch(kind)}" in r
               for _, m, _, r in lines if m == "!")
    assert not _off(on)
    assert_tables_equal(off.collect(), on.collect(), approx_float=True,
                        ignore_order=kind not in ("Sort", "Limit"))


def test_switch_keys_are_the_jax_packages():
    from spark_rapids_tpu.plan import planner as JPL

    jkeys = {e.key for e in JPL._EXEC_CONFS.values()}
    assert set(PL.EXEC_SWITCHES.values()) <= jkeys
    jexpr = {e.key for e in JPL.SUPPORTED_EXPRS.values()}
    assert set(PL.SUPPORTED_EXPRS.values()) <= jexpr


def test_an_expression_switch_off_moves_its_node():
    s = TorchSession({"spark.rapids.tpu.sql.expression.Multiply": False},
                     device="cpu")
    df = s.range(0, 10).select((col("id") * lit(3)).alias("x"),
                               (col("id") + lit(1)).alias("y"))
    (kind, reason), = _off(df)
    assert kind == "Project" and "Multiply disabled" in reason
    assert df.collect()["x"].to_pylist() == [3 * i for i in range(10)]


def test_adjacent_cpu_nodes_fuse_and_a_filter_streams(facts):
    s = TorchSession({_switch("Project"): False, _switch("Filter"): False,
                      "spark.rapids.tpu.sql.scan.taskTargetBytes": 1},
                     device="cpu")
    df = s.read_parquet(*facts).where(col("k") < lit(5)).select(
        (col("v") + lit(1.0)).alias("w"))
    plan = df.physical_plan()
    outer, inner = [n for n in plan.walk() if isinstance(n, CpuFallbackExec)]
    assert not outer.streaming and inner.streaming
    assert inner.num_partitions == inner.children[0].num_partitions == 3
    got = pa.concat_tables([outer.cpu_table()])
    assert outer.metrics["toHostRows"] == 0  # its child's table, fused
    assert inner.metrics["toHostRows"] == 3000
    want = TorchSession(device="cpu").read_parquet(*facts).where(
        col("k") < lit(5)).select((col("v") + lit(1.0)).alias("w"))
    assert_tables_equal(got, want.collect(), approx_float=True)


# --------------------------------------------------------------------- #
# The earlier workloads plan no fallback
# --------------------------------------------------------------------- #


def test_earlier_workloads_plan_no_cpu_fallback(tmp_path):
    d = str(tmp_path)
    s = TorchSession({"spark.rapids.tpu.sql.scan.taskTargetBytes": 1},
                     device="cpu")
    li = tpch.make_lineitem(d, n_files=2, with_q1_cols=True,
                            with_orderkey=True, n_orders=500,
                            rows_per_file=500)
    orders = tpch.make_orders(d, 500)
    ss67 = tpcds.make_store_sales(d, n_rows=1000, n_files=2)
    dd, ss, item = tpcds.write_q3_tables(d, n_files=2, rows_per_file=500)
    sr, reason = tpcds.write_q93_tables(d, ss)
    store = tpcds.write_store(d)
    cdemo = tpcds.write_customer_demographics(d, n=500)
    frames = {
        "q6": tpch.q6_dataframe(s, li), "q1": tpch.q1_dataframe(s, li),
        "q3": tpch.q3_dataframe(s, li, orders),
        "q67": tpcds.q67_dataframe(s, ss67),
        "q3ds": tpcds.q3_dataframe(s, dd, ss, item),
        "q42": tpcds.q42_dataframe(s, dd, ss, item),
        "q52": tpcds.q52_dataframe(s, dd, ss, item),
        "q55": tpcds.q55_dataframe(s, dd, ss, item),
        "q93": tpcds.q93_dataframe(s, ss, sr, reason),
        "q67_rollup": tpcds.q67_rollup_dataframe(s, dd, ss, item, store),
        "q5": tpcds.q5_dataframe(s, dd, ss, sr, store),
        "q27": tpcds.q27_dataframe(s, dd, ss, item, store, cdemo),
    }
    for name, df in frames.items():
        assert not _off(df), name
        assert not any(isinstance(n, CpuFallbackExec)
                       for n in df.physical_plan().walk()), name


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
