"""The scan's host path end to end: static filter pushdown, the host
prefilter with device-Filter elision, and the native decoder.

q6, q1 and TPC-DS q3 run on ``device="cpu"`` with
``scan.fastDecode``, ``scan.hostPrefilter`` and
``scan.elideDeviceFilter`` each on and off, against both JAX engines
(integers, strings and NULLs exact, floats within rel 1e-9: batch
boundaries move between the decoders, and with them the order of a
float sum).  The lineitem files are the port's ``make_lineitem`` rows
rewritten in ship-date order with small row groups, so q6's ship-date
conjuncts prune row groups on the footers; the scan's
``rowGroupsPruned``, ``hostFilteredRows`` and ``rfPrunedRows`` must
equal the JAX scan's on the same files, with its decoder on and off.
``scan.taskTargetBytes`` = 1 makes each file its own scan task; the
JAX engines read the process-global conf, set through ``set_conf`` and
restored afterwards.
"""

import math

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import bench
from spark_rapids_tpu.config import get_conf, set_conf
from spark_rapids_tpu.io.scan import ParquetScanExec as JScan
from spark_rapids_tpu.plan.planner import collect_exec as jcollect
from spark_rapids_tpu.plan.planner import plan_query
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.tools import tpcds_schema

from spark_rapids_tpu_torch import TorchSession, tpch, tpcds
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.execs.basic import TpuFilterExec
from spark_rapids_tpu_torch.io import scan as scan_mod
from spark_rapids_tpu_torch.io.scan import ParquetScanExec
from spark_rapids_tpu_torch.session import col, lit, sum_
from spark_rapids_tpu_torch.plan.planner import collect_exec

ROWS, FILES, GROUP_ROWS = 8192, 3, 1024
KEYS = (C.FAST_DECODE, C.HOST_PREFILTER, C.ELIDE_DEVICE_FILTER)
#: the three keys: all on (the defaults), each off alone, all off
SETTINGS = [(True, True, True), (False, True, True), (True, False, True),
            (True, True, False), (False, False, False)]
REL = 1e-9


def _conf(setting, **more) -> dict:
    return {C.TASK_TARGET_BYTES: 1, **dict(zip(KEYS, setting)), **more}


@pytest.fixture(scope="module")
def lineitem(tmp_path_factory):
    d = tmp_path_factory.mktemp("lineitem_host")
    raw = tpch.make_lineitem(str(d), n_files=FILES, with_q1_cols=True,
                             rows_per_file=ROWS)
    paths = []
    for i, p in enumerate(raw):
        t = pq.read_table(p)
        t = t.take(np.argsort(t["l_shipdate"].to_numpy(), kind="stable"))
        out = str(d / f"sorted-{i}.parquet")
        pq.write_table(t, out, row_group_size=GROUP_ROWS)
        paths.append(out)
    return paths


@pytest.fixture(scope="module")
def q3ds_data(tmp_path_factory):
    cat = tpcds_schema.generate(0.5, seed=7)
    d = tmp_path_factory.mktemp("q3ds_host")
    dd, item = str(d / "date_dim.parquet"), str(d / "item.parquet")
    pq.write_table(cat["date_dim"], dd, row_group_size=8192)
    pq.write_table(cat["item"], item)
    ss = cat["store_sales"]
    per = -(-ss.num_rows // FILES)
    paths = []
    for i in range(FILES):
        p = str(d / f"store_sales-{i}.parquet")
        pq.write_table(ss.slice(i * per, per), p)
        paths.append(p)
    return dd, paths, item


class _JaxConf:
    """The JAX process-global conf with some keys set, restored after."""

    def __init__(self, **keys):
        self.keys = keys

    def __enter__(self):
        conf = get_conf()
        self.saved = dict(conf._values)
        conf.set(C.TASK_TARGET_BYTES, 1)
        for k, v in self.keys.items():
            conf.set(k, v)
        set_conf(conf)
        return conf

    def __exit__(self, *exc):
        conf = get_conf()
        conf._values.clear()
        conf._values.update(self.saved)
        set_conf(conf)


def _jax_q3ds(s, dd, ss_paths, item):
    from spark_rapids_tpu.execs.sort import SortKey as JSortKey
    from spark_rapids_tpu.exprs.base import lit as jlit
    from spark_rapids_tpu.session import col as jcol
    from spark_rapids_tpu.session import sum_ as jsum

    dt = (s.read_parquet(dd).where(jcol("d_moy").eq(jlit(11)))
          .select(jcol("d_date_sk"), jcol("d_year")))
    it = (s.read_parquet(item).where(jcol("i_manufact_id").eq(jlit(128)))
          .select(jcol("i_item_sk"), jcol("i_brand_id"), jcol("i_brand")))
    return (dt.join(s.read_parquet(*ss_paths), left_on=[jcol("d_date_sk")],
                    right_on=[jcol("ss_sold_date_sk")])
            .join(it, left_on=[jcol("ss_item_sk")],
                  right_on=[jcol("i_item_sk")])
            .group_by(jcol("d_year"), jcol("i_brand_id"), jcol("i_brand"))
            .agg((jsum(jcol("ss_ext_sales_price")), "sum_agg"))
            .order_by(JSortKey(jcol("d_year")),
                      JSortKey(jcol("sum_agg"), True, True),
                      JSortKey(jcol("i_brand_id")))
            .limit(100))


QUERIES = {
    "q6": (lambda s, li, ds: tpch.q6_dataframe(s, li),
           lambda s, li, ds: bench.q6_dataframe(s, li)),
    "q1": (lambda s, li, ds: tpch.q1_dataframe(s, li),
           lambda s, li, ds: bench.q1_dataframe(s, li)),
    "q3ds": (lambda s, li, ds: tpcds.q3_dataframe(s, *ds),
             lambda s, li, ds: _jax_q3ds(s, *ds)),
}


def _jax_run(query, lineitem, q3ds_data, **keys):
    """(both JAX engines' results, the JAX scans' counters by path)."""
    with _JaxConf(**keys) as conf:
        jdf = QUERIES[query][1](TpuSession(conf), lineitem, q3ds_data)
        root, _ = plan_query(jdf._plan, conf)
        tpu = jcollect(root)
        counters = _jax_counters(root)
        cpu = jdf.collect(engine="cpu")
    return {"tpu": tpu, "cpu": cpu}, counters


def _jax_counters(root) -> dict:
    out: dict = {}
    for n in root._walk():
        if isinstance(n, JScan):
            got = {k: n.metrics[k].value for k in (
                "rowGroupsPruned", "hostFilteredRows", "rfPrunedRows")}
            key = tuple(n.paths)
            out[key] = {k: out.get(key, {}).get(k, 0) + v
                        for k, v in got.items()}
    return out


def _port_counters(plan) -> dict:
    out: dict = {}
    for n in plan.walk():
        if isinstance(n, ParquetScanExec):
            key = tuple(n.paths)
            out[key] = {k: out.get(key, {}).get(k, 0) + n.metrics[k]
                        for k in ("rowGroupsPruned", "hostFilteredRows",
                                  "rfPrunedRows")}
    return out


@pytest.fixture(scope="module")
def jax_results(lineitem, q3ds_data):
    return {q: _jax_run(q, lineitem, q3ds_data)[0] for q in QUERIES}


def _rows(t: pa.Table) -> list:
    return sorted(t.to_pylist(), key=lambda r: [
        (v is None, round(v, 6) if isinstance(v, float) else v)
        for v in r.values()])


def _assert_same(got: pa.Table, want: pa.Table) -> None:
    """Integers, strings and NULLs exact; floats within rel 1e-9."""
    assert got.column_names == want.column_names
    g, w = _rows(got), _rows(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        for k in a:
            if isinstance(b[k], float):
                assert math.isclose(a[k], b[k], rel_tol=REL), (k, a, b)
            else:
                assert a[k] == b[k], (k, a, b)


@pytest.mark.parametrize("setting", SETTINGS,
                         ids=lambda s: "-".join("on" if v else "off"
                                                for v in s))
@pytest.mark.parametrize("query", list(QUERIES))
def test_query_equals_both_jax_engines(query, setting, lineitem, q3ds_data,
                                       jax_results):
    s = TorchSession(_conf(setting), device="cpu")
    df = QUERIES[query][0](s, lineitem, q3ds_data)
    plan = df.physical_plan()
    got = collect_exec(plan, s.conf)
    assert got.num_rows > 0
    for engine in ("tpu", "cpu"):
        _assert_same(got, jax_results[query][engine])
    scans = [n for n in plan.walk() if isinstance(n, ParquetScanExec)]
    fast = sum(n.metrics["fastDecodedFiles"] for n in scans)
    std = sum(n.metrics["standardDecodedFiles"] for n in scans)
    assert (fast > 0, std > 0) == ((True, False) if setting[0]
                                   else (False, True))
    filters = [n for n in plan.walk() if isinstance(n, TpuFilterExec)]
    elided = setting[1] and setting[2]
    assert bool(filters) != elided
    assert all(n.exact_prefilter == elided for n in scans
               if n.pushed_filter is not None)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "standard"])
@pytest.mark.parametrize("query", list(QUERIES))
def test_scan_counters_equal_the_jax_scans(query, fast, lineitem, q3ds_data):
    _, want = _jax_run(query, lineitem, q3ds_data,
                       **{C.FAST_DECODE: fast})
    s = TorchSession(_conf((fast, True, True)), device="cpu")
    plan = QUERIES[query][0](s, lineitem, q3ds_data).physical_plan()
    collect_exec(plan, s.conf)
    got = _port_counters(plan)
    assert got == want
    if query == "q6":
        [c] = got.values()
        assert c["rowGroupsPruned"] > 0 and c["hostFilteredRows"] > 0
    if query == "q3ds":
        assert sum(c["rfPrunedRows"] for c in got.values()) > 0


def test_q6_uploads_only_the_survivors_and_explains_the_elision(lineitem):
    s = TorchSession(_conf((True, True, True)), device="cpu")
    df = tpch.q6_dataframe(s, lineitem)
    text = df.explain()
    assert "TpuFilterExec" not in text
    assert "pushed=[" in text and "(device Filter elided)" in text
    plan = df.physical_plan()
    collect_exec(plan, s.conf)
    [scan] = [n for n in plan.walk() if isinstance(n, ParquetScanExec)]
    t = pa.concat_tables([pq.read_table(p) for p in lineitem])
    ship, disc, qty = (t[c].to_numpy() for c in (
        "l_shipdate", "l_discount", "l_quantity"))
    keep = ((ship >= 8766) & (ship < 9131) & (disc >= 0.05)
            & (disc <= 0.07) & (qty < 24.0))
    assert scan.metrics["numOutputRows"] == int(keep.sum())
    assert scan.schema.names == ["l_extendedprice", "l_discount"]
    assert scan.metrics["fastDecodedFiles"] == FILES
    assert "3 fast, 0 standard" in scan.node_desc()
    off = TorchSession(_conf((True, True, False)), device="cpu")
    text = tpch.q6_dataframe(off, lineitem).explain()
    assert "TpuFilterExec" in text and "pushed=[" in text
    assert "(device Filter elided)" not in text


def test_a_file_outside_the_decoder_is_counted_and_read_by_pyarrow(
        tmp_path, lineitem):
    lz4 = str(tmp_path / "lz4.parquet")
    pq.write_table(pq.read_table(lineitem[0]), lz4, compression="lz4")
    s = TorchSession(_conf((True, True, True)), device="cpu")
    df = tpch.q6_dataframe(s, [lineitem[1], lz4])
    plan = df.physical_plan()
    got = collect_exec(plan, s.conf)
    [scan] = [n for n in plan.walk() if isinstance(n, ParquetScanExec)]
    assert (scan.metrics["fastDecodedFiles"],
            scan.metrics["standardDecodedFiles"]) == (1, 1)
    want = tpch.q6_dataframe(TorchSession(_conf((False, False, False)),
                                          device="cpu"),
                             [lineitem[1], lineitem[0]]).collect()
    _assert_same(got, want)


def _dates(tmp_path) -> str:
    rng = np.random.default_rng(6)
    n = 5000
    t = pa.table({
        "d": pa.array(rng.integers(9000, 9400, n).astype(np.int32),
                      mask=rng.random(n) < 0.1).cast(pa.date32()),
        "v": rng.integers(0, 100, n),
    })
    p = str(tmp_path / "dates.parquet")
    pq.write_table(t, p, row_group_size=1000)
    return p


def test_a_date_against_day_numbers_stays_exact(tmp_path):
    """The decoder compares a DATE column's INT32 values on its
    dictionary; on the pyarrow path the compiled form cannot compare
    date32 with an integer, so the CPU engine filters the decoded rows,
    still exactly."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exprs.base import Literal

    p = _dates(tmp_path)
    cond = ((col("d") >= Literal(9100, T.DATE))
            & (col("d") < Literal(9200, T.DATE)))
    results = []
    for setting in ((True, True, True), (False, True, True),
                    (False, False, False)):
        s = TorchSession(_conf(setting), device="cpu")
        df = s.read_parquet(p).where(cond).agg((sum_(col("v")), "s"))
        plan = df.physical_plan()
        results.append(collect_exec(plan, s.conf))
        [scan] = [n for n in plan.walk() if isinstance(n, ParquetScanExec)]
        assert scan.exact_prefilter == setting[1]
        assert scan.metrics["fastDecodedFiles"] == int(setting[0])
        # the pyarrow path's prefilter met the kernel gap
        assert scan._pa_filter_failed == (setting == (False, True, True))
    t = pq.read_table(p)
    days = t["d"].cast(pa.int32()).to_numpy(zero_copy_only=False)
    ok = ~np.asarray(t["d"].is_null())
    want = int(t["v"].to_numpy()[ok & (days >= 9100) & (days < 9200)].sum())
    assert [r["s"][0].as_py() for r in results] == [want] * 3


def test_the_exact_prefilter_raises_where_the_host_cannot_evaluate(
        tmp_path, monkeypatch):
    p = _dates(tmp_path)

    def broken(*_a, **_k):
        raise RuntimeError("host evaluation failed")

    monkeypatch.setattr(scan_mod, "cpu_eval", broken)
    monkeypatch.setattr(scan_mod, "compile_filter", lambda e: broken)
    cond = col("v") < lit(50)
    exact = TorchSession(_conf((False, True, True)), device="cpu")
    with pytest.raises(RuntimeError, match="host evaluation failed"):
        exact.read_parquet(p).where(cond).collect()
    # not elided: the prefilter turns itself off, the device Filter decides
    kept = TorchSession(_conf((False, True, False)), device="cpu")
    got = kept.read_parquet(p).where(cond).collect()
    assert got.num_rows == int((pq.read_table(p)["v"].to_numpy() < 50).sum())


def test_a_filter_on_the_cpu_engine_pushes_nothing(lineitem):
    s = TorchSession(_conf((True, True, True),
                           **{"spark.rapids.tpu.sql.exec.Filter": False}),
                     device="cpu")
    plan = tpch.q6_dataframe(s, lineitem).physical_plan()
    scans = [n for n in plan.walk() if isinstance(n, ParquetScanExec)]
    assert scans and all(n.pushed_filter is None for n in scans)
    assert any(type(n).__name__ == "CpuFallbackExec" for n in plan.walk())


def test_strings_keep_their_codes_on_the_fast_path(lineitem):
    """q1's group keys reach the coded group-by from the decoder."""
    s = TorchSession(_conf((True, True, True)), device="cpu")
    plan = tpch.q1_dataframe(s, lineitem).physical_plan()
    [scan] = [n for n in plan.walk() if isinstance(n, ParquetScanExec)]
    batch = next(scan.execute_partition(0))
    flag = batch.columns[scan.schema.index_of("l_returnflag")]
    assert flag.codes is not None
    assert scan.metrics["fastDecodedFiles"] == 1


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
