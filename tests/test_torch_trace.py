"""The port's tracer and trace export (``spark_rapids_tpu_torch/trace``)
against the JAX package's ``spark_rapids_tpu.trace`` on the CPU.

- the same seeded script of calls through both tracers (spans, events,
  ``record_complete``, nested contexts, ``attach_context`` across
  threads, ring overflow at a buffer of 8) gives the same events (name,
  phase, attributes, per-thread order; timestamps aside) and the same
  Chrome trace with ``ts`` / ``dur`` / ``pid`` / ``tid`` stripped;
- ``span_stats`` gives the same values on the same seeded events;
- q1, q3 and q3ds run traced equal the untraced run and both JAX
  engines, record the JAX package's span names for the same query
  (an exec's or a stage's name folded to ``*``; the names of layers the
  port has not ported, and those whose presence depends on timing or
  the program cache's state, apart), and every span of a pool, stage
  or reaper thread carries the query's id;
- a serving run records the serving tier's spans and events.

Both tracers are process-global: each test enables them inside
``try/finally`` and leaves both disabled and cleared.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import bench
from spark_rapids_tpu import trace as JT
from spark_rapids_tpu.config import get_conf, set_conf
from spark_rapids_tpu.execs.sort import SortKey as JSortKey
from spark_rapids_tpu.exprs.base import lit as jlit
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import sum_ as jsum
from spark_rapids_tpu.tools import tpcds_schema
from spark_rapids_tpu.trace import export as JX

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession, col, sum_, tpcds, tpch
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import trace as PT
from spark_rapids_tpu_torch.execs.base import REAPER
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.serving import cancel as K
from spark_rapids_tpu_torch.serving import clear_serving_context
from spark_rapids_tpu_torch.serving import scheduler as scheduler_mod
from spark_rapids_tpu_torch.serving import work_share as ws
from spark_rapids_tpu_torch.trace import export as PX

TTB = C.TASK_TARGET_BYTES
#: span and event prefixes of JAX layers the port has not ported: none
#: since the wire codecs and speculation came
UNPORTED = ()
#: names whose presence depends on timing or on the program cache's
#: state, in either package: a stage wait that did not happen, a
#: runtime filter not yet published when a scan decoded, a cache miss
TIMING = ("pipe.*.wait_full", "pipe.*.wait_empty", "rf.apply",
          "jit.cache_miss")
#: threads whose spans must carry their query's id
POOL_THREADS = ("srt-pool-", "srt-pipe-", "srt-metric-reaper")


@pytest.fixture(autouse=True)
def _clean_tracers():
    yield
    for tr in (JT, PT):
        tr.enable(65536)  # back to the default ring size
        tr.disable()
        tr.clear()


def fold(name: str) -> str:
    """A span name with its exec or stage folded to ``*``."""
    for pre in ("exec.", "metric.settle."):
        if name.startswith(pre):
            return pre + "*"
    if name.startswith("pipe.") and name != "pipe.readback":
        return "pipe.*." + name.rsplit(".", 1)[1]
    return name


# --------------------------------------------------------------------- #
# The same calls through both tracers
# --------------------------------------------------------------------- #


def _script(tr, seed: int) -> tuple:
    """A seeded script of tracer calls; (events, dropped)."""
    rng = np.random.default_rng(seed)
    tr.enable(8)
    tr.clear()
    with tr.trace_context(query_id=int(rng.integers(1, 99))):
        for i in range(int(rng.integers(3, 7))):
            with tr.span("script.outer", i=i):
                with tr.trace_context(stage=f"s{i % 2}"):
                    with tr.span("script.inner", k=int(rng.integers(9))):
                        pass
                tr.event("script.instant", v=float(rng.random()))
        tr.record_complete("script.timed", time.perf_counter_ns(), 2000,
                           what="pre")
        ctx = tr.current_context()

    def worker(name: str, n: int) -> None:
        with tr.attach_context(ctx), tr.trace_context(task=name):
            for j in range(n):
                if j % 3:
                    tr.event("script.worker", j=j)
                else:
                    with tr.span("script.work", j=j):
                        pass
        tr.event("script.detached")

    for t in range(3):
        th = threading.Thread(target=worker, name=f"script-{t}",
                              args=(f"w{t}", int(rng.integers(2, 15))))
        th.start()
        th.join()
    events = tr.snapshot()
    dropped = tr.TRACER.dropped()
    tr.disable()
    return events, dropped


def _per_thread(events) -> dict:
    out: dict = {}
    for e in events:
        out.setdefault(e.thread_name, []).append((e.name, e.ph, e.attrs))
    return out


def _strip(doc: dict) -> list:
    return [{k: v for k, v in ev.items()
             if k not in ("ts", "dur", "pid", "tid")}
            for ev in doc["traceEvents"]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_script_same_events_and_chrome_trace(seed):
    jev, jdrop = _script(JT, seed)
    pev, pdrop = _script(PT, seed)
    assert jdrop == pdrop and pdrop > 0  # the rings of 8 overflowed
    assert _per_thread(pev) == _per_thread(jev)
    assert all(len(v) <= 8 for v in _per_thread(pev).values())
    assert _strip(PX.chrome_trace(pev)) == _strip(JX.chrome_trace(jev))


def test_a_finished_threads_ring_stays_readable():
    PT.enable()
    PT.clear()
    t = threading.Thread(target=lambda: PT.event("gone.thread"),
                         name="gone")
    t.start()
    t.join()
    assert not t.is_alive()
    assert [e.name for e in PT.snapshot()
            if e.thread_name == "gone"] == ["gone.thread"]


def test_tracing_off_records_nothing():
    PT.disable()
    PT.clear()
    with PT.span("off.span"):
        PT.event("off.event")
    PT.record_complete("off.timed", time.perf_counter_ns(), 1)
    assert PT.snapshot() == []
    assert PT.span("x") is PT.span("y")  # the one shared no-op


def test_sync_conf_ownership_rule():
    """A conf-enabled tracer is turned off only by the conf that turned
    it on; a programmatic enable() survives every conf."""
    on, off = C.TorchConf({C.TRACE_ENABLED: True}), C.TorchConf()
    PT.disable()
    PT.sync_conf(on)
    assert PT.is_enabled()
    PT.sync_conf(off)
    assert PT.is_enabled()
    PT.sync_conf(on.set(C.TRACE_ENABLED, False))
    assert not PT.is_enabled()
    PT.enable()
    PT.sync_conf(C.TorchConf({C.TRACE_ENABLED: False}))
    assert PT.is_enabled()


def test_export_trace_writes_parsable_json(tmp_path):
    PT.enable()
    PT.clear()
    with PT.trace_context(query_id=3):
        with PT.span("x.span", a=1):
            PT.event("x.event")
    path = TorchSession.export_trace(str(tmp_path / "t.json"))
    doc = json.loads(open(path).read())
    names = [e["name"] for e in doc["traceEvents"]]
    assert "x.span" in names and "x.event" in names
    assert doc["displayTimeUnit"] == "ms"


# --------------------------------------------------------------------- #
# span_stats
# --------------------------------------------------------------------- #


def _synthetic(TraceEvent, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(300):
        ts = int(rng.integers(0, 10**6))
        out.append(TraceEvent(
            f"exec.op{i % 4}", "X" if rng.random() < 0.85 else "i", ts,
            int(rng.integers(0, 5000)), int(rng.integers(1, 5)), "t",
            {"op": f"op{int(rng.integers(4))}",
             "query_id": int(rng.integers(1, 3)),
             "stage": f"s{int(rng.integers(3))}"}))
    return out


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("attr,query_id", [("op", None), ("op", 1),
                                           ("stage", 2)])
def test_span_stats_matches_jax(seed, attr, query_id):
    got = PX.span_stats(_synthetic(PT.TraceEvent, seed), query_id, attr)
    want = JX.span_stats(_synthetic(JT.TraceEvent, seed), query_id, attr)
    assert got == want and got


@pytest.mark.parametrize("seed", [5, 6])
def test_union_matches_jax(seed):
    rng = np.random.default_rng(seed)
    iv = [(int(s), int(s + d)) for s, d in zip(
        rng.integers(0, 10**5, 50), rng.integers(0, 4000, 50))]
    assert PX._union_ns(list(iv)) == JX._union_ns(list(iv))


# --------------------------------------------------------------------- #
# Traced queries against the JAX package's names and results
# --------------------------------------------------------------------- #


def _jax_q3ds(session, dd, ss_paths, item):
    """The port's TPC-DS q3, written against the JAX session."""
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
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    (d / "q1").mkdir()
    (d / "q3").mkdir()
    q1 = tpch.make_lineitem(str(d / "q1"), n_files=3, with_q1_cols=True,
                            rows_per_file=4096)
    li = tpch.make_lineitem(str(d / "q3"), n_files=3, with_orderkey=True,
                            n_orders=2048, rows_per_file=4096)
    orders = tpch.make_orders(str(d / "q3"), n_orders=2048)
    cat = tpcds_schema.generate(0.5, seed=7)
    dd, item = str(d / "date_dim.parquet"), str(d / "item.parquet")
    pq.write_table(cat["date_dim"], dd)
    pq.write_table(cat["item"], item)
    ss = cat["store_sales"]
    per = -(-ss.num_rows // 3)
    ssp = []
    for i in range(3):
        p = str(d / f"store_sales-{i}.parquet")
        pq.write_table(ss.slice(i * per, per), p)
        ssp.append(p)
    return {"q1": (q1,), "q3": (li, orders), "q3_wire": (li, orders),
            "q3ds": (dd, ssp, item)}


#: query -> (keys, port DataFrame, JAX DataFrame); q3 with broadcast off
#: plans its partition-wise join in both packages
QUERIES = {
    # q1 with speculation off: on, its warm second run reads no count
    # blocking, so it records no pipe.readback span (the JAX run's come
    # from its drain's batched read); tests/test_torch_speculation.py
    # holds the speculated run's names
    "q1": ({TTB: 1, C.SPECULATION_ENABLED: False}, tpch.q1_dataframe,
           bench.q1_dataframe),
    "q3": ({TTB: 1, C.BROADCAST_THRESHOLD: -1}, tpch.q3_dataframe,
           bench.q3_dataframe),
    "q3ds": ({TTB: 1}, tpcds.q3_dataframe, _jax_q3ds),
    # the wire path with compression: the wire.compress and
    # wire.decompress spans (the JAX package's default upload is packed)
    "q3_wire": ({TTB: 1, C.BROADCAST_THRESHOLD: -1, C.PACKED_UPLOAD: True,
                 C.WIRE_COMPRESSION: True}, tpch.q3_dataframe,
                bench.q3_dataframe),
}


def _significant(table: pa.Table, digits: int = 12) -> pa.Table:
    """Float columns to ``digits`` significant digits: the engines sum
    in different orders (as in test_torch_q1 / test_torch_q3)."""
    cols = []
    for c in table.columns:
        if pa.types.is_floating(c.type):
            c = pa.array([None if v is None else float(f"{v:.{digits - 1}e}")
                          for v in c.to_pylist()], c.type)
        cols.append(c)
    return pa.Table.from_arrays(cols, names=table.schema.names)


@pytest.fixture(scope="module")
def jax_side(data):
    """Per query: both JAX engines' results and the folded names of a
    traced (second) run of its device engine."""
    out = {}
    conf = get_conf()
    saved = dict(conf._values)
    try:
        for name, (keys, _port, jfn) in QUERIES.items():
            conf._values.clear()
            conf._values.update(saved)
            for k, v in keys.items():
                conf.set(k, v)
            set_conf(conf)
            df = jfn(TpuSession(conf), *data[name])
            res = {e: df.collect(engine=e) for e in ("tpu", "cpu")}
            JT.enable()
            JT.clear()
            try:
                df.collect(engine="tpu")
                events = JT.snapshot()
            finally:
                JT.disable()
                JT.clear()
            out[name] = (res, {fold(e.name) for e in events})
    finally:
        conf._values.clear()
        conf._values.update(saved)
        set_conf(conf)
    return out


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_traced_query_matches_untraced_jax_names_and_ids(query, data,
                                                         jax_side):
    keys, port_fn, _jfn = QUERIES[query]
    s = TorchSession(keys, device="cpu")
    df = port_fn(s, *data[query])
    untraced = df.collect()
    PT.enable()
    PT.clear()
    try:
        traced = df.collect()
        REAPER.flush()
        events = PT.snapshot()
    finally:
        PT.disable()
    assert traced.equals(untraced)
    results, jax_names = jax_side[query]
    for engine, want in results.items():
        assert_tables_equal(_significant(traced), _significant(want),
                            ignore_order=query == "q1", approx_float=True)
    names = {fold(e.name) for e in events}
    drop = lambda ns: {n for n in ns  # noqa: E731
                       if n not in TIMING and not n.startswith(UNPORTED)}
    assert drop(names) == drop(jax_names)
    # the names a port run lacks are the unported layers' only
    assert {n for n in jax_names - names if n not in TIMING} <= {
        n for n in jax_names if n.startswith(UNPORTED)}
    qids = {e.attrs["query_id"] for e in events if e.name == "query.execute"}
    assert len(qids) == 1
    qid = qids.pop()
    pool = [e for e in events if e.thread_name.startswith(POOL_THREADS)]
    assert pool and all(e.attrs.get("query_id") == qid for e in pool)
    if query != "q1":
        assert "rf.apply" in names and "rf.build" in names
    if query == "q3_wire":
        assert {"wire.compress", "wire.decompress"} <= names & jax_names


# --------------------------------------------------------------------- #
# The serving tier's spans and events
# --------------------------------------------------------------------- #


@pytest.fixture
def _isolate_serving():
    for reset in (scheduler_mod.reset, K.reset, ws.reset,
                  clear_serving_context, TpuSemaphore.reset):
        reset()
    yield
    for reset in (scheduler_mod.reset, K.reset, ws.reset,
                  clear_serving_context, TpuSemaphore.reset):
        reset()


def _table(n: int, seed: int = 11) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, 64, n).astype(np.int64),
                     "v": rng.integers(0, 1000, n).astype(np.int64)})


def _agg(df):
    return df.group_by(col("k")).agg((sum_(col("v")), "sv")).order_by(
        col("k"))


def test_serving_run_records_the_serving_names(tmp_path, _isolate_serving):
    p = str(tmp_path / "t.parquet")
    pq.write_table(_table(6000), p)
    PT.enable()
    PT.clear()
    try:
        # admission and a cross-query result-cache hit
        s = TorchSession({C.SERVING_MAX_CONCURRENT: 2,
                          C.SHARING_ENABLED: True}, device="cpu")
        first = _agg(s.read_parquet(p)).collect()
        assert _agg(s.read_parquet(p)).collect().equals(first)
        # a deadline passed mid-flight: the request, then the unwind
        slow = TorchSession({C.BATCH_ROWS: 128, C.SHUFFLE_PARTITIONS: 4,
                             C.SERVING_MAX_CONCURRENT: 1,
                             C.DEADLINE_MS: 20.0}, device="cpu")
        with pytest.raises(K.QueryCancelled):
            _agg(slow.create_dataframe(_table(60000))).collect()
        # a deadline passed before admission: shed
        shed = TorchSession({C.SERVING_MAX_CONCURRENT: 2,
                             C.DEADLINE_MS: 1e-4}, device="cpu")
        with pytest.raises(K.QueryCancelled):
            _agg(shed.create_dataframe(_table(100))).collect()
        # a failing tenant trips its breaker, then is quarantined
        bad_path = str(tmp_path / "gone.parquet")
        pq.write_table(_table(10), bad_path)
        bad = TorchSession({C.SERVING_MAX_CONCURRENT: 2,
                            C.BREAKER_THRESHOLD: 1,
                            C.BREAKER_COOLDOWN_MS: 60000.0}, device="cpu",
                           tenant="poison")
        poison = bad.read_parquet(bad_path)
        import os

        os.remove(bad_path)
        with pytest.raises(OSError):
            poison.collect()
        with pytest.raises(K.TenantQuarantined):
            poison.collect()
        events = PT.snapshot()
    finally:
        PT.disable()
    names = {e.name for e in events}
    want = {"serve.admit", "cancel.request", "cancel.unwind",
            "breaker.trip", "breaker.quarantined", "cancel.shed",
            "serve.result_cache_hit"}
    assert want <= names, want - names
    hit = next(e for e in events if e.name == "serve.result_cache_hit")
    assert hit.attrs["rows"] == first.num_rows
