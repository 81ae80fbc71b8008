"""The port's query history (``tools/profiling.py``, ``session.history``)
on the CPU, held against the JAX package's.

Counterparts of the history tests of ``tests/test_work_share.py``
(``test_cached_tree_records_per_execution_metric_deltas``,
``test_result_cache_hit_records_full_lifecycle``,
``test_hc012_result_cache_thrash_matrix``).  A prepared query's cached
tree is drained again by each execution; each recorded event must hold
that execution's own metrics, whatever the timing: its snapshot is taken
on the query's thread, before the next execution can start, in 20
executions of one test, collected and streamed.  Besides: the ring's
capacity, process-wide ids, ``snapshot_delta`` and the report, DOT and
analyze renders against the JAX functions on the same snapshots, and a
``device_trace`` capture."""

from __future__ import annotations

import json

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import count_star as jcount_star
from spark_rapids_tpu.session import sum_ as jsum
from spark_rapids_tpu.tools import history as JH
from spark_rapids_tpu.tools import profiling as JP

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession, col, sum_
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.eventlog import table_digest
from spark_rapids_tpu_torch.session import count_star, rand
from spark_rapids_tpu_torch.tools import history as PH
from spark_rapids_tpu_torch.tools import profiling as PP
from torch_ops_isolation import ops_teardown


@pytest.fixture(autouse=True)
def _clean():
    yield
    ops_teardown()


def _table(n=4096, keys=16, seed=7):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, keys, n).astype(np.int64),
        "v": rng.integers(0, 1000, n).astype(np.int64),
    })


def _agg_df(session, t, c=col, s=sum_, cs=count_star):
    return (session.create_dataframe(t).group_by(c("k"))
            .agg((s(c("v")), "sv"), (cs(), "n")).order_by(c("k")))


# ------------------------------------------------------------------ #
# Per-execution deltas of a cached tree
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("how", ["execute", "execute_stream"])
def test_cached_tree_records_each_executions_own_rows(how):
    """20 executions of one prepared query: every event's root reports
    the execution's own rows (16), never the tree's running total, and
    every operator's rows are the first execution's."""
    t = _table()
    s = TorchSession({C.BATCH_ROWS: 1024}, device="cpu")
    prepared = s.prepare(_agg_df(s, t))
    js = TpuSession()
    want = _agg_df(js, t, jcol, jsum, jcount_star).collect(engine="tpu")
    digests = set()
    for _ in range(20):
        if how == "execute":
            out = prepared.execute()
        else:
            out = pa.Table.from_batches(list(prepared.execute_stream()))
        digests.add(table_digest(out))
    assert_tables_equal(out, want)
    assert len(digests) == 1
    events = s.history.events
    assert len(events) == 20

    def rows(ev):
        return [n.metrics["numOutputRows"] for n in PP._walk_snap(ev.root)]

    first = rows(events[0])
    assert first[0] == want.num_rows == 16
    assert first[-1] == t.num_rows  # the source read the table once
    for i, ev in enumerate(events):
        assert rows(ev) == first, \
            f"execution {i} reported {rows(ev)}, not its own {first}"


def test_cached_tree_under_threads_keeps_per_execution_rows():
    """Two threads executing one template: the drain lock serializes
    them, and each record still holds one execution's rows."""
    import threading

    t = _table(seed=3)
    s = TorchSession(device="cpu")
    prepared = s.prepare(_agg_df(s, t))
    errors = []

    def run():
        try:
            for _ in range(5):
                prepared.execute()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    ths = [threading.Thread(target=run) for _ in range(2)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    assert not errors, errors
    events = s.history.events
    assert len(events) == 10
    assert {e.root.metrics["numOutputRows"] for e in events} == {16}


def test_result_cache_hit_records_full_lifecycle(tmp_path):
    """A result served by the cache builds no tree, but its history
    event exists with the placeholder node, and its record round-trips
    the sharing verdict, the digest and the rows (read by the port's
    and the JAX tool alike)."""
    conf = {C.EVENTLOG_ENABLED: True, C.EVENTLOG_DIR: str(tmp_path),
            C.SHARING_ENABLED: True}
    s1 = TorchSession(conf, device="cpu", tenant="a")
    r1 = _agg_df(s1, _table()).collect()
    s2 = TorchSession(conf, device="cpu", tenant="b")
    r2 = _agg_df(s2, _table()).collect()
    assert table_digest(r1) == table_digest(r2)
    ev2 = s2.history.events[-1]
    assert ev2.root.desc == PP.PLACEHOLDER_DESC
    _ = s1.history.events
    for tool in (PH, JH):
        q1 = tool.load_application(s1.event_log_path).queries[-1]
        q2 = tool.load_application(s2.event_log_path).queries[-1]
        assert q1.sharing is not None \
            and q1.sharing["result_cache"] == "miss"
        assert q2.sharing is not None \
            and q2.sharing["result_cache"] == "hit"
        assert q2.counters.get("serve.result_cache_hit") == 1
        assert "share.result_hits" in q2.counters
        assert q2.result_digest == q1.result_digest
        assert q2.rows == r2.num_rows
        assert "ResultCacheHit" in q2.plan
    # a query that never touched the sharing tier records no section,
    # although the cache holds bytes
    s3 = TorchSession(conf, device="cpu", tenant="c")
    s3.create_dataframe(_table()).select(rand(7).alias("r")).collect()
    _ = s3.history.events
    q3 = PH.load_application(s3.event_log_path).queries[-1]
    assert q3.counter("share.result_bytes") > 0
    assert q3.sharing is None


def test_hc012_result_cache_thrash_matrix():
    def rules(tool, counters):
        rec = {"query_id": 0, "plan": "", "plan_hash": "x",
               "engine": "tpu", "wall_s": 1.0, "counters": counters}
        app = tool.ApplicationInfo("x", "eventlog", {},
                                   [tool._query_from_record(rec)])
        return {f.rule for f in tool.health_check(app)}

    cases = [
        ({"share.result_evictions": 6, "share.result_hits": 1,
          "share.result_misses": 9}, True),
        ({"share.result_evictions": 6, "share.result_hits": 9,
          "share.result_misses": 1}, False),
        ({"share.result_hits": 1, "share.result_misses": 9}, False),
        ({}, False),
    ]
    for counters, fires in cases:
        assert ("HC012" in rules(PH, counters)) == fires, counters
        assert rules(PH, counters) == rules(JH, counters)


# ------------------------------------------------------------------ #
# The ring, the ids, the renders
# ------------------------------------------------------------------ #


def test_ring_capacity_and_process_wide_ids():
    s1 = TorchSession({C.HISTORY_CAPACITY: 3}, device="cpu")
    s2 = TorchSession(device="cpu")
    t = _table(256)
    ids = []
    for _ in range(5):
        _out, qid = _agg_df(s1, t)._collect()
        ids.append(qid)
        ids.append(_agg_df(s2, t)._collect()[1])
    assert len(set(ids)) == 10 and ids == sorted(ids)
    assert [e.query_id for e in s1.history.events] == ids[4::2]
    assert len(s2.history.events) == 5
    with pytest.raises(ValueError):
        C.TorchConf({C.HISTORY_CAPACITY: 0})


def _snap(mod, rng):
    """A random three-node snapshot tree of ``mod``'s NodeSnapshot."""
    def node(desc, kids):
        return mod.NodeSnapshot(desc, {
            "numOutputRows": int(rng.integers(0, 1000)),
            "numOutputBatches": int(rng.integers(0, 9)),
            "totalTime": int(rng.integers(0, 10**8)),
            "specHits": int(rng.integers(0, 3)), "mode": "x"}, kids)

    return node("TpuSortExec [k]", [node(
        "TpuHashAggregateExec[complete] keys=[k]",
        [node("ArrowSourceExec [4096 rows]", [])])])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_snapshot_delta_and_renders_match_jax(seed):
    rng = np.random.default_rng(seed)
    pb, pa_ = _snap(PP, rng), _snap(PP, rng)
    rng = np.random.default_rng(seed)
    jb, ja = _snap(JP, rng), _snap(JP, rng)
    pd, jd = PP.snapshot_delta(pa_, pb), JP.snapshot_delta(ja, jb)
    assert [n.metrics for n in PP._walk_snap(pd)] == \
        [n.metrics for n in JP._walk_snap(jd)]
    pev = PP.QueryEvent(7, "plan", pd, 0.25, 0.0)
    jev = JP.QueryEvent(7, "plan", jd, 0.25, 0.0)
    assert PP.generate_dot(pev) == JP.generate_dot(jev)
    counters = {"retry": {"splits": 1, "spill_retries": 0,
                          "task_retries": 2, "cpu_fallbacks": 0},
                "faults_recovered": 1,
                "rf": {"filters_built": 1, "pruned_rows": 9,
                       "row_groups_pruned": 0},
                "plan_cache": {"hits": 1, "misses": 0, "evictions": 0}}
    cs = {"hits": 3, "misses": 1}
    assert PP.render_analyze(pev, cache_stats=cs, counters=counters) == \
        JP.render_analyze(jev, cache_stats=cs, counters=counters)
    assert PP.profile_query(pev, cache_stats=cs, counters=counters) == \
        JP.profile_query(jev, cache_stats=cs, counters=counters)


def test_profile_report_and_dot_of_a_session():
    s = TorchSession(device="cpu")
    _agg_df(s, _table(512)).collect()
    report = PP.profile_report(s.history)
    assert report.startswith("# Profile report")
    assert "queries: 1" in report and "TpuHashAggregateExec" in report
    dot = PP.generate_dot(s.history.events[0])
    assert dot.startswith("digraph plan {") and "rows=16" in dot


def test_explain_analyze_rows_equal_the_jax_package():
    t = _table(seed=5)
    s = TorchSession(device="cpu")
    out = _agg_df(s, t).explain("analyze")
    js = TpuSession()
    jout = _agg_df(js, t, jcol, jsum, jcount_star).explain("analyze")

    def rows(text):
        return [line.split(" rows=")[1].split()[0]
                for line in text.splitlines()
                if line.lstrip().startswith("+- ")]

    assert rows(out)[0] == rows(jout)[0] == "16"
    assert rows(out)[-1] == rows(jout)[-1] == str(t.num_rows)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    s = TorchSession(device="cpu")
    df = _agg_df(s, _table(512))
    with PP.device_trace(str(tmp_path / "trace")):
        df.collect()
    doc = json.load(open(tmp_path / "trace" / "trace.json"))
    assert doc["traceEvents"]
