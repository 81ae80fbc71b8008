"""The port's event log (``spark_rapids_tpu_torch/eventlog/``) and its
history tool (``tools/history.py``) on the CPU, held against the JAX
package's (``spark_rapids_tpu/eventlog/``, ``tools/history.py``).

Counterparts of ``tests/test_eventlog.py`` (but its two tests of the
JAX bench, ``test_bench_round_ingest`` and
``test_bench_smoke_eventlog_matches_settled_metrics``): the frozen
record fields, forward compatibility, torn tails (plain and gzip), a
failed append, the compare / health / report / dot round trip, a chaos
run's recovered fault beside an unchanged digest, the disabled path,
the timestamps, spans and the trace sidecar, and ``explain("analyze")``'s
footers.  Besides: every record the port writes passes the JAX schema
too; the JAX tool reads a port log, and its health rules and regressions
are the port tool's; for one plan the records' per-operator
``numOutputRows`` are the JAX package's.  The same seeded tables go
through both engines (``device="cpu"`` for the port, the JAX CPU
backend)."""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.config import get_conf
from spark_rapids_tpu.eventlog.schema import validate_record as jvalidate
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import sum_ as jsum
from spark_rapids_tpu.tools import history as JH

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession, col, sum_
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.eventlog.reader import iter_records, read_log
from spark_rapids_tpu_torch.tools import history as PH
from torch_ops_isolation import ops_teardown, ops_threads


@pytest.fixture(autouse=True)
def _clean():
    yield
    ops_teardown()


def _session(tmp_path, **extra) -> TorchSession:
    conf = {C.EVENTLOG_ENABLED: True, C.EVENTLOG_DIR: str(tmp_path / "log")}
    conf.update(extra)
    return TorchSession(conf, device="cpu")


def _table(n: int = 512, seed: int = 7) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, 16, n).astype(np.int64),
        "v": rng.integers(0, 1000, n).astype(np.int64),
    })


def _agg(session, t: pa.Table, c=col, s=sum_):
    return (session.create_dataframe(t).group_by(c("k"))
            .agg((s(c("v")), "sv")).order_by(c("k")))


def _filter(session, t: pa.Table, c=col):
    return session.create_dataframe(t).where(c("v") > 10).select(c("k"))


def _drain(session) -> str:
    """Reading ``history.events`` waits for the worker's appends."""
    _ = session.history.events
    return session.event_log_path


#: the record fields, as the JAX test freezes them
GOLDEN_HEADER_FIELDS = frozenset({
    "type", "schema_version", "ts", "session", "pid", "env", "conf",
    "conf_hash", "mesh"})
GOLDEN_QUERY_FIELDS = frozenset({
    "type", "schema_version", "query_id", "plan", "plan_hash",
    "engine", "wall_s", "start_ts", "end_ts", "start_ns", "end_ns",
    "conf_hash", "counters", "operators", "spans", "pipeline",
    "faults", "serving", "sharing", "connect", "programs",
    "result_digest", "rows", "trace_file"})


def test_schema_golden_every_record_validates_in_both_packages(tmp_path):
    from spark_rapids_tpu.eventlog import MONOTONIC_COUNTERS as JMONO
    from spark_rapids_tpu_torch.eventlog import MONOTONIC_COUNTERS
    from spark_rapids_tpu_torch.eventlog.schema import SCHEMA_VERSION

    s = _session(tmp_path)
    t = _table()
    _agg(s, t).collect()
    _filter(s, t).collect()
    path = _drain(s)
    recs = list(iter_records(path, strict=True))
    assert [r["type"] for r in recs] == ["header", "query", "query"]
    for r in recs:
        jvalidate(r)
    hdr, q1, q2 = recs
    assert set(hdr) == GOLDEN_HEADER_FIELDS, set(hdr)
    assert set(q1) == set(q2) == GOLDEN_QUERY_FIELDS, set(q1)
    assert hdr["schema_version"] == SCHEMA_VERSION == 1
    assert hdr["conf"][C.EVENTLOG_ENABLED] == "True"
    assert hdr["env"]["torch"] and hdr["env"]["devices"]
    assert hdr["mesh"] is None
    assert q1["query_id"] != q2["query_id"]
    assert q1["plan_hash"] != q2["plan_hash"]
    assert q1["conf_hash"] == hdr["conf_hash"]
    assert MONOTONIC_COUNTERS == JMONO
    for key in MONOTONIC_COUNTERS:
        assert key in q1["counters"], key
    # the counter and gauge keys of a record are the JAX record's
    from spark_rapids_tpu.eventlog import counters_snapshot as jsnap
    from spark_rapids_tpu_torch.eventlog import counters_snapshot

    assert set(counters_snapshot()) == set(jsnap())


def test_forward_compat_unknown_fields_and_types(tmp_path):
    from spark_rapids_tpu_torch.eventlog.schema import validate_record

    s = _session(tmp_path)
    _agg(s, _table()).collect()
    path = _drain(s)
    future = str(tmp_path / "future.jsonl")
    with open(path) as f, open(future, "w") as out:
        for line in f:
            rec = json.loads(line)
            rec["future_field"] = {"from": "a newer writer"}
            out.write(json.dumps(rec) + "\n")
        out.write(json.dumps({"type": "gc_hint", "v": 1}) + "\n")
    recs = list(iter_records(future))
    assert [r["type"] for r in recs] == ["header", "query"]
    assert recs[1]["future_field"] == {"from": "a newer writer"}
    for r in recs:
        validate_record(r)
    header, queries = read_log(future)
    assert header is not None and len(queries) == 1


def test_corrupt_trailing_line_is_dropped(tmp_path):
    s = _session(tmp_path)
    _agg(s, _table()).collect()
    path = _drain(s)
    with open(path, "a") as f:
        f.write('{"type": "query", "torn mid-')
    header, queries = read_log(path)
    assert header is not None and len(queries) == 1


def test_torn_trailing_gzip_member_keeps_prefix(tmp_path):
    s = _session(tmp_path, **{C.EVENTLOG_COMPRESS: True})
    _agg(s, _table()).collect()
    path = _drain(s)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 7)
    header, queries = read_log(path)
    assert header is not None
    assert len(queries) <= 1


def test_failed_append_warns_but_does_not_poison_history(
        tmp_path, monkeypatch):
    from spark_rapids_tpu_torch.eventlog import EventLogWriter

    s = _session(tmp_path)

    def boom(self, rec):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(EventLogWriter, "append", boom)
    with pytest.warns(RuntimeWarning, match="on_event hook failed"):
        out = _agg(s, _table()).collect()
        events = s.history.events
    assert out.num_rows > 0
    assert len(events) == 1
    monkeypatch.undo()
    _agg(s, _table()).collect()
    header, queries = read_log(_drain(s))
    assert header is not None and len(queries) == 1


def test_compressed_log_roundtrip(tmp_path):
    s = _session(tmp_path, **{C.EVENTLOG_COMPRESS: True})
    assert s.event_log_path.endswith(".jsonl.gz")
    _agg(s, _table()).collect()
    recs = list(iter_records(_drain(s), strict=True))
    assert [r["type"] for r in recs] == ["header", "query"]
    # the JAX reader takes the port's gzip members too
    from spark_rapids_tpu.eventlog.reader import read_log as jread

    header, queries = jread(s.event_log_path, strict=True)
    assert header is not None and len(queries) == 1


# ------------------------------------------------------------------ #
# compare / health / report / dot
# ------------------------------------------------------------------ #


def _two_runs(tmp_path):
    """A real two-query port log, and a copy with a 2.2x slowdown on
    every query and its last one degraded to the CPU engine."""
    s = _session(tmp_path)
    t = _table()
    _agg(s, t).collect()
    _filter(s, t).collect()
    log_a = _drain(s)
    log_b = str(tmp_path / "runB.jsonl")
    recs = list(iter_records(log_a))
    last_qid = recs[-1]["query_id"]
    with open(log_b, "w") as f:
        for r in recs:
            if r["type"] == "query":
                r = dict(r)
                r["wall_s"] *= 2.2
                if r["query_id"] == last_qid:
                    r["engine"] = "cpu_fallback"
                    r["counters"] = dict(
                        r["counters"], **{"retry.cpu_fallbacks": 1})
            f.write(json.dumps(r) + "\n")
    return log_a, log_b


def test_compare_flags_synthetic_slowdown(tmp_path):
    log_a, log_b = _two_runs(tmp_path)
    apps = [PH.load_application(log_a), PH.load_application(log_b)]
    result = PH.compare_applications(apps, threshold=1.25)
    assert len(result["rows"]) == 2
    assert all(r["flag"] == "regression" for r in result["rows"])
    assert not result["unmatched"]
    assert not PH.compare_applications(apps, threshold=3.0)["regressions"]


def test_health_flags_cpu_fallback_run(tmp_path):
    log_a, log_b = _two_runs(tmp_path)
    clean = PH.health_check(PH.load_application(log_a))
    assert not any(f.severity == "error" for f in clean), clean
    findings = PH.health_check(PH.load_application(log_b))
    assert any(f.rule == "HC001" and f.severity == "error"
               for f in findings), findings


def test_jax_tool_reads_a_port_log_with_the_same_verdicts(tmp_path):
    """The JAX ``load_application`` reads the port's logs; its health
    rules and its compare give the port tool's rule ids and
    regressions."""
    log_a, log_b = _two_runs(tmp_path)
    for log in (log_a, log_b):
        papp, japp = PH.load_application(log), JH.load_application(log)
        assert japp.kind == "eventlog"
        assert [q.plan_hash for q in japp.queries] == \
            [q.plan_hash for q in papp.queries]
        assert sorted((f.rule, f.severity, f.query)
                      for f in PH.health_check(papp)) == \
            sorted((f.rule, f.severity, f.query)
                   for f in JH.health_check(japp))
    pres = PH.compare_applications(
        [PH.load_application(log_a), PH.load_application(log_b)])
    jres = JH.compare_applications(
        [JH.load_application(log_a), JH.load_application(log_b)])
    assert [(r["plan_hash"], r["flag"], r["ratio"])
            for r in pres["rows"]] == \
        [(r["plan_hash"], r["flag"], r["ratio"]) for r in jres["rows"]]
    assert len(pres["regressions"]) == len(jres["regressions"]) == 2


#: the health rules' triggers, as the JAX test builds them
RULE_CASES = {
    "HC002": ({"retry.splits": 2, "retry.task_retries": 1}, None),
    "HC003": ({"spill.device_to_host_bytes": 64 << 20}, None),
    "HC004": ({"jit.misses": 40}, None),
    "HC005": ({"pipeline.readbacks": 50}, None),
    "HC006": ({}, {"s": {"items": 64, "occupancy_fraction": 0.01}}),
    "HC007": ({"rf.filters_built": 1, "rf.pruned_rows": 0}, None),
    "HC008": ({"faults.recovered": 2}, None),
    "HC009": ({"serve.admit_wait_ms": 900.0}, None),
    "HC013": ({"cancel.breaker_trips": 1}, None),
    "HC014": ({"lock.max_hold_ms": 900.0}, None),
}


@pytest.mark.parametrize("rule", sorted(RULE_CASES))
def test_health_rule_fires_as_in_the_jax_tool(rule):
    counters, pipeline = RULE_CASES[rule]
    rec = {"query_id": 0, "plan": "", "plan_hash": "x", "engine": "tpu",
           "wall_s": 1.0, "counters": counters, "pipeline": pipeline}
    papp = PH.ApplicationInfo("x", "eventlog", {},
                              [PH._query_from_record(rec)])
    japp = JH.ApplicationInfo("x", "eventlog", {},
                              [JH._query_from_record(rec)])
    got = {f.rule for f in PH.health_check(papp)}
    assert rule in got, (rule, got)
    assert got == {f.rule for f in JH.health_check(japp)}


def test_healthy_record_and_conf_budgets():
    rec = PH._query_from_record({
        "query_id": 0, "plan": "", "plan_hash": "x", "engine": "tpu",
        "wall_s": 1.0, "counters": {"serve.admit_wait_ms": 900.0}})
    app = PH.ApplicationInfo("x", "eventlog", {}, [rec])
    assert {f.rule for f in PH.health_check(app)} == {"HC009"}
    roomy = C.TorchConf({C.SERVING_ADMIT_WAIT_BUDGET_MS: 1000.0})
    assert PH.health_check(app, roomy) == []
    healthy = PH.ApplicationInfo("x", "eventlog", {}, [
        PH._query_from_record({"query_id": 0, "plan": "",
                               "plan_hash": "x", "engine": "tpu",
                               "wall_s": 1.0, "counters": {}})])
    assert PH.health_check(healthy) == []


def test_report_cli_flags_regression_and_fallback(tmp_path, capsys):
    log_a, log_b = _two_runs(tmp_path)
    out = str(tmp_path / "report.md")
    assert PH.main(["report", log_a, log_b, "--threshold", "1.25",
                    "-o", out]) == 0
    text = open(out).read()
    assert text.startswith("# Fleet regression report")
    assert "REGRESSION" in text and "2.200x" in text
    assert "HC001" in text and "degraded to the CPU engine" in text
    assert "torch " in text  # the runtime column
    assert PH.main(["compare", log_a, log_b]) == 1
    capsys.readouterr()
    assert PH.main(["health", log_b]) == 1
    capsys.readouterr()


def test_dot_from_event_log(tmp_path, capsys):
    s = _session(tmp_path)
    _agg(s, _table()).collect()
    path = _drain(s)
    app = PH.load_application(path)
    dot = PH.generate_dot(app.queries[0])
    assert dot.startswith("digraph plan {") and "->" in dot
    assert "TpuHashAggregateExec" in dot and "rows=" in dot
    assert PH.main(["dot", path]) == 0
    assert "digraph plan {" in capsys.readouterr().out


# ------------------------------------------------------------------ #
# The records' operators against the JAX package's
# ------------------------------------------------------------------ #


def _rows_tree(node: dict) -> list:
    return [(node["desc"].split(" ", 1)[0].split("[", 1)[0],
             node["metrics"].get("numOutputRows"),
             node["metrics"].get("numOutputBatches"))] + [
        x for c in node.get("children", []) for x in _rows_tree(c)]


@pytest.mark.parametrize("query", ["agg", "filter"])
def test_operator_rows_equal_the_jax_package(tmp_path, query):
    """One plan through both engines with the log on: equal results,
    and each operator's ``numOutputRows`` in the port's record is the
    JAX record's (a JAX node fused into its parent counts no batch and
    is skipped)."""
    t = _table(2048, seed=13)
    conf = get_conf()
    conf.set("spark.rapids.tpu.eventLog.enabled", True)
    conf.set("spark.rapids.tpu.eventLog.dir", str(tmp_path / "jax"))
    js = TpuSession()
    ps = _session(tmp_path)
    if query == "agg":
        want = _agg(js, t, jcol, jsum).collect(engine="tpu")
        got = _agg(ps, t).collect()
    else:
        want = _filter(js, t, jcol).collect(engine="tpu")
        got = _filter(ps, t).collect()
    assert_tables_equal(got, want)
    _ = js.history.events
    (jrec,) = [r for r in iter_records(js.event_log_path)
               if r["type"] == "query"]
    (prec,) = [r for r in iter_records(_drain(ps))
               if r["type"] == "query"]
    assert prec["rows"] == jrec["rows"] == got.num_rows
    assert prec["result_digest"] and prec["engine"] == jrec["engine"]
    jtree, ptree = _rows_tree(jrec["operators"]), _rows_tree(prec["operators"])
    assert [op for op, _r, _b in ptree] == [op for op, _r, _b in jtree]
    assert ptree[0][1] == jtree[0][1] == got.num_rows
    for (op, prow, _pb), (_op, jrow, jb) in zip(ptree, jtree):
        if jb:
            assert prow == jrow, (op, prow, jrow)


# ------------------------------------------------------------------ #
# Chaos: a recovered fault, the same digest
# ------------------------------------------------------------------ #


def test_chaos_run_records_recovery_with_identical_digest(tmp_path):
    """An injected upload fault on the wire path
    (``sql.scan.packedUpload``) is absorbed: the chaos run's record
    counts it injected and recovered, and its digest and rows are the
    clean run's."""
    from spark_rapids_tpu_torch.robustness import faults

    t = _table(n=2048, seed=11)
    extra = {C.BATCH_ROWS: 256, C.PACKED_UPLOAD: True}
    clean = _session(tmp_path, **extra)
    _agg(clean, t).collect()
    clean_path = _drain(clean)
    chaos = _session(tmp_path / "chaos", **extra)
    faults.install("transfer.upload:nth=1", forced=True)
    try:
        _agg(chaos, t).collect()
    finally:
        faults.disarm()
    chaos_path = _drain(chaos)
    q_clean = PH.load_application(clean_path).queries[0]
    q_chaos = PH.load_application(chaos_path).queries[0]
    assert q_chaos.counter("faults.injected") >= 1
    assert q_chaos.counter("faults.recovered") >= 1
    assert q_chaos.faults["transfer.upload"]["recovered"] >= 1
    assert q_clean.counter("faults.injected") == 0
    assert q_clean.result_digest == q_chaos.result_digest
    assert q_clean.rows == q_chaos.rows
    assert q_clean.engine == q_chaos.engine == "tpu"
    assert "HC008" in {f.rule for f in PH.health_check(
        PH.load_application(chaos_path))}


# ------------------------------------------------------------------ #
# The disabled path
# ------------------------------------------------------------------ #


def test_disabled_is_zero_overhead(tmp_path, monkeypatch):
    """The log off (the default): no writer, no counter snapshot, no
    writer thread, no file."""
    import spark_rapids_tpu_torch.eventlog as EL

    assert C.DEFAULTS[C.EVENTLOG_ENABLED] is False
    calls = {"n": 0}
    real = EL.counters_snapshot

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(EL, "counters_snapshot", counting)
    s = TorchSession({C.EVENTLOG_DIR: str(tmp_path / "log")}, device="cpu")
    assert s._eventlog is None
    assert s.event_log_path is None
    out = _agg(s, _table()).collect()
    assert out.num_rows > 0
    assert len(s.history.events) == 1
    assert calls["n"] == 0, "the disabled path took a counter snapshot"
    assert not any("eventlog" in th.name.lower()
                   for th in threading.enumerate())
    assert not (tmp_path / "log").exists()


# ------------------------------------------------------------------ #
# Timestamps, spans, the sidecar
# ------------------------------------------------------------------ #


def test_history_event_timestamps_roundtrip_into_log(tmp_path):
    import time

    s = _session(tmp_path)
    _out, qid = _agg(s, _table())._collect()
    path = _drain(s)
    ev = next(e for e in s.history.events if e.query_id == qid)
    assert ev.start_ns > 0 and ev.end_ns >= ev.start_ns
    assert 0 < ev.start_ts <= ev.end_ts
    assert abs(ev.end_ts - time.time()) < 300
    assert ev.conf_hash
    _hdr, queries = read_log(path, strict=True)
    rec = next(r for r in queries if r["query_id"] == qid)
    for field in ("start_ts", "end_ts", "start_ns", "end_ns",
                  "conf_hash"):
        assert rec[field] == getattr(ev, field), field


def test_spans_and_trace_sidecar_recorded(tmp_path):
    from spark_rapids_tpu_torch import trace

    s = _session(tmp_path, **{C.EVENTLOG_TRACE_SIDECAR: True})
    trace.enable()
    try:
        _agg(s, _table()).collect()
        path = _drain(s)
    finally:
        trace.disable()
        trace.clear()
    _hdr, (rec,) = read_log(path, strict=True)
    assert rec["spans"], "span stats missing with tracing on"
    assert any(op.startswith("Tpu") for op in rec["spans"]), rec["spans"]
    assert rec["trace_file"] and os.path.exists(rec["trace_file"])
    doc = json.load(open(rec["trace_file"]))
    assert doc["traceEvents"]


def test_telemetry_records_land_in_the_log(tmp_path):
    """``telemetry.eventLogEvery``: every Nth sampler tick is a
    ``telemetry`` record of the session's log, valid in both schemas."""
    import time

    s = _session(tmp_path, **{C.TELEMETRY_ENABLED: True,
                              C.TELEMETRY_HZ: 200.0,
                              C.TELEMETRY_LOG_EVERY: 2})
    _agg(s, _table()).collect()
    deadline = time.monotonic() + 10
    tele = []
    while not tele and time.monotonic() < deadline:
        time.sleep(0.05)
        tele = [r for r in iter_records(_drain(s), strict=True)
                if r["type"] == "telemetry"]
    assert tele, "no telemetry record"
    jvalidate(tele[0])
    assert "queries.in_flight" in tele[0]["counters"]
    app = PH.load_application(s.event_log_path)
    assert app.telemetry and app.queries


# ------------------------------------------------------------------ #
# explain("analyze")'s footers
# ------------------------------------------------------------------ #


def test_explain_analyze_footer_has_recovery_and_rf_counters():
    s = TorchSession(device="cpu")
    out = _agg(s, _table()).explain("analyze")
    assert "jit cache:" in out
    assert "retry: splits=0" in out, out
    assert "cpu_fallbacks=0" in out
    assert "recovered_faults=0" in out
    assert "runtime filters: built=0" in out
    # the root's rows are the result's
    assert "rows=16" in out.splitlines()[1]


def test_explain_analyze_footer_counts_recovered_faults():
    from spark_rapids_tpu_torch.robustness import faults

    s = TorchSession({C.PACKED_UPLOAD: True}, device="cpu")
    df = _agg(s, _table(seed=23))
    faults.install("transfer.upload:nth=1", forced=True)
    try:
        out = df.explain("analyze")
    finally:
        faults.disarm()
    assert "recovered_faults=1" in out, out


def test_explain_modes():
    s = TorchSession(device="cpu")
    df = _agg(s, _table())
    assert df.explain() == df.explain("simple")
    with pytest.raises(ValueError, match="explain mode"):
        df.explain("cost")


def test_no_ops_thread_after_teardown(tmp_path):
    s = _session(tmp_path)
    _agg(s, _table()).collect()
    _drain(s)
    ops_teardown()
    assert ops_threads() == []
