"""The port's live ops plane (``spark_rapids_tpu_torch/obs/``) on the CPU,
held against the JAX package's (``spark_rapids_tpu/obs/``).

Counterparts of ``tests/test_obs.py``: off by default (no thread, no
socket, no registry entry); the ops smoke (a scrape of ``/metrics``,
parsed by the JAX ``obs.metrics.parse_openmetrics``, equals the event
log's ``counters_snapshot`` and has the JAX scrape's family names;
``/queries`` empties after the query; the owning conf's off leaves no
``srt-obs-*`` thread and a refused socket); an in-flight stream under
``/queries`` and ``/queries/<id>``; scrapes during running queries never
see a counter fall and change no result; and an SLO breach that lands
in the event log as an ``slo`` record, which both packages' history
tools flag as HC016."""

from __future__ import annotations

import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.obs import metrics as JM
from spark_rapids_tpu.tools import history as JH

from spark_rapids_tpu_torch import TorchSession, col, obs, sum_
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.eventlog import MONOTONIC_COUNTERS, table_digest
from spark_rapids_tpu_torch.obs import metrics as PM
from spark_rapids_tpu_torch.obs.slo import WATCHDOG
from spark_rapids_tpu_torch.tools import history as PH
from torch_ops_isolation import ops_teardown


@pytest.fixture(autouse=True)
def _clean():
    yield
    ops_teardown()


def _obs_threads() -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.name.startswith("srt-obs")]


def _table(n: int = 4096, seed: int = 0x0B5) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, 16, n).astype(np.int64),
        "v": rng.integers(0, 1000, n).astype(np.int64),
    })


def _agg(session, t: pa.Table):
    return (session.create_dataframe(t).group_by(col("k"))
            .agg((sum_(col("v")), "sv")).order_by(col("k")))


def _get(url: str) -> str:
    return urllib.request.urlopen(url, timeout=10).read().decode()


def test_disabled_by_default_no_thread_no_registry():
    s = TorchSession(device="cpu")
    assert _agg(s, _table()).collect().num_rows == 16
    assert not obs.is_enabled()
    assert obs.plane().port is None
    assert obs.REGISTRY.count() == 0
    assert not obs.REGISTRY.enabled
    assert _obs_threads() == []


def test_ops_smoke():
    """The conf turns the plane on; a scrape parses with the JAX parser
    and its counters are ``counters_snapshot``'s; the JAX plane's family
    names are all there; the registry empties; the conf's off stops
    it."""
    from spark_rapids_tpu.eventlog import counters_snapshot as jsnap

    from spark_rapids_tpu_torch.eventlog import counters_snapshot

    on = C.TorchConf({C.OBS_ENABLED: True, C.OBS_PORT: 0})
    s = TorchSession(on, device="cpu")
    assert _agg(s, _table()).collect().num_rows == 16
    assert obs.is_enabled() and obs.plane().port
    port = obs.plane().port
    text = _get(f"http://127.0.0.1:{port}/metrics")
    assert text.endswith("# EOF\n")
    parsed = JM.parse_openmetrics(text)
    assert parsed == PM.parse_openmetrics(text)
    snap = counters_snapshot()
    for key in MONOTONIC_COUNTERS:
        name = PM.counter_metric_name(key)
        assert parsed[name]["type"] == "counter", name
        # monotone: the scrape came first, nothing ran since
        assert JM.scrape_value(parsed, name) == snap[key], key
    want = {JM.counter_metric_name(k) if k in MONOTONIC_COUNTERS
            else JM.metric_name(k) for k in jsnap()}
    assert want <= set(parsed)
    assert JM.scrape_value(parsed, "tpu_queries_in_flight") == 0
    assert json.loads(_get(f"http://127.0.0.1:{port}/queries")) == []
    # the owning conf's off: no thread, the port refuses
    s2 = TorchSession(C.TorchConf(), device="cpu")
    _agg(s2, _table()).collect()
    assert obs.is_enabled(), "another session's defaults stopped it"
    on.set(C.OBS_ENABLED, False)
    _agg(s, _table()).collect()
    assert not obs.is_enabled()
    assert _obs_threads() == []
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2).close()


def test_live_registry_visible_mid_stream():
    obs.start(port=0)
    s = TorchSession({C.BATCH_ROWS: 512}, device="cpu", tenant="streamer")
    pq = s.prepare(_agg(s, _table()))
    gen = pq.execute_stream(batch_rows=4)
    first = next(gen)
    assert first.num_rows > 0
    assert obs.REGISTRY.count() == 1
    (entry,) = obs.REGISTRY.snapshot()
    qid = entry["query_id"]
    assert entry["tenant"] == "streamer"
    assert entry["batches"] >= 1 and entry["elapsed_ms"] >= 0
    assert entry["cancel"]["tenant"] == "streamer"
    assert "plan" not in entry
    base = f"http://127.0.0.1:{obs.plane().port}"
    assert [e["query_id"] for e in json.loads(_get(base + "/queries"))] \
        == [qid]
    one = json.loads(_get(base + f"/queries/{qid}"))
    assert one["query_id"] == qid and one["plan"] and one["plan_hash"]
    rest = list(gen)
    assert first.num_rows + sum(b.num_rows for b in rest) == 16
    assert obs.REGISTRY.count() == 0
    assert json.loads(_get(base + "/queries")) == []
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base + f"/queries/{qid}")
    assert ei.value.code == 404
    assert _get(base + "/healthz") == "ok\n"
    obs.stop()
    assert _obs_threads() == []


def test_cancel_through_the_plane():
    """``POST /queries/<id>/cancel`` cancels a stream in flight: its
    next pull raises, and the registry empties."""
    from spark_rapids_tpu_torch.serving.cancel import QueryCancelled

    obs.start(port=0)
    s = TorchSession({C.BATCH_ROWS: 256}, device="cpu")
    gen = s.create_dataframe(_table()).select(col("k"))._stream(
        batch_rows=8)
    next(gen)
    (entry,) = obs.REGISTRY.snapshot()
    req = urllib.request.Request(
        f"http://127.0.0.1:{obs.plane().port}/queries/"
        f"{entry['query_id']}/cancel", method="POST", data=b"")
    assert json.loads(urllib.request.urlopen(req, timeout=10).read())[
        "cancelled"] is True
    with pytest.raises(QueryCancelled):
        for _ in gen:
            pass
    assert obs.REGISTRY.count() == 0


def test_scrape_under_storm_monotone_and_zero_impact():
    t = _table()
    ref = table_digest(_agg(TorchSession(device="cpu"), t).collect())
    assert not obs.is_enabled()
    obs.start(port=0)
    stop = threading.Event()
    violations: list = []
    scrapes = [0]
    digests: list = []
    errors: list = []

    def scraper() -> None:
        base = f"http://127.0.0.1:{obs.plane().port}"
        prev: dict = {}
        while True:
            try:
                parsed = JM.parse_openmetrics(_get(base + "/metrics"))
            except Exception as e:  # noqa: BLE001 - reported
                errors.append(repr(e))
                return
            for key in MONOTONIC_COUNTERS:
                v = JM.scrape_value(parsed, JM.counter_metric_name(key))
                if v is None:
                    continue
                if key in prev and v < prev[key]:
                    violations.append((key, prev[key], v))
                prev[key] = v
            scrapes[0] += 1
            if stop.wait(0.005):
                return

    def worker() -> None:
        try:
            s = TorchSession(device="cpu")
            for _ in range(2):
                digests.append(table_digest(_agg(s, t).collect()))
        except BaseException as e:  # noqa: BLE001 - reported
            errors.append(repr(e))

    ths = [threading.Thread(target=worker) for _ in range(2)]
    sth = threading.Thread(target=scraper)
    sth.start()
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    stop.set()
    sth.join()
    assert not errors, errors
    assert scrapes[0] >= 1
    assert not violations, violations
    assert set(digests) == {ref}
    obs.stop()
    assert _obs_threads() == []


def test_slo_breach_lands_in_eventlog_and_hc016(tmp_path):
    from spark_rapids_tpu_torch.eventlog.reader import iter_records

    conf = C.TorchConf({C.OBS_ENABLED: True, C.OBS_PORT: 0,
                        C.SLO_WALL_BUDGET_MS: 0.001,
                        # the test drives evaluate_now() itself
                        C.SLO_INTERVAL_MS: 600000.0,
                        C.EVENTLOG_ENABLED: True,
                        C.EVENTLOG_DIR: str(tmp_path / "log")})
    s = TorchSession(conf, device="cpu", tenant="slower")
    _agg(s, _table()).collect()
    assert s.history.events[-1].query_id is not None
    breaches = WATCHDOG.evaluate_now()
    assert breaches, "a 0.001 ms budget did not breach"
    b = breaches[0]
    assert b["tenant"] == "slower" and b["metric"] == "wall_p99_ms"
    assert b["observed_ms"] > b["budget_ms"] == 0.001
    snap = WATCHDOG.snapshot()
    assert snap["budgets"]["wall_p99_ms"] == 0.001
    assert snap["breach_count"] >= 1 and snap["tenants"]["slower"]["n"] >= 1
    wire = json.loads(_get(f"http://127.0.0.1:{obs.plane().port}/slo"))
    assert wire["breach_count"] >= 1
    recs = list(iter_records(s.event_log_path, strict=True))
    slo = [r for r in recs if r["type"] == "slo"]
    assert slo and slo[0]["tenant"] == "slower"
    for tool in (PH, JH):
        app = tool.load_application(s.event_log_path)
        assert app.slo
        hc016 = [f for f in tool.health_check(app) if f.rule == "HC016"]
        assert hc016 and hc016[0].severity == "warning"
        assert "tenant:slower" in hc016[0].query
    conf.set(C.OBS_ENABLED, False)
    obs.sync_conf(conf)
    assert not obs.is_enabled()
    assert _obs_threads() == []
