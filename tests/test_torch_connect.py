"""The port's wire front door (``spark_rapids_tpu_torch/connect/``,
``tools/connect_client.py``) on the CPU, held against the JAX package's.

Counterparts of ``tests/test_connect.py`` (but ``test_bench_smoke_
connect``, which runs the JAX bench): a multi-frame round trip equal to a
collect; a client process that imports no torch and no engine module
gets the in-process digest; the command-line client; a wire deadline
that sheds in the admission queue with no device work and a
``deadline_exceeded`` record that keeps its ``connect`` section; a
dropped client cancelling its query; malformed and oversized frames and
translate errors leaving the server up; two tenants on two sockets
sharing the result cache; the wire trace id; the record's ``connect``
section.  Besides, the two packages on one wire: the JAX client against
the port's server and the port's client against the JAX server give the
digests of an in-process collect, for the same Substrait and SQL plans.
The servers run the port with ``device="cpu"``."""

from __future__ import annotations

import json
import socket
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest

from differential import assert_tables_equal
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.connect.client import (
    TAG_JSON,
    ConnectClient,
    ConnectError,
    recv_json,
    send_frame,
    table_digest,
)
from spark_rapids_tpu_torch.connect.server import ConnectServer
from spark_rapids_tpu_torch.eventlog.reader import iter_records
from spark_rapids_tpu_torch.frontends.sql import SqlSession
from spark_rapids_tpu_torch.frontends.substrait import SubstraitFrontend
from spark_rapids_tpu_torch.serving import scheduler as scheduler_mod
from torch_ops_isolation import SERVERS, ops_teardown

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean():
    ops_teardown()
    yield
    ops_teardown()


def _table(n=6000, seed=5):
    rng = np.random.default_rng(seed)
    strs = np.array(["alpha", "beta", "gamma", "delta", None], dtype=object)
    return pa.table({
        "k": rng.integers(0, 23, n).astype(np.int64),
        "v": rng.integers(0, 1000, n).astype(np.int64),
        "s": pa.array([strs[i % 5] for i in rng.integers(0, 5, n)]),
    })


def _server(conf=None, table=None) -> ConnectServer:
    srv = ConnectServer(conf=conf, device="cpu")
    srv.register_table("t", table if table is not None else _table())
    SERVERS.append(srv)
    return srv.start()


SQL = ("select k, s, count(*) as n, sum(v) as sv from t "
       "group by k, s order by k, s nulls last")

#: a Substrait read of the whole table
READ_PLAN = {"relations": [{"root": {
    "names": ["k", "v", "s"],
    "input": {"read": {"namedTable": {"names": ["t"]},
                       "baseSchema": {"names": ["k", "v", "s"]}}}}}]}


def _local_sql(t: pa.Table, text: str) -> pa.Table:
    fe = SqlSession(device="cpu")
    fe.register_table("t", t)
    return fe.sql(text).collect()


def _wait_for_record(log_dir, engine: str, timeout=10.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for path in sorted(Path(log_dir).glob("*.jsonl")):
            for rec in iter_records(str(path)):
                if rec.get("type") == "query" \
                        and rec.get("engine") == engine:
                    return rec
        time.sleep(0.1)
    raise AssertionError(f"no {engine!r} query record in {log_dir}")


# ------------------------------------------------------------------ #
# Round trips
# ------------------------------------------------------------------ #


def test_multibatch_roundtrip_equals_collect():
    t = _table()
    srv = _server(table=t)
    host, port = srv.address
    with ConnectClient(host, port, tenant="t1") as cli:
        got = cli.execute_sql(SQL, batch_rows=16)
    assert got.num_rows > 16
    want = _local_sql(t, SQL).combine_chunks()
    assert table_digest(got) == table_digest(want)
    from spark_rapids_tpu_torch.eventlog import table_digest as engine_td

    assert table_digest(want) == engine_td(want)


def test_external_client_process_imports_neither_torch_nor_the_engine(
        tmp_path):
    t = _table()
    srv = _server(table=t)
    host, port = srv.address
    plan_file = tmp_path / "plan.json"
    plan_file.write_text(json.dumps(READ_PLAN))
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from spark_rapids_tpu_torch.connect.client import "
        "ConnectClient, table_digest\n"
        f"plan = json.load(open({str(plan_file)!r}))\n"
        f"with ConnectClient({host!r}, {port}, tenant='ext') as cli:\n"
        "    t = cli.execute_plan(plan)\n"
        "print('DIGEST', table_digest(t), t.num_rows)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'spark_rapids_tpu') or (m.startswith("
        "'spark_rapids_tpu_torch.') and m.split('.')[1] not in "
        "('connect',))]\n"
        "print('BAD_MODULES', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert lines["BAD_MODULES"] == "[]", lines["BAD_MODULES"]
    fe = SubstraitFrontend(device="cpu")
    fe.register_table("t", t)
    want = fe.execute_plan(READ_PLAN).combine_chunks()
    digest, rows = lines["DIGEST"].split()
    assert int(rows) == want.num_rows
    assert digest == table_digest(want)


def test_connect_client_cli():
    t = _table(n=500)
    srv = _server(table=t)
    host, port = srv.address
    text = "select k, sum(v) as sv from t group by k order by k"
    out = subprocess.run(
        [sys.executable, "-m", "spark_rapids_tpu_torch.tools.connect_client",
         "--host", host, "--port", str(port), "--sql", text,
         "--digest-only"],
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == table_digest(
        _local_sql(t, text).combine_chunks())


# ------------------------------------------------------------------ #
# The two packages on one wire
# ------------------------------------------------------------------ #


SQL_PLANS = [SQL, "select k, sum(v) as sv from t where v > 500 "
                  "group by k order by k"]


@pytest.mark.parametrize("which", ["substrait", "sql0", "sql1"])
def test_jax_client_against_the_port_server(which):
    from spark_rapids_tpu.connect.client import ConnectClient as JClient

    t = _table()
    srv = _server(table=t)
    host, port = srv.address
    with JClient(host, port, tenant="jax") as cli:
        if which == "substrait":
            got = cli.execute_plan(READ_PLAN)
        else:
            got = cli.execute_sql(SQL_PLANS[int(which[-1])], batch_rows=64)
    if which == "substrait":
        fe = SubstraitFrontend(device="cpu")
        fe.register_table("t", t)
        want = fe.execute_plan(READ_PLAN)
    else:
        want = _local_sql(t, SQL_PLANS[int(which[-1])])
    assert table_digest(got) == table_digest(want.combine_chunks())


@pytest.mark.parametrize("which", ["substrait", "sql0", "sql1"])
def test_port_client_against_the_jax_server(which):
    from spark_rapids_tpu.connect.server import ConnectServer as JServer
    from spark_rapids_tpu.frontends.sql import SqlSession as JSql
    from spark_rapids_tpu.frontends.substrait import (
        SubstraitFrontend as JSubstrait,
    )

    t = _table()
    srv = JServer()
    srv.register_table("t", t)
    SERVERS.append(srv)
    srv.start()
    host, port = srv.address
    with ConnectClient(host, port, tenant="port") as cli:
        if which == "substrait":
            got = cli.execute_plan(READ_PLAN)
        else:
            got = cli.execute_sql(SQL_PLANS[int(which[-1])], batch_rows=64)
    if which == "substrait":
        fe = JSubstrait()
        fe.register_table("t", t)
        want = fe.execute_plan(READ_PLAN)
        mine = _port_substrait(t)
    else:
        fe = JSql()
        fe.register_table("t", t)
        want = fe.sql(SQL_PLANS[int(which[-1])]).collect(engine="tpu")
        mine = _local_sql(t, SQL_PLANS[int(which[-1])])
    assert table_digest(got) == table_digest(want.combine_chunks())
    # and the JAX server's answer is the port's
    assert_tables_equal(got, mine)


def _port_substrait(t: pa.Table) -> pa.Table:
    fe = SubstraitFrontend(device="cpu")
    fe.register_table("t", t)
    return fe.execute_plan(READ_PLAN)


# ------------------------------------------------------------------ #
# Deadlines and shedding
# ------------------------------------------------------------------ #


def test_wire_deadline_sheds_in_queue_zero_device_work(tmp_path):
    from spark_rapids_tpu_torch.columnar.transfer import upload_stats
    from spark_rapids_tpu_torch.trace import ledger as _ledger

    conf = C.TorchConf({C.SERVING_MAX_CONCURRENT: 1,
                        C.EVENTLOG_ENABLED: True,
                        C.EVENTLOG_DIR: str(tmp_path),
                        C.LEDGER_ENABLED: True})
    srv = _server(conf=conf)
    sched = scheduler_mod.get_scheduler(conf)
    hog = sched.admit("hog")  # the only admission slot
    try:
        _ledger.sync_conf(conf)
        led0 = _ledger.LEDGER.snapshot()
        up0 = upload_stats()
        host, port = srv.address
        t0 = time.perf_counter()
        with ConnectClient(host, port, tenant="dl") as cli:
            with pytest.raises(ConnectError) as ei:
                cli.execute_sql(SQL, deadline_ms=40.0)
        assert ei.value.kind == "deadline_exceeded"
        assert time.perf_counter() - t0 < 10.0
        # no program dispatched, no byte uploaded: planning is the plan
        # cache's, before admission
        assert _ledger.delta(led0, _ledger.LEDGER.snapshot()) == {}
        assert upload_stats() == up0
    finally:
        sched.release(hog)
    rec = _wait_for_record(tmp_path, "deadline_exceeded")
    assert rec["engine"] == "deadline_exceeded"
    assert rec["operators"]["children"] == []


def test_queue_shed_record_keeps_connect_section(tmp_path):
    conf = C.TorchConf({C.SERVING_MAX_CONCURRENT: 1,
                        C.EVENTLOG_ENABLED: True,
                        C.EVENTLOG_DIR: str(tmp_path)})
    srv = _server(conf=conf)
    sched = scheduler_mod.get_scheduler(conf)
    hog = sched.admit("hog")
    try:
        host, port = srv.address
        with ConnectClient(host, port, tenant="shed") as cli:
            with pytest.raises(ConnectError) as ei:
                cli.execute_sql(SQL, deadline_ms=40.0)
        assert ei.value.kind == "deadline_exceeded"
    finally:
        sched.release(hog)
    rec = _wait_for_record(tmp_path, "deadline_exceeded")
    conn = rec.get("connect")
    assert conn is not None, "the shed record dropped its connect section"
    assert conn["peer"].startswith("127.0.0.1:")
    assert conn["wire_bytes"] > 0
    assert conn["translate_ms"] >= 0


def test_client_disconnect_cancels_inflight(tmp_path):
    conf = C.TorchConf({C.EVENTLOG_ENABLED: True,
                        C.EVENTLOG_DIR: str(tmp_path),
                        C.BATCH_ROWS: 256,
                        C.CONNECT_SEND_BUFFER_BYTES: 8192})
    srv = _server(conf=conf, table=_table(n=60000))
    host, port = srv.address
    cli = ConnectClient(host, port, tenant="dropper")
    cli._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8192)
    stream = cli.execute_plan_stream(None, sql="select k, v, s from t",
                                     batch_rows=16)
    first = next(stream)
    assert first.num_rows > 0
    time.sleep(0.5)  # the producer runs into the full buffer
    cli.close()
    rec = _wait_for_record(tmp_path, "cancelled", timeout=20.0)
    assert rec["engine"] == "cancelled"
    assert "[stream unwound: cancelled]" in rec["plan"]


# ------------------------------------------------------------------ #
# Framing
# ------------------------------------------------------------------ #


def test_malformed_and_oversized_frames_rejected():
    srv = _server(table=_table(n=100))
    host, port = srv.address
    with socket.create_connection((host, port), timeout=10) as s:
        s.sendall(struct.pack("<Q", 1 << 60))
        s.sendall(b"JXXXX")
        resp = recv_json(s)
        assert not resp["ok"] and resp["kind"] == "bad_frame"
    with socket.create_connection((host, port), timeout=10) as s:
        payload = b"Jnot-json"
        s.sendall(struct.pack("<Q", len(payload)) + payload)
        resp = recv_json(s)
        assert not resp["ok"] and resp["kind"] == "bad_frame"
    with ConnectClient(host, port) as cli:
        send_frame(cli._sock, TAG_JSON, json.dumps({"op": "nope"}).encode())
        resp = recv_json(cli._sock)
        assert not resp["ok"] and resp["kind"] == "bad_request"
        assert cli.ping()
    with ConnectClient(host, port) as cli:
        out = cli.execute_sql("select count(*) as n from t")
        assert out.column("n")[0].as_py() == 100


def test_translate_error_keeps_connection():
    srv = _server(table=_table(n=50))
    host, port = srv.address
    with ConnectClient(host, port) as cli:
        with pytest.raises(ConnectError) as ei:
            cli.execute_sql("select frobnicate(k) from t")
        assert ei.value.kind == "translate_error"
        out = cli.execute_sql("select count(*) as n from t")
        assert out.column("n")[0].as_py() == 50


def test_empty_result_keeps_its_schema():
    t = _table(n=200)
    srv = _server(table=t)
    host, port = srv.address
    text = "select k, sum(v) as sv from t where v < 0 group by k"
    with ConnectClient(host, port) as cli:
        got = cli.execute_sql(text)
    want = _local_sql(t, text)
    assert got.num_rows == 0
    assert got.schema.names == want.schema.names
    assert table_digest(got) == table_digest(want.combine_chunks())


def test_conf_overrides_from_the_wire():
    """String conf values over the wire are parsed as their keys'
    types; a bad key is a translate error and the server stays up."""
    srv = _server(table=_table(n=300))
    host, port = srv.address
    with ConnectClient(host, port) as cli:
        out = cli.execute_sql(
            "select count(*) as n from t",
            conf={C.SORT_RANGE_EXCHANGE: "false", C.BATCH_ROWS: "64"})
        assert out.column("n")[0].as_py() == 300
        with pytest.raises(ConnectError) as ei:
            cli.execute_sql("select count(*) as n from t",
                            conf={"spark.no.such.key": 1})
        assert ei.value.kind == "bad_request"
        assert cli.ping()


# ------------------------------------------------------------------ #
# Sharing, tracing, the record
# ------------------------------------------------------------------ #


def test_two_tenants_two_sockets_share_result_cache():
    from spark_rapids_tpu_torch.serving import work_share

    srv = _server(conf=C.TorchConf({C.SHARING_ENABLED: True}))
    host, port = srv.address
    s0 = work_share.stats()
    with ConnectClient(host, port, tenant="tenant_a") as a:
        ra = a.execute_sql(SQL)
    with ConnectClient(host, port, tenant="tenant_b") as b:
        rb = b.execute_sql(SQL)
    s1 = work_share.stats()
    assert table_digest(ra) == table_digest(rb)
    assert s1["result_hits"] - s0["result_hits"] >= 1, (s0, s1)


def test_wire_trace_propagates_and_merges_one_timeline():
    from spark_rapids_tpu_torch import trace as _trace
    from spark_rapids_tpu_torch.trace.export import (
        chrome_trace,
        merge_wire_trace,
    )

    srv = _server(table=_table(n=2000))
    _trace.enable()
    host, port = srv.address
    with ConnectClient(host, port, tenant="traced", trace=True) as cli:
        got = cli.execute_sql(SQL, batch_rows=256)
    assert got.num_rows > 0
    assert cli.trace_id and len(cli.trace_id) == 16
    assert [s["name"] for s in cli.trace_spans] == [
        "connect.client.send", "connect.client.first_byte",
        "connect.client.last_byte"]
    tagged = [e for e in _trace.snapshot()
              if e.attrs.get("trace_id") == cli.trace_id]
    assert tagged, "no server span carries the client's trace id"
    assert any(e.name == "query.execute" for e in tagged)
    lo = cli.trace_spans[0]["ts_ns"]
    last = cli.trace_spans[-1]
    hi = last["ts_ns"] + last["dur_ns"]
    for e in tagged:
        assert lo <= e.ts_ns <= hi, (e.name, e.ts_ns, lo, hi)
    doc = merge_wire_trace(chrome_trace(tagged), cli.trace_spans)
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"connect.client.send", "connect.client.last_byte",
            "query.execute"} <= names
    json.dumps(doc)


def test_wire_trace_off_by_default():
    srv = _server(table=_table(n=200))
    host, port = srv.address
    with ConnectClient(host, port) as cli:
        out = cli.execute_sql("select count(*) as n from t")
    assert out.column("n")[0].as_py() == 200
    assert cli.trace_id is None
    assert cli.trace_spans == []


def test_eventlog_connect_section(tmp_path):
    conf = C.TorchConf({C.EVENTLOG_ENABLED: True,
                        C.EVENTLOG_DIR: str(tmp_path)})
    srv = _server(conf=conf, table=_table(n=300))
    host, port = srv.address
    with ConnectClient(host, port, tenant="logged") as cli:
        cli.execute_sql("select count(*) as n from t")
    rec = _wait_for_record(tmp_path, "tpu")
    conn = rec["connect"]
    assert conn["peer"].startswith("127.0.0.1:")
    assert conn["wire_bytes"] > 0
    assert conn["translate_ms"] >= 0
    assert rec["serving"]["plan_cache"] in ("hit", "miss")
    assert rec["rows"] == 1
    # the JAX tool reads it, with its connect section
    from spark_rapids_tpu.eventlog.schema import validate_record

    validate_record(rec)
