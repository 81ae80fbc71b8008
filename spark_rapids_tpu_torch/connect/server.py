"""The connect server: the wire front door's engine side.

Counterpart of ``spark_rapids_tpu/connect/server.py``.  A
``ThreadingTCPServer``; a connection is one sequential request loop (the
Spark Connect ExecutePlan shape) with its own engine session per
(tenant, conf overrides), so tenants share the process's serving tier
(admission, the result and scan caches) but never a mutable conf.  A
request's Substrait plan or SQL text is translated by the port's
frontends and prepared in the session's plan cache, and its result
drains through ``PreparedQuery.execute_stream`` only (never
``collect()``): admission, cancellation, sharing, the history and the
event log engage as for a query in process, and its record carries a
``connect`` section (peer, wire bytes, translate ms).

Failures:

- a translate error (a plan or text outside the frontends), an
  admission rejection, a quarantine or a deadline is an error frame;
  the connection stays open;
- a malformed or oversized frame gets an error frame and closes its own
  connection only (the length is checked before anything is allocated);
- a client that drops mid-stream cancels its query through its cancel
  token, and the engine unwinds (the slot released, the partial metrics
  recorded as a cancelled outcome).
"""

from __future__ import annotations

import contextlib
import json
import socket
import socketserver
import threading
import time
from typing import Optional

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.connect.client import (
    TAG_ARROW,
    TAG_JSON,
    ConnectError,
    recv_frame,
    send_frame,
)

#: name of the server's accept thread
THREAD_NAME = "srt-connect-server"


class _SessionState:
    """One connection's engine state for a (tenant, conf overrides):
    the SQL and Substrait frontends over one ``TorchSession`` (one plan
    cache, one event log, one tenant)."""

    def __init__(self, catalog: dict, base_conf: dict, overrides: dict,
                 tenant: str, device):
        from spark_rapids_tpu_torch.frontends.sql import SqlSession
        from spark_rapids_tpu_torch.frontends.substrait import (
            SubstraitFrontend,
        )

        conf = C.TorchConf(base_conf)
        for k, v in overrides.items():
            conf.set(k, v)
        self.conf = conf
        self.sql = SqlSession(conf, device=device, tenant=tenant)
        self.session = self.sql.session
        self.substrait = SubstraitFrontend(session=self.session)
        for name, source in catalog.items():
            self.substrait.register_table(name, source)
            if isinstance(source, str) or isinstance(source, (list, tuple)):
                paths = [source] if isinstance(source, str) else source
                self.sql.register_parquet(name, *paths)
            else:
                self.sql.register_table(name, source)


class _ConnectHandler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        srv = self.server
        conf = srv.base_conf  # type: ignore[attr-defined]
        max_frame = conf.get(C.CONNECT_MAX_FRAME_BYTES)
        self.request.settimeout(conf.get(C.CONNECT_SOCKET_TIMEOUT_S))
        sndbuf = conf.get(C.CONNECT_SEND_BUFFER_BYTES)
        if sndbuf:
            self.request.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                    int(sndbuf))
        peer = "%s:%s" % self.client_address[:2]
        states: dict[tuple, _SessionState] = {}
        while True:
            try:
                tag, payload = recv_frame(self.request, max_frame)
                if tag != TAG_JSON:
                    raise ConnectError(f"expected JSON frame, got tag {tag!r}")
                try:
                    req = json.loads(payload.decode())
                except (UnicodeDecodeError, json.JSONDecodeError) as je:
                    raise ConnectError(f"malformed JSON frame: {je}") \
                        from None
                if not isinstance(req, dict):
                    raise ConnectError("JSON frame must carry an object")
            except ConnectError as e:
                # a disconnect between requests is normal; any other
                # bad frame gets an error frame, and only this
                # connection closes
                if "closed mid-frame" not in str(e):
                    self._reply_error(str(e), "bad_frame")
                return
            except OSError:
                return
            op = req.get("op")
            if op == "ping":
                self._reply({"ok": True, "pong": True})
                continue
            if op != "execute_plan":
                self._reply_error(f"unknown op {op!r}", "bad_request")
                continue
            try:
                # the request's bytes as framed (recv_frame checked them)
                self._execute(srv, states, req, peer, len(payload))
            except OSError:
                return  # the client is gone; its query was cancelled

    # -- replies ----------------------------------------------------- #

    def _reply(self, obj: dict) -> None:
        send_frame(self.request, TAG_JSON, json.dumps(obj).encode())

    def _reply_error(self, message: str, kind: str) -> None:
        try:
            self._reply({"ok": False, "error": message, "kind": kind})
        except OSError:
            pass

    # -- the one query path ------------------------------------------ #

    def _execute(self, srv, states: dict, req: dict, peer: str,
                 wire_bytes: int) -> None:
        from spark_rapids_tpu_torch.frontends.sql import SqlError
        from spark_rapids_tpu_torch.frontends.substrait import SubstraitError

        tenant = str(req.get("tenant") or "default")
        overrides = dict(req.get("conf") or {})
        key = (tenant, tuple(sorted(
            (str(k), str(v)) for k, v in overrides.items())))
        state = states.get(key)
        try:
            if state is None:
                state = states[key] = _SessionState(
                    srv.catalog, srv.base_values, overrides, tenant,
                    srv.device)
        except (KeyError, TypeError, ValueError) as e:
            self._reply_error(f"{type(e).__name__}: {e}", "bad_request")
            return
        # the wire deadline is serving.deadlineMs for this request only
        # (requests on a connection are sequential; the value before it
        # is restored, and with it the conf's fingerprint)
        deadline = req.get("deadline_ms")
        prev_deadline = state.conf.get(C.DEADLINE_MS)
        had_deadline = state.conf.is_set(C.DEADLINE_MS)
        if deadline is not None:
            state.conf.set(C.DEADLINE_MS, float(deadline))
        try:
            t0 = time.perf_counter()
            try:
                if req.get("sql") is not None:
                    pq = state.sql.prepare(str(req["sql"]))
                    params = self._decode_params(req.get("params"))
                else:
                    plan = req.get("plan")
                    if plan is None:
                        raise ConnectError(
                            "execute_plan needs 'plan' or 'sql'",
                            kind="bad_request")
                    pq = state.session.prepare(
                        state.substrait.dataframe(plan))
                    params = None
            except (SubstraitError, SqlError, ConnectError, KeyError,
                    TypeError, ValueError) as e:
                self._reply_error(f"{type(e).__name__}: {e}",
                                  "translate_error")
                return
            translate_ms = (time.perf_counter() - t0) * 1e3
            batch_rows = int(req.get("batch_rows")
                             or state.conf.get(C.CONNECT_BATCH_ROWS)
                             or 0) or None
            facts = {"connect": {
                "peer": peer, "wire_bytes": wire_bytes,
                "translate_ms": round(translate_ms, 3)}}
            # the client's trace id becomes the query's correlation
            # context: every server span of it carries the id
            trace = req.get("trace")
            tctx = {}
            if isinstance(trace, dict) and trace.get("trace_id"):
                tctx = {"trace_id": str(trace["trace_id"])}
                if trace.get("span_id"):
                    tctx["parent_span_id"] = str(trace["span_id"])
                facts["connect"]["trace_id"] = tctx["trace_id"]
            from spark_rapids_tpu_torch import trace as _trace

            with _trace.trace_context(**tctx) if tctx \
                    else contextlib.nullcontext():
                self._stream_result(pq, params, batch_rows, facts)
        finally:
            if deadline is not None:
                if had_deadline:
                    state.conf.set(C.DEADLINE_MS, prev_deadline)
                else:
                    state.conf._values.pop(C.DEADLINE_MS, None)

    @staticmethod
    def _decode_params(raw: Optional[dict]) -> Optional[dict]:
        """JSON has no date: ``{"name": {"date": "2001-01-02"}}`` binds
        a date; anything else binds as it is."""
        if not raw:
            return None
        import datetime as _dt

        out = {}
        for k, v in raw.items():
            if isinstance(v, dict) and set(v) == {"date"}:
                v = _dt.date.fromisoformat(v["date"])
            out[k] = v
        return out

    def _stream_result(self, pq, params, batch_rows: Optional[int],
                       facts: dict) -> None:
        """Drain one prepared query to the socket: the J header, an A
        frame a record batch as the engine's fetch stage yields it (the
        socket's backpressure stalls the producer), the J trailer.  A
        failed send is a dropped client: cancel the query through its
        token and drain it to the cancellation, then re-raise."""
        import pyarrow as pa

        from spark_rapids_tpu_torch.serving.cancel import QueryCancelled
        from spark_rapids_tpu_torch.serving.scheduler import AdmissionRejected

        gen = pq.execute_stream(params=params, batch_rows=batch_rows,
                                extra_facts=facts)
        rows = 0
        batches = 0
        sent_header = False
        try:
            while True:
                try:
                    rb = next(gen)
                except StopIteration:
                    break
                except QueryCancelled as e:
                    self._reply_error(str(e), e.reason)
                    return
                except AdmissionRejected as e:  # a quarantine too
                    self._reply_error(str(e), "admission_rejected")
                    return
                except Exception as e:  # noqa: BLE001 - the wire's edge:
                    # the engine recorded it; the client gets the error
                    self._reply_error(f"{type(e).__name__}: {e}",
                                      "execution_error")
                    return
                if not sent_header:
                    self._reply({"ok": True})
                    sent_header = True
                try:
                    self._send_batch(rb)
                except OSError:
                    pq.cancel(reason="cancelled")
                    try:
                        for _ in gen:
                            pass
                    except QueryCancelled:
                        pass
                    raise
                rows += rb.num_rows
                batches += 1
            if not sent_header:
                self._reply({"ok": True})
            if batches == 0:
                # an empty result still carries its schema, as a collect
                # gives it: one empty frame
                from spark_rapids_tpu_torch.columnar.arrow import (
                    batches_to_arrow,
                )

                entry, _hit = pq._resolve(params)  # the cached entry
                empty = batches_to_arrow([], entry.exec_.schema)
                self._send_batch(pa.RecordBatch.from_pylist(
                    [], schema=empty.schema))
                batches = 1
            self._reply({"ok": True, "rows": rows, "batches": batches})
        finally:
            gen.close()

    def _send_batch(self, rb) -> None:
        import pyarrow as pa

        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, rb.schema) as w:
            w.write_batch(rb)
        send_frame(self.request, TAG_ARROW, sink.getvalue().to_pybytes())


class ConnectServer:
    """The wire front door: register tables, start, take queries.

    ``conf`` (a ``TorchConf`` or a dict) seeds every connection's
    sessions, under each request's overrides; ``device`` is theirs
    (``cuda`` unless the caller asks for the CPU).  A catalog entry is
    a pyarrow Table or Parquet path(s), registered under its name with
    both frontends of every connection."""

    def __init__(self, conf=None, host: str = "127.0.0.1", port: int = 0,
                 device="cuda"):
        # the planner's exec and expression switches register at its
        # import: do it before any conf is copied, so that every
        # connection's conf fingerprints alike
        import spark_rapids_tpu_torch.plan.planner  # noqa: F401

        self.base_conf = conf if isinstance(conf, C.TorchConf) \
            else C.TorchConf(conf)
        self.catalog: dict = {}
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _ConnectHandler, bind_and_activate=True)
        self._srv.daemon_threads = True
        self._srv.base_conf = self.base_conf
        self._srv.base_values = dict(self.base_conf._values)
        self._srv.catalog = self.catalog
        self._srv.device = device
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True, name=THREAD_NAME)

    def register_table(self, name: str, source) -> None:
        """``source``: a pa.Table, or Parquet path(s).  Connections
        opened after the call see it."""
        self.catalog[name.lower()] = source

    @property
    def address(self) -> tuple[str, int]:
        return self._srv.server_address[:2]

    def start(self) -> "ConnectServer":
        self._thread.start()
        return self

    def shutdown(self) -> None:
        """Stop accepting, close the socket and join the accept thread
        (a connection's handler thread ends with its client)."""
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread.is_alive():
            self._thread.join()
