"""The connect client: plans over TCP, Arrow back.

Counterpart of ``spark_rapids_tpu/connect/client.py``, with its frames
byte for byte.  It imports nothing of the engine and no torch (stdlib
sockets and pyarrow), so a client process stays free of both; the
server takes its framing helpers from here.

A frame is::

    <u64 little-endian length> <1-byte tag> <payload>

``length`` counts the tag and the payload and is checked against a
maximum before anything is allocated, at both ends.  Tags: ``J``, a
JSON object; ``A``, one Arrow IPC stream holding one record batch.  A
request is one J frame; its response a J header, an A frame a batch,
and a J trailer with the rows and batches, or the error.

A request may carry ``"trace": {"trace_id": <16 hex>, "span_id": <id>}``
(``ConnectClient(trace=True)``): the server tags every span of the query
with the id, and the client records its own send, first-byte and
last-byte spans (``trace/export.merge_wire_trace`` puts both on one
timeline).
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import struct
import time
from typing import Iterator, Optional, Union

#: default frame clamp, mirroring spark.rapids.tpu.connect.maxFrameBytes
DEFAULT_MAX_FRAME_BYTES = 64 << 20

TAG_JSON = b"J"
TAG_ARROW = b"A"


class ConnectError(RuntimeError):
    """Protocol-level failure (framing, transport, server rejection).
    ``kind`` carries the server's error class when one was reported
    (e.g. ``translate_error``, ``deadline_exceeded``,
    ``admission_rejected``)."""

    def __init__(self, message: str, kind: str = "protocol"):
        super().__init__(message)
        self.kind = kind


# ------------------------------------------------------------------ #
# Framing (shared with the server)
# ------------------------------------------------------------------ #


def send_frame(sock: socket.socket, tag: bytes, payload: bytes) -> None:
    sock.sendall(struct.pack("<Q", len(payload) + 1) + tag + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock: socket.socket,
               max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES
               ) -> tuple[bytes, bytes]:
    """Read one ``(tag, payload)`` frame.  The length is validated
    against ``max_frame_bytes`` BEFORE any payload allocation — an
    oversized or nonsensical length costs 8 bytes of read, never a
    giant bytearray."""
    (n,) = struct.unpack("<Q", _recv_exact(sock, 8))
    if n < 1 or n > max_frame_bytes:
        raise ConnectError(
            f"frame length {n} outside (0, {max_frame_bytes}] — "
            "oversized or corrupt frame")
    body = _recv_exact(sock, n)
    return body[:1], body[1:]


def recv_json(sock: socket.socket,
              max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES) -> dict:
    tag, payload = recv_frame(sock, max_frame_bytes)
    if tag != TAG_JSON:
        raise ConnectError(f"expected JSON frame, got tag {tag!r}")
    try:
        out = json.loads(payload.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ConnectError(f"malformed JSON frame: {e}") from None
    if not isinstance(out, dict):
        raise ConnectError("JSON frame must carry an object")
    return out


def mint_trace_id() -> str:
    """A fresh 16-hex-char wire trace id (engine-free: os.urandom, no
    engine tracer import).  The client stamps it on each request's
    optional ``trace`` field; the server installs it as correlation
    context, so both sides' spans merge onto one timeline
    (trace/export.merge_wire_trace)."""
    return os.urandom(8).hex()


def table_digest(tbl) -> str:
    """Engine-free mirror of eventlog.table_digest: sha256 of the
    combined table's Arrow IPC stream bytes, truncated to 16 hex
    chars — the two ends agree bit-for-bit exactly when the results
    do."""
    import pyarrow as pa

    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, tbl.schema) as w:
        for b in tbl.combine_chunks().to_batches():
            w.write_batch(b)
    return hashlib.sha256(memoryview(sink.getvalue())).hexdigest()[:16]


# ------------------------------------------------------------------ #
# Client
# ------------------------------------------------------------------ #


class ConnectClient:
    """One connection to a ConnectServer.  Requests are sequential per
    connection (the Spark Connect ExecutePlan shape); reconnect or open
    more clients for concurrency.  Usable as a context manager."""

    def __init__(self, host: str, port: int,
                 tenant: str = "default",
                 timeout: float = 120.0,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                 trace: bool = False):
        self.tenant = tenant
        self._max_frame = max_frame_bytes
        #: wire trace propagation: with trace=True
        #: every request carries {"trace": {"trace_id", "span_id"}} and
        #: the client records send / first-byte / last-byte spans into
        #: ``trace_spans`` as plain dicts — perf_counter_ns timestamps,
        #: the engine tracer's clock, so an in-process loopback merges
        #: onto ONE Chrome-trace timeline (export.merge_wire_trace)
        self.trace_id: Optional[str] = mint_trace_id() if trace \
            else None
        self.trace_spans: list[dict] = []
        self._span_seq = 0
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)

    # -- lifecycle -- #

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ConnectClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- requests -- #

    def ping(self) -> bool:
        send_frame(self._sock, TAG_JSON,
                   json.dumps({"op": "ping"}).encode())
        return bool(recv_json(self._sock, self._max_frame).get("pong"))

    def execute_plan(self, plan: Union[str, dict], **kw):
        """Submit a Substrait plan (JSON text or dict); returns the
        full result as one pyarrow Table.  Keywords: ``conf`` (session
        conf overrides), ``deadline_ms`` (becomes
        spark.rapids.tpu.serving.deadlineMs server-side), and
        ``batch_rows``."""
        import pyarrow as pa

        tbls = list(self.execute_plan_stream(plan, **kw))
        if not tbls:
            return pa.table({})
        # concat (not from_batches): a 0-row frame still carries the
        # result schema, and the reassembled table must keep it
        return pa.concat_tables(tbls)

    def execute_plan_stream(self, plan: Union[str, dict],
                            conf: Optional[dict] = None,
                            params: Optional[dict] = None,
                            deadline_ms: Optional[float] = None,
                            batch_rows: Optional[int] = None,
                            sql: Optional[str] = None) -> Iterator:
        """Stream the result: yields one pyarrow Table per response
        Arrow frame (= one device batch).  ``plan`` may be None when
        ``sql`` text is given instead."""
        req: dict = {"op": "execute_plan", "tenant": self.tenant}
        if plan is not None:
            req["plan"] = plan
        if sql is not None:
            req["sql"] = sql
        if conf:
            req["conf"] = dict(conf)
        if params:
            req["params"] = dict(params)
        if deadline_ms is not None:
            req["deadline_ms"] = float(deadline_ms)
        if batch_rows is not None:
            req["batch_rows"] = int(batch_rows)
        span_attrs = None
        if self.trace_id is not None:
            self._span_seq += 1
            span_id = f"{self.trace_id}.{self._span_seq}"
            req["trace"] = {"trace_id": self.trace_id,
                            "span_id": span_id}
            span_attrs = {"trace_id": self.trace_id,
                          "span_id": span_id}
        t0 = time.perf_counter_ns()
        send_frame(self._sock, TAG_JSON, json.dumps(req).encode())
        t_sent = time.perf_counter_ns()
        head = recv_json(self._sock, self._max_frame)
        t_first = time.perf_counter_ns()
        if span_attrs is not None:
            # client-side wire spans: request serialization+send, then
            # time-to-first-byte (the server's admit+translate+first
            # batch sit inside it on the merged timeline)
            self.trace_spans.append(
                {"name": "connect.client.send", "ph": "X",
                 "ts_ns": t0, "dur_ns": t_sent - t0,
                 "attrs": dict(span_attrs)})
            self.trace_spans.append(
                {"name": "connect.client.first_byte", "ph": "X",
                 "ts_ns": t_sent, "dur_ns": t_first - t_sent,
                 "attrs": dict(span_attrs)})
        if not head.get("ok"):
            raise ConnectError(head.get("error", "server error"),
                               kind=head.get("kind", "server"))
        import pyarrow as pa

        try:
            while True:
                tag, payload = recv_frame(self._sock, self._max_frame)
                if tag == TAG_ARROW:
                    with pa.ipc.open_stream(
                            pa.py_buffer(payload)) as rd:
                        yield rd.read_all()
                    continue
                if tag != TAG_JSON:
                    raise ConnectError(
                        f"unexpected frame tag {tag!r}")
                trailer = json.loads(payload.decode())
                if not trailer.get("ok"):
                    raise ConnectError(
                        trailer.get("error", "stream failed"),
                        kind=trailer.get("kind", "server"))
                return
        finally:
            if span_attrs is not None:
                t_last = time.perf_counter_ns()
                self.trace_spans.append(
                    {"name": "connect.client.last_byte", "ph": "X",
                     "ts_ns": t_first, "dur_ns": t_last - t_first,
                     "attrs": dict(span_attrs)})

    def execute_sql(self, sql: str, **kw):
        """SQL-text convenience: same wire op with ``sql`` instead of a
        Substrait plan (``params`` binds :name placeholders)."""
        return self.execute_plan(None, sql=sql, **kw)
