"""The ops plane's HTTP endpoint (counterpart of
``spark_rapids_tpu/obs/server.py``): stdlib ``http.server`` with daemon
handler threads, one acceptor thread and a ``stop()`` that shuts the
loop down, closes the socket and joins the acceptor.

Endpoints (all GET, JSON unless noted):

- ``/metrics``  — OpenMetrics text exposition (obs/metrics.py);
- ``/queries``  — in-flight query list (plans elided);
- ``/queries/<id>`` — one in-flight query: rendered plan, elapsed,
  batches-so-far, cancel-token state, per-op ledger metrics-so-far;
- ``/queries/<id>/cancel`` (POST) — cancel via the registered token;
- ``/slo``      — per-tenant rolling p50/p99 + breach history;
- ``/healthz``  — liveness probe (``ok``).

The handler serves from in-process snapshots only: it never touches
the card and takes no engine lock but the registry's, so a scrape does
not change a query's result.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class _Handler(BaseHTTPRequestHandler):
    # the plane is an operator surface, not a web app: no logging to
    # stderr (a scrape per second would drown real diagnostics)
    def log_message(self, fmt, *args):  # noqa: A003
        pass

    def _send(self, code: int, body: str,
              ctype: str = "application/json") -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype + "; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, obj, code: int = 200) -> None:
        self._send(code, json.dumps(obj, default=str))

    def _qid(self, part: str) -> Optional[int]:
        try:
            return int(part)
        except ValueError:
            self._send_json({"error": f"bad query id {part!r}"}, 400)
            return None

    def do_GET(self) -> None:  # noqa: N802 — http.server contract
        from spark_rapids_tpu_torch import obs as _obs
        from spark_rapids_tpu_torch.obs import metrics as _metrics
        from spark_rapids_tpu_torch.obs import slo as _slo

        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                self._send(200, _metrics.openmetrics_text(),
                           ctype="application/openmetrics-text; "
                                 "version=1.0.0")
            elif path == "/queries":
                self._send_json(_obs.REGISTRY.snapshot())
            elif path.startswith("/queries/"):
                qid = self._qid(path.split("/", 2)[2])
                if qid is None:
                    return
                entry = _obs.REGISTRY.get(qid)
                if entry is None:
                    self._send_json(
                        {"error": f"query {qid} not in flight"}, 404)
                else:
                    self._send_json(entry)
            elif path == "/slo":
                self._send_json(_slo.WATCHDOG.snapshot())
            elif path == "/healthz":
                self._send(200, "ok\n", ctype="text/plain")
            else:
                self._send_json({"error": f"no route {path!r}"}, 404)
        except BrokenPipeError:
            pass  # scraper went away mid-body
        except Exception as e:  # noqa: BLE001 — the probe must live
            try:
                self._send_json({"error": repr(e)}, 500)
            except Exception:
                pass

    def do_POST(self) -> None:  # noqa: N802 — http.server contract
        from spark_rapids_tpu_torch import obs as _obs

        path = self.path.split("?", 1)[0].rstrip("/")
        parts = path.split("/")
        if len(parts) == 4 and parts[1] == "queries" \
                and parts[3] == "cancel":
            qid = self._qid(parts[2])
            if qid is None:
                return
            ok = _obs.REGISTRY.cancel(qid)
            self._send_json({"query_id": qid, "cancelled": ok},
                            200 if ok else 404)
            return
        self._send_json({"error": f"no route {path!r}"}, 404)


class OpsHttpServer:
    """One acceptor thread + daemon handler threads; ``stop()`` shuts
    the serve loop down, closes the listening socket and JOINS the
    acceptor, so after stop() no thread and no bound port remain."""

    def __init__(self, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="srt-obs-http", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
