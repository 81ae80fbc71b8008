"""The live ops plane: OpenMetrics export, the in-flight query registry
and the SLO watchdog.

Counterpart of ``spark_rapids_tpu/obs/__init__.py``.  The records the
engine keeps (the trace, the event log, the ledger) are read after the
fact; this is the view of a running process:

- an HTTP endpoint (``obs/server.py``, stdlib ``http.server`` on daemon
  threads) serving ``/metrics`` (OpenMetrics text over the event log's
  counters, the telemetry gauges, the scheduler's and the ledger's, with
  names derived from their keys: ``obs/metrics.py``), ``/queries``,
  ``/queries/<id>`` (with ``POST /queries/<id>/cancel``), ``/slo`` and
  ``/healthz``;
- the registry of queries in flight (:class:`LiveQueryRegistry`): the
  session's query prologue registers each with its tenant, plan,
  elapsed time, batches so far and cancel token, and its epilogue
  removes it;
- the SLO watchdog (``obs/slo.py``): one thread holding each tenant's
  rolling wall and admission-wait windows, fed by the epilogue, whose
  p99 over a ``obs.slo.*`` budget appends an ``slo`` record to the
  attached event logs (health rule HC016) and shows at ``/slo``.

Off (``spark.rapids.tpu.obs.enabled`` false, the default) a query pays
one conf read in :func:`sync_conf`, and no thread, socket or registry
entry exists.  Ownership is the tracer's: a programmatic :func:`start`
survives ``sync_conf``; a conf-driven start is owned by its conf, and
only that conf's "off" stops the plane.  The keys are in ``config.py``
(``spark.rapids.tpu.obs.*``).
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Optional

from spark_rapids_tpu_torch import config as C


# ------------------------------------------------------------------ #
# Live query registry
# ------------------------------------------------------------------ #


class LiveQueryRegistry:
    """In-flight queries, keyed by the process-global query id the
    shared prologue allocates.  ``enabled`` is the fast-path guard the
    session hooks read; everything else is behind the lock.  Entries
    hold the cancel token itself (so ``/queries/<id>/cancel`` works)
    but only WEAK state otherwise — plain strings and numbers, never
    the exec tree."""

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._live: dict[int, dict] = {}
        self._ledger_base: dict[int, dict] = {}

    def count(self) -> int:
        # len() of a dict is atomic under the GIL: this is the
        # queries.in_flight telemetry gauge, read lock-free at Hz
        return len(self._live)

    def begin(self, qid: int, tenant: Optional[str] = None,
              token: Any = None, conf_hash: str = "",
              plan: Optional[str] = None,
              plan_hash: Optional[str] = None) -> None:
        if not self.enabled:
            return
        entry = {
            "query_id": qid,
            "tenant": tenant,
            "conf_hash": conf_hash,
            "plan": plan,
            "plan_hash": plan_hash,
            "started_ts": time.time(),
            "started_pc": time.perf_counter(),
            "batches": 0,
            "rows": 0,
            "token": token,
        }
        with self._lock:
            self._live[qid] = entry
        # per-operator metrics-so-far ride the device ledger when it
        # is on: snapshot at begin, delta at read time (process-global
        # — concurrent queries share the delta, documented caveat)
        try:
            from spark_rapids_tpu_torch.trace import ledger as _ledger

            if _ledger.LEDGER.enabled:
                self._ledger_base[qid] = _ledger.snapshot()
        except Exception:
            pass

    def annotate(self, qid: int, **kv: Any) -> None:
        """Attach facts learned after begin (rendered plan, plan
        hash, tenant discovered at admission)."""
        if not self.enabled:
            return
        with self._lock:
            e = self._live.get(qid)
            if e is not None:
                e.update({k: v for k, v in kv.items()
                          if v is not None})

    def note_batch(self, qid: int, rows: int) -> None:
        """One streamed batch retired for this query (called from the
        streaming drain loop; collect-path queries report 0)."""
        if not self.enabled:
            return
        with self._lock:
            e = self._live.get(qid)
            if e is not None:
                e["batches"] += 1
                e["rows"] += int(rows)

    def finish(self, qid: int, engine: str = "tpu") -> None:
        """The shared epilogue: deregister + feed the completed
        observation (tenant, wall, admission wait) to the SLO
        watchdog's rolling windows."""
        if not self.enabled:
            # plane turned off mid-query: drop any stale entry.  The
            # common disabled path (nothing ever registered) is two
            # attribute reads and no lock.
            if self._live or self._ledger_base:
                with self._lock:
                    self._live.pop(qid, None)
                    self._ledger_base.pop(qid, None)
            return
        with self._lock:
            e = self._live.pop(qid, None)
            self._ledger_base.pop(qid, None)
        if e is None:
            return
        from spark_rapids_tpu_torch.obs import slo as _slo
        from spark_rapids_tpu_torch.serving import current_serving_context

        sctx = current_serving_context() or {}
        wall_ms = (time.perf_counter() - e["started_pc"]) * 1e3
        _slo.WATCHDOG.observe(
            tenant=e.get("tenant") or sctx.get("tenant") or "",
            wall_ms=wall_ms,
            admit_wait_ms=float(sctx.get("admit_wait_ms") or 0.0),
            engine=engine)

    def drop(self, qid: int) -> None:
        """Silent deregistration (no SLO observation): the collect
        paths' ``finally`` safety net, so a crashed query or an
        ABANDONED stream (generator closed early, nothing recorded)
        cannot leak a forever-\"in-flight\" /queries entry.  No-op —
        two attribute reads, no lock — after a normal finish()."""
        if self._live or self._ledger_base:
            with self._lock:
                self._live.pop(qid, None)
                self._ledger_base.pop(qid, None)

    def _entry_json(self, e: dict, with_plan: bool) -> dict:
        tok = e.get("token")
        out = {
            "query_id": e["query_id"],
            "tenant": e.get("tenant"),
            "conf_hash": e.get("conf_hash"),
            "plan_hash": e.get("plan_hash"),
            "started_ts": e["started_ts"],
            "elapsed_ms": round(
                (time.perf_counter() - e["started_pc"]) * 1e3, 1),
            "batches": e["batches"],
            "rows": e["rows"],
            "cancel": _describe_token(tok),
        }
        if with_plan:
            out["plan"] = e.get("plan")
        return out

    def snapshot(self) -> list[dict]:
        """The /queries JSON: every in-flight query, oldest first
        (plans elided — fetch /queries/<id> for one)."""
        with self._lock:
            entries = list(self._live.values())
        entries.sort(key=lambda e: e["started_ts"])
        return [self._entry_json(e, with_plan=False) for e in entries]

    def get(self, qid: int) -> Optional[dict]:
        """The /queries/<id> JSON: the full entry (rendered plan +
        per-op device-ledger metrics-so-far when the ledger is on)."""
        with self._lock:
            e = self._live.get(qid)
            base = self._ledger_base.get(qid)
        if e is None:
            return None
        out = self._entry_json(e, with_plan=True)
        if base is not None:
            try:
                from spark_rapids_tpu_torch.trace import ledger as _ledger

                out["operators"] = _ledger.per_op(
                    _ledger.delta(base, _ledger.snapshot()))
            except Exception:
                out["operators"] = None
        return out

    def cancel(self, qid: int, reason: str = "ops") -> bool:
        """Cancel one in-flight query via its registered token
        (POST /queries/<id>/cancel).  False when the query is gone or
        carries no token (cancellation tier off)."""
        with self._lock:
            e = self._live.get(qid)
        tok = e.get("token") if e else None
        if tok is None:
            return False
        tok.cancel(reason)
        return True

    def clear(self) -> None:
        with self._lock:
            self._live.clear()
            self._ledger_base.clear()


def _describe_token(tok: Any) -> Optional[dict]:
    if tok is None:
        return None
    try:
        from spark_rapids_tpu_torch.serving.cancel import describe_token

        return describe_token(tok)
    except Exception:
        return None


#: THE process registry (the session hooks' target)
REGISTRY = LiveQueryRegistry()


# ------------------------------------------------------------------ #
# Plane lifecycle (endpoint + watchdog + registry, one owner)
# ------------------------------------------------------------------ #


class OpsPlane:
    """Owns the three moving parts: the HTTP endpoint thread, the SLO
    watchdog thread and the registry's enabled flag.  One instance per
    process; ownership discipline mirrors the telemetry sampler."""

    def __init__(self) -> None:
        self.enabled = False
        self.forced = False
        self._enabled_by: Optional[weakref.ref] = None
        self._lock = threading.Lock()
        self._server = None

    @property
    def port(self) -> Optional[int]:
        srv = self._server
        return srv.port if srv is not None else None

    def start(self, port: Optional[int] = None,
              host: Optional[str] = None,
              forced: bool = True) -> None:
        from spark_rapids_tpu_torch.obs import slo as _slo
        from spark_rapids_tpu_torch.obs.server import OpsHttpServer

        with self._lock:
            self.forced = self.forced or forced
            if self.enabled:
                return
            self._server = OpsHttpServer(
                host=host or str(C.DEFAULTS[C.OBS_HOST]),
                port=int(C.DEFAULTS[C.OBS_PORT] if port is None
                         else port))
            self._server.start()
            REGISTRY.enabled = True
            _slo.WATCHDOG.start()
            self.enabled = True

    def stop(self) -> None:
        """Stop and join both threads and close the socket: after it no
        ``srt-obs-*`` thread and no bound port remain."""
        from spark_rapids_tpu_torch.obs import slo as _slo

        with self._lock:
            self.forced = False
            self._enabled_by = None
            if not self.enabled:
                return
            self.enabled = False
            srv, self._server = self._server, None
        REGISTRY.enabled = False
        REGISTRY.clear()
        _slo.WATCHDOG.stop()
        if srv is not None:
            srv.stop()

    def sync_conf(self, conf: C.TorchConf, writer=None) -> None:
        from spark_rapids_tpu_torch.obs import slo as _slo

        if self.forced:
            if self.enabled:
                _slo.WATCHDOG.sync_budgets(conf)
                _slo.WATCHDOG.attach_writer(writer)
            return
        want = bool(conf.get(C.OBS_ENABLED))
        if want:
            if not self.enabled:
                self.start(port=int(conf.get(C.OBS_PORT)),
                           host=str(conf.get(C.OBS_HOST)),
                           forced=False)
            self._enabled_by = weakref.ref(conf)
            _slo.WATCHDOG.sync_budgets(conf)
            _slo.WATCHDOG.attach_writer(writer)
        elif self.enabled and self._enabled_by is not None \
                and self._enabled_by() is conf:
            self.stop()


#: THE process plane
PLANE = OpsPlane()


def is_enabled() -> bool:
    return PLANE.enabled


def plane() -> OpsPlane:
    return PLANE


def start(port: Optional[int] = None,
          host: Optional[str] = None) -> None:
    """Force the plane on (tests, tools): survives ``sync_conf``."""
    PLANE.start(port=port, host=host, forced=True)


def stop() -> None:
    PLANE.stop()


def sync_conf(conf: C.TorchConf, writer=None) -> None:
    """Align the plane with a session's conf at a query boundary (one
    conf read while it is off)."""
    PLANE.sync_conf(conf, writer=writer)
