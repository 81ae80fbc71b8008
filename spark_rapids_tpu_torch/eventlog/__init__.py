"""The persistent event log: the engine's signals, written to disk.

Counterpart of ``spark_rapids_tpu/eventlog/__init__.py``:

- an append-only JSONL file a session (``eventLog.compress``: gzip, one
  member an append, so a crashed run keeps every finished record), one
  ``header`` record (environment, conf and mesh fingerprints) and then
  one ``query`` record a query: the plan, the settled operator tree,
  span statistics with tracing on, the counters as per-query deltas,
  the result digest, the serving, sharing and ``connect`` sections,
  and the device ledger's programs with the ledger on;
- ``telemetry`` records from the gauge sampler and ``slo`` records from
  the ops plane's watchdog;
- the fingerprints the serving tier keys by (``conf_fingerprint``,
  ``plan_fingerprint``, ``table_digest``) and ``render_plan_report``,
  ``DataFrame.explain()``'s text.

The schema is ``eventlog/schema.py``, the reader ``eventlog/reader.py``,
the analyses ``tools/history.py``.  A record has the JAX package's key
set, so either package's tools read either's logs.  Counters of
subsystems the port has no counterpart of are recorded as 0: the
persisted-plan tier (``persist.*``, ``persist_cache.bytes``), device
placement (``placement.*``), XLA compiles (``jit.compiles``: torch
compiles nothing) and the CPU-fallback rung of the retry ladder
(``retry.cpu_fallbacks``).  ``env_fingerprint`` records torch's and
CUDA's versions and the card's name; ``mesh_fingerprint`` is None (one
card).

Off (``spark.rapids.tpu.eventLog.enabled`` false, the default) a session
holds no writer and a query pays one ``is not None`` check.  On, the
two counter snapshots run on the query's thread at its boundaries; the
record is built and appended on the query history's worker.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import re
import threading
import time
from typing import Any, Optional

import pyarrow as pa

from spark_rapids_tpu_torch import config as C

#: tells two sessions' files apart within one process
_SESSION_SEQ = itertools.count()

#: the cumulative process counters a record holds as per-query deltas
MONOTONIC_COUNTERS = (
    "jit.hits", "jit.misses", "jit.compiles",
    "persist.hits", "persist.misses", "persist.writes",
    "persist.evictions", "persist.errors",
    "persist.plan_hits", "persist.result_hits",
    "persist.fallback_compiles",
    "persist.deserialize_ms", "persist.serialize_ms",
    "retry.splits", "retry.spill_retries", "retry.task_retries",
    "retry.cpu_fallbacks",
    "faults.injected", "faults.recovered",
    "rf.filters_built", "rf.build_rows", "rf.build_ms",
    "rf.pruned_rows", "rf.row_groups_pruned",
    "speculation.hits", "speculation.overflows", "speculation.synced",
    "speculation.disabled",
    "placement.host_uploads", "placement.device_born",
    "placement.d2d_transfers",
    "pipeline.readbacks", "pipeline.async_readbacks", "pipeline.items",
    "spill.device_to_host_bytes", "spill.host_to_disk_bytes",
    "share.result_hits", "share.result_misses",
    "share.result_evictions", "share.result_invalidations",
    "share.scan_subscribes", "share.scan_units_shared",
    "share.scan_units_decoded", "share.scan_rows_decoded",
    "cancel.cancelled", "cancel.deadline_exceeded",
    "cancel.breaker_trips", "cancel.quarantined",
    "lock.acquisitions", "lock.contention_waits", "lock.cycles",
)

#: the keys with no counterpart in the port, recorded as 0
_ABSENT = ("jit.compiles", "persist.hits", "persist.misses",
           "persist.writes", "persist.evictions", "persist.errors",
           "persist.plan_hits", "persist.result_hits",
           "persist.fallback_compiles", "persist.deserialize_ms",
           "persist.serialize_ms", "persist_cache.bytes",
           "retry.cpu_fallbacks", "placement.host_uploads",
           "placement.device_born", "placement.d2d_transfers")


def counters_snapshot() -> dict[str, float]:
    """One flat snapshot of every process counter the log persists:
    the keys of :data:`MONOTONIC_COUNTERS` and the gauges (the store's
    bytes, the result cache's bytes, the residency gauges read at a
    query's end, the longest lock hold), which a record keeps as
    read."""
    from spark_rapids_tpu_torch.execs.jit_cache import cache_stats
    from spark_rapids_tpu_torch.execs.retry import retry_stats
    from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
    from spark_rapids_tpu_torch.memory.store import peek_store
    from spark_rapids_tpu_torch.parallel import speculation
    from spark_rapids_tpu_torch.parallel.pipeline import (
        live_stage_threads,
        stage_snapshot,
    )
    from spark_rapids_tpu_torch.plan import runtime_filter
    from spark_rapids_tpu_torch.robustness import faults, lock_tracker
    from spark_rapids_tpu_torch.serving import cancel as _cancel
    from spark_rapids_tpu_torch.serving import work_share

    out: dict[str, float] = dict.fromkeys(_ABSENT, 0)
    jc = cache_stats()
    out["jit.hits"] = jc["hits"]
    out["jit.misses"] = jc["misses"]
    rs = retry_stats()
    out["retry.splits"] = rs["splits"]
    out["retry.spill_retries"] = rs["spill_retries"]
    out["retry.task_retries"] = rs["task_retries"]
    out["faults.injected"] = faults.injected_total()
    out["faults.recovered"] = faults.recovered_total()
    rf = runtime_filter.stats()
    out["rf.filters_built"] = rf["filters_built"]
    out["rf.build_rows"] = rf["build_rows"]
    out["rf.build_ms"] = round(rf["build_ms"], 3)
    out["rf.pruned_rows"] = rf["pruned_rows"]
    out["rf.row_groups_pruned"] = rf["row_groups_pruned"]
    sp = speculation.stats()
    out["speculation.hits"] = sum(s["hits"] for s in sp.values())
    out["speculation.overflows"] = sum(
        s["overflows"] for s in sp.values())
    out["speculation.synced"] = sum(s["synced"] for s in sp.values())
    out["speculation.disabled"] = speculation.disabled_total()
    st = stage_snapshot()
    out["pipeline.readbacks"] = sum(s["readbacks"] for s in st.values())
    out["pipeline.async_readbacks"] = sum(
        s["async_readbacks"] for s in st.values())
    out["pipeline.items"] = sum(s["items"] for s in st.values())
    store = peek_store()
    ss = store.spill_stats() if store is not None else {}
    out["spill.device_to_host_bytes"] = ss.get("spilled_device_to_host", 0)
    out["spill.host_to_disk_bytes"] = ss.get("spilled_host_to_disk", 0)
    out["store.device_used"] = ss.get("device_used", 0)
    out["store.host_used"] = ss.get("host_used", 0)
    ws = work_share.stats()
    for k in ("result_hits", "result_misses", "result_evictions",
              "result_invalidations", "scan_subscribes",
              "scan_units_shared", "scan_units_decoded",
              "scan_rows_decoded", "result_bytes"):
        out["share." + k] = ws[k]
    cs = _cancel.stats()
    for k in ("cancelled", "deadline_exceeded", "breaker_trips",
              "quarantined"):
        out["cancel." + k] = cs[k]
    # residency gauges: read at a query's end they are the HC013 leak
    # surface (a cancelled query's record must show them at baseline)
    out["semaphore.in_use"] = TpuSemaphore.usage_now()["in_use"]
    out["pipeline.stage_threads"] = live_stage_threads()
    out["scan.inflight"] = work_share.SCAN_REGISTRY.inflight()
    ls = lock_tracker.aggregate_stats()
    out["lock.acquisitions"] = ls["acquisitions"]
    out["lock.contention_waits"] = ls["contention_waits"]
    out["lock.cycles"] = ls["cycles"]
    out["lock.max_hold_ms"] = ls["max_hold_ms"]
    return out


def counters_delta(before: dict, after: dict) -> dict[str, float]:
    """A query's counters: after - before for the monotonic keys
    (clamped at 0: a concurrent reset between the two snapshots must
    not read as negative work), the gauges as ``after`` holds them."""
    out: dict[str, float] = {}
    for k in MONOTONIC_COUNTERS:
        d = after.get(k, 0) - before.get(k, 0)
        out[k] = round(max(0, d), 3) if isinstance(d, float) else max(0, d)
    for k, v in after.items():
        if k not in MONOTONIC_COUNTERS:
            out[k] = v
    return out


# ------------------------------------------------------------------ #
# Fingerprints
# ------------------------------------------------------------------ #

_PATH_RE = re.compile(r"(?:/[\w.\-]+){2,}")
_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")


def plan_fingerprint(plan_text: str) -> str:
    """A stable identity of a query template across runs: the plan
    text with temporary paths and object addresses normalized away,
    hashed."""
    norm = _ADDR_RE.sub("<addr>", plan_text)
    norm = _PATH_RE.sub("<path>", norm)
    return hashlib.sha256(norm.encode()).hexdigest()[:16]


def conf_fingerprint(conf) -> str:
    """Hash of the conf's explicitly set values: the conf epoch two
    lowered plans must share to be interchangeable."""
    payload = json.dumps(
        sorted((k, str(v)) for k, v in conf._values.items()))
    return hashlib.sha256(payload.encode()).hexdigest()[:12]


def table_digest(tbl: pa.Table) -> str:
    """Content digest of an Arrow table (its IPC stream bytes): two
    results are equal bit for bit when their digests are."""
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, tbl.schema) as w:
        for b in tbl.combine_chunks().to_batches():
            w.write_batch(b)
    return hashlib.sha256(memoryview(sink.getvalue())).hexdigest()[:16]


def env_fingerprint() -> dict:
    """The host and runtime of the header record: Python, the host,
    torch's and CUDA's versions and the card (``devices`` in the JAX
    record's shape: platform ``gpu`` and the card's name, or ``cpu``)."""
    import platform as _plat

    import torch

    out: dict[str, Any] = {
        "python": _plat.python_version(),
        "hostname": _plat.node(),
        "machine": _plat.machine(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    if torch.cuda.is_available():
        out["devices"] = [{"platform": "gpu",
                           "kind": torch.cuda.get_device_name(i)}
                          for i in range(torch.cuda.device_count())]
    else:
        out["devices"] = [{"platform": "cpu", "kind": _plat.machine()}]
    return out


def mesh_fingerprint() -> Optional[dict]:
    """None: the port runs on one card (no device mesh)."""
    return None


def render_plan_report(exec_, meta) -> str:
    """The tagged logical tree, the physical plan, the runtime-filter
    sites and the UDF tiers: exactly ``DataFrame.explain()``'s text for
    a lowered plan."""
    from spark_rapids_tpu_torch.plan.runtime_filter import (
        render_runtime_filters,
    )
    from spark_rapids_tpu_torch.session import render_udfs

    return "\n".join([meta.explain().rstrip("\n"), exec_.tree_string(),
                      *render_runtime_filters(exec_),
                      *render_udfs(meta.plan)])


def _snapshot_to_dict(snap) -> dict:
    """A ``NodeSnapshot`` tree in the schema's operator-node shape."""
    return {"desc": snap.desc, "metrics": dict(snap.metrics),
            "children": [_snapshot_to_dict(c) for c in snap.children]}


# ------------------------------------------------------------------ #
# The writer
# ------------------------------------------------------------------ #


class EventLogWriter:
    """The append-only JSONL log of one session.  The file is made by
    the first record (a session that runs nothing writes nothing), and
    each append opens, writes and closes it: no file stays open between
    records, and a crashed run keeps every finished one.  A query's
    counter snapshots are taken on
    its thread at its boundaries (:meth:`query_begin`,
    :meth:`query_end`: a later reset or disarm would erase them); its
    record is built and appended on the history's worker."""

    def __init__(self, conf: C.TorchConf):
        self.directory = str(conf.get(C.EVENTLOG_DIR))
        self.compress = bool(conf.get(C.EVENTLOG_COMPRESS))
        self.trace_sidecar = bool(conf.get(C.EVENTLOG_TRACE_SIDECAR))
        self.session_id = (f"s{os.getpid()}-{int(time.time() * 1e3)}"
                           f"-{next(_SESSION_SEQ)}")
        ext = ".jsonl.gz" if self.compress else ".jsonl"
        self.path = os.path.join(
            self.directory, f"eventlog-{self.session_id}{ext}")
        self._conf = conf
        self._wrote_header = False
        self._mu = threading.Lock()

    def _write_locked(self, lines: list[str]) -> None:
        os.makedirs(self.directory, exist_ok=True)
        text = "".join(line + "\n" for line in lines)
        if self.compress:
            # a gzip member an append: each record's trailer lands with
            # it, and concatenated members are one valid gzip stream
            import gzip

            with gzip.open(self.path, "at", encoding="utf-8") as f:
                f.write(text)
            return
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(text)

    def append(self, rec: dict) -> None:
        """Validate and write one record (the header first, once).  An
        invalid record fails here, in the session that made it."""
        from spark_rapids_tpu_torch.eventlog.schema import validate_record

        validate_record(rec)
        lines = [json.dumps(rec, default=str)]
        with self._mu:
            if not self._wrote_header:
                hdr = self._header_record()
                validate_record(hdr)
                lines.insert(0, json.dumps(hdr, default=str))
            self._write_locked(lines)
            # only once the write succeeded: a failed first append
            # writes the header with the next
            self._wrote_header = True

    # -- records ----------------------------------------------------- #

    def _header_record(self) -> dict:
        from spark_rapids_tpu_torch.eventlog.schema import SCHEMA_VERSION

        return {
            "type": "header",
            "schema_version": SCHEMA_VERSION,
            "ts": time.time(),
            "session": self.session_id,
            "pid": os.getpid(),
            "env": env_fingerprint(),
            "conf": {k: str(v) for k, v in
                     sorted(self._conf._values.items())},
            "conf_hash": conf_fingerprint(self._conf),
            "mesh": mesh_fingerprint(),
        }

    def query_begin(self) -> dict:
        """The counters before a query, and the ledger's snapshot with
        the ledger on (the ``programs`` section is a delta too)."""
        from spark_rapids_tpu_torch.trace import ledger as _ledger

        pre = {"counters": counters_snapshot()}
        if _ledger.LEDGER.enabled:
            pre["ledger"] = _ledger.snapshot()
        return pre

    def query_end(self, pre: dict) -> dict:
        """A query's end, on its thread: the counter deltas, the stage
        snapshot, the fault sites, and the serving context's facts
        (admission wait, tenant, plan- and result-cache verdicts: they
        are learnt before ``query_begin``, outside the delta window) as
        counters and as the ``serving``, ``sharing`` and ``connect``
        sections."""
        from spark_rapids_tpu_torch.parallel.pipeline import stage_snapshot
        from spark_rapids_tpu_torch.robustness import faults
        from spark_rapids_tpu_torch.serving import current_serving_context
        from spark_rapids_tpu_torch.trace import ledger as _ledger

        programs = None
        if pre.get("ledger") is not None and _ledger.LEDGER.enabled:
            # the result fetch forced the device work: this settles at
            # once; a wedged settle degrades the section, not the query
            _ledger.LEDGER.flush(timeout=2.0)
            d = _ledger.delta(pre["ledger"], _ledger.snapshot())
            if d:
                programs = _with_jax_names(_ledger.summarize(d))
        counters = counters_delta(pre["counters"], counters_snapshot())
        sctx = current_serving_context()
        # the wire front door's facts are a section of their own
        connect = sctx.pop("connect", None) if sctx else None
        if sctx:
            if "admit_wait_ms" in sctx:
                counters["serve.admit_wait_ms"] = sctx["admit_wait_ms"]
            if "plan_cache" in sctx:
                counters["serve.plan_cache_hit"] = \
                    1 if sctx["plan_cache"] == "hit" else 0
            if "result_cache" in sctx:
                counters["serve.result_cache_hit"] = \
                    1 if sctx["result_cache"] == "hit" else 0
        share_delta = {k: v for k, v in counters.items()
                       if k.startswith("share.")}
        verdict = (sctx or {}).get("result_cache")
        sharing = None
        # only true deltas make a section: the result_bytes gauge holds
        # the cache's footprint whoever filled it
        if verdict is not None or any(
                v for k, v in share_delta.items()
                if k != "share.result_bytes"):
            sharing = {"result_cache": verdict, "counters": share_delta}
        return {
            "counters": counters,
            "pipeline": stage_snapshot(),
            "faults": faults.fault_stats() or None,
            "serving": sctx,
            "sharing": sharing,
            "connect": connect,
            "programs": programs,
        }

    def build_query_record(self, ev, post: dict, plan_text: str,
                           engine: str,
                           result_digest: Optional[str] = None,
                           rows: Optional[int] = None) -> dict:
        """A query record from its settled ``QueryEvent`` and its
        :meth:`query_end` capture."""
        from spark_rapids_tpu_torch import trace as _trace
        from spark_rapids_tpu_torch.eventlog.schema import SCHEMA_VERSION

        spans = None
        trace_file = None
        if _trace.is_enabled():
            from spark_rapids_tpu_torch.trace.export import (
                export_chrome_trace,
                span_stats,
            )

            events = _trace.snapshot()
            spans = span_stats(events, query_id=ev.query_id)
            if self.trace_sidecar:
                trace_file = os.path.join(
                    self.directory,
                    f"{self.session_id}-q{ev.query_id}.trace.json")
                try:
                    os.makedirs(self.directory, exist_ok=True)
                    export_chrome_trace(trace_file, events)
                except OSError:
                    trace_file = None
        return {
            "type": "query",
            "schema_version": SCHEMA_VERSION,
            "query_id": ev.query_id,
            "plan": plan_text,
            "plan_hash": plan_fingerprint(plan_text),
            "engine": engine,
            "wall_s": ev.wall_s,
            "start_ts": ev.start_ts,
            "end_ts": ev.end_ts,
            "start_ns": ev.start_ns,
            "end_ns": ev.end_ns,
            "conf_hash": ev.conf_hash,
            "counters": post["counters"],
            "operators": _snapshot_to_dict(ev.root),
            "spans": spans,
            "pipeline": post["pipeline"],
            "faults": post["faults"],
            "serving": post.get("serving"),
            "sharing": post.get("sharing"),
            "connect": post.get("connect"),
            "programs": post.get("programs"),
            "result_digest": result_digest,
            "rows": rows,
            "trace_file": trace_file,
        }

    def log_query(self, ev, post: dict, plan_text: str, engine: str,
                  result_digest: Optional[str] = None,
                  rows: Optional[int] = None) -> None:
        self.append(self.build_query_record(
            ev, post, plan_text, engine, result_digest, rows))

    def log_slo(self, breach: dict) -> None:
        """One SLO breach record (the ops plane's watchdog; HC016's
        input)."""
        from spark_rapids_tpu_torch.eventlog.schema import SCHEMA_VERSION

        self.append({
            "type": "slo",
            "schema_version": SCHEMA_VERSION,
            "ts": float(breach.get("ts") or time.time()),
            "session": self.session_id,
            "tenant": str(breach.get("tenant") or ""),
            "metric": str(breach["metric"]),
            "observed_ms": float(breach["observed_ms"]),
            "budget_ms": float(breach["budget_ms"]),
            "window": int(breach.get("window") or 0),
        })

    def log_telemetry(self, sample: dict) -> None:
        """One gauge sample of the telemetry sampler."""
        from spark_rapids_tpu_torch.eventlog.schema import SCHEMA_VERSION

        self.append({
            "type": "telemetry",
            "schema_version": SCHEMA_VERSION,
            "ts": time.time(),
            "session": self.session_id,
            "counters": dict(sample),
        })


def _with_jax_names(summary: dict) -> dict:
    """The ledger's summary with the JAX record's names beside the
    port's, so either package's history tool reads the section:
    ``device_ms`` is the CUDA-event window (it holds the host's launch
    gaps: an upper bound of the device time), ``roofline`` the lower
    bound ``roofline_lower_bound``."""
    for p in summary["programs"].values():
        p["device_ms"] = p["window_ms"]
        p["roofline"] = p.get("roofline_lower_bound")
    t = summary["totals"]
    t["device_ms"] = t["window_ms"]
    t["roofline"] = t.get("roofline_lower_bound")
    for p in t["top"]:
        p["device_ms"] = p["window_ms"]
    return summary


def maybe_writer(conf: C.TorchConf) -> Optional[EventLogWriter]:
    """A session's writer with the event log on, else None."""
    if not conf.get(C.EVENTLOG_ENABLED):
        return None
    return EventLogWriter(conf)
