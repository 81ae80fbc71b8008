"""Trace exporters and span analytics.

Counterpart of ``spark_rapids_tpu/trace/export.py``.

- :func:`chrome_trace` / :func:`export_chrome_trace` — Chrome Trace
  Format JSON (the ``traceEvents`` array form) from the process trace
  buffer.  Loads in Perfetto (ui.perfetto.dev) or chrome://tracing,
  beside a ``torch.profiler`` capture of the same run.
- :func:`merge_wire_trace` — folds a client's wire spans into such a
  document (the port has no connect client yet; the function is kept
  so the document format is the JAX package's).
- :func:`span_stats` — per-operator busy/wall/overlap aggregation over
  ``exec.*`` spans: *busy* is the
  summed span time (across threads/partitions), *wall* the union of
  the intervals (span-derived self-time: how long the operator was
  running anywhere), and *overlap* = busy - wall (time at least two of
  its spans ran concurrently — proof the pipeline actually overlapped).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

from spark_rapids_tpu_torch.trace import TraceEvent, snapshot


def chrome_trace(events: Optional[Sequence[TraceEvent]] = None) -> dict:
    """Chrome Trace Format dict (JSON Object Format with a
    ``traceEvents`` array; timestamps in microseconds)."""
    if events is None:
        events = snapshot()
    pid = os.getpid()
    out: list[dict] = []
    named: set[int] = set()
    for ev in events:
        if ev.tid not in named:
            named.add(ev.tid)
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": ev.tid,
                        "args": {"name": ev.thread_name}})
        rec = {"name": ev.name, "ph": ev.ph, "pid": pid, "tid": ev.tid,
               "ts": ev.ts_ns / 1e3, "cat": "engine",
               "args": dict(ev.attrs)}
        if ev.ph == "X":
            rec["dur"] = ev.dur_ns / 1e3
        elif ev.ph == "C":
            # counter sample (the telemetry tracks): args ARE the
            # series values; Perfetto stacks them into a counter track
            pass
        else:
            rec["s"] = "t"  # thread-scoped instant
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str,
                        events: Optional[Sequence[TraceEvent]] = None
                        ) -> str:
    """Write the Chrome-trace JSON; returns the path."""
    doc = chrome_trace(events)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def merge_wire_trace(doc: dict, client_spans: Sequence[dict],
                     label: str = "connect-client") -> dict:
    """Fold a connect client's wire spans (plain dicts —
    ``ConnectClient.trace_spans``, engine-free by design) into a
    :func:`chrome_trace` document IN PLACE and return it: both sides
    stamp ``perf_counter_ns``, so for an in-process loopback (the
    tests' and bench's shape) client send/first-byte/last-byte spans
    and the server's trace_id-tagged engine spans land on ONE
    timeline.  Client spans get their own named thread track.  For a
    genuinely remote client the clocks are unrelated — align
    externally before merging."""
    events = doc.setdefault("traceEvents", [])
    if not client_spans:
        return doc
    pid = os.getpid()
    tid = max((e.get("tid", 0) for e in events
               if isinstance(e.get("tid", 0), int)), default=0) + 1
    events.append({"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": tid, "args": {"name": label}})
    for sp in client_spans:
        events.append({
            "name": sp["name"], "ph": sp.get("ph", "X"), "pid": pid,
            "tid": tid, "ts": sp["ts_ns"] / 1e3,
            "dur": sp.get("dur_ns", 0) / 1e3, "cat": "wire",
            "args": dict(sp.get("attrs") or {}),
        })
    return doc


def _union_ns(intervals: list[tuple[int, int]]) -> int:
    intervals.sort()
    total = 0
    cs, ce = intervals[0]
    for s, e in intervals[1:]:
        if s > ce:
            total += ce - cs
            cs, ce = s, e
        else:
            ce = max(ce, e)
    return total + (ce - cs)


def span_stats(events: Sequence[TraceEvent],
               query_id: Optional[int] = None,
               attr: str = "op") -> dict[str, dict]:
    """Aggregate spans by an attribute (default: the exec spans' `op`),
    optionally restricted to one query id.  Per key:
    ``{"spans", "busy_ns", "wall_ns", "overlap_ns"}`` (see module doc
    for the busy/wall/overlap semantics)."""
    per: dict[str, list[tuple[int, int]]] = {}
    for ev in events:
        if ev.ph != "X":
            continue
        key = ev.attrs.get(attr)
        if key is None:
            continue
        if query_id is not None \
                and ev.attrs.get("query_id") != query_id:
            continue
        per.setdefault(str(key), []).append((ev.ts_ns, ev.end_ns))
    out: dict[str, dict] = {}
    for key, iv in per.items():
        busy = sum(e - s for s, e in iv)
        wall = _union_ns(iv)
        out[key] = {"spans": len(iv), "busy_ns": busy, "wall_ns": wall,
                    "overlap_ns": busy - wall}
    return out
