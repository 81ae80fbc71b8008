"""The query history, per-query operator reports and device traces.

Counterpart of ``spark_rapids_tpu/tools/profiling.py`` (the reference
profiling tool's ``ProfileMain`` / ``ApplicationInfo`` over a run's
queries).  Each collected query of a session is recorded in its
:class:`QueryHistory`: the plan's text and a snapshot of its exec tree's
settled metrics (rows, batches, ``totalTime``, the execs' own counters).
``render_analyze`` is ``DataFrame.explain("analyze")``'s text,
``profile_report`` a whole session's, ``generate_dot`` a plan graph, and
``device_trace`` a ``torch.profiler`` capture exported as a Chrome
trace.

A snapshot is taken on the query's thread once its metrics are settled
(the metric reaper flushed), never later: a prepared query's cached
tree is drained again by its next execution, so a snapshot taken after
the query returned could read the next execution's work.  With a
``baseline`` (the tree's snapshot before the drain) the recorded
metrics are the execution's own deltas.  Only the ``on_event`` hook
(the event log's record) runs on the process's one history worker.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Iterator, Optional, Sequence

#: process-wide query ids: the trace buffer is shared by every session,
#: so two sessions must never hand out the same one
_QUERY_IDS = itertools.count(1)
_QUERY_IDS_LOCK = threading.Lock()


def next_query_id() -> int:
    with _QUERY_IDS_LOCK:
        return next(_QUERY_IDS)


@dataclasses.dataclass
class NodeSnapshot:
    """One operator's description and settled metric values (a
    snapshot, not the live exec: that would hold the query's inputs for
    the session's life)."""

    desc: str
    metrics: dict
    children: list


@dataclasses.dataclass
class QueryEvent:
    """One collected query: its id, plan text, operator snapshot, wall
    time, when it ran (epoch ``start_ts`` / ``end_ts``, monotonic
    ``start_ns`` / ``end_ns`` on the tracer's clock) and its conf's
    fingerprint."""

    query_id: int
    explain: str
    root: NodeSnapshot
    wall_s: float
    ts: float
    start_ts: float = 0.0
    end_ts: float = 0.0
    start_ns: int = 0
    end_ns: int = 0
    conf_hash: str = ""


def snapshot_exec(node) -> NodeSnapshot:
    """The settled metrics of an exec tree: waits for the metric
    reaper's pending regions first."""
    from spark_rapids_tpu_torch.execs.base import REAPER

    REAPER.flush()
    return _snap(node)


def _snap(node) -> NodeSnapshot:
    from spark_rapids_tpu_torch.execs.base import metric_values

    return NodeSnapshot(node.node_desc(), metric_values(node),
                        [_snap(c) for c in node.children])


def snapshot_delta(after: NodeSnapshot,
                   before: Optional[NodeSnapshot]) -> NodeSnapshot:
    """Per-metric ``after - before`` of two snapshots of one tree
    (positional; numbers clamped at 0, anything else as ``after``)."""
    if before is None:
        return after
    mets: dict = {}
    for k, v in after.metrics.items():
        b = before.metrics.get(k)
        if isinstance(v, (int, float)) and isinstance(b, (int, float)) \
                and not isinstance(v, bool):
            mets[k] = max(0, v - b)
        else:
            mets[k] = v
    kids = [snapshot_delta(c, before.children[i]
                           if i < len(before.children) else None)
            for i, c in enumerate(after.children)]
    return NodeSnapshot(after.desc, mets, kids)


#: the operator node of a query that ran no exec (a result-cache hit)
PLACEHOLDER_DESC = "ResultCacheHit [no operators executed]"


class QueryHistory:
    """A session's ring of recent :class:`QueryEvent`s.  ``record`` adds
    the event at once; its ``on_event`` hook runs on the process's one
    history worker, and every reader of :attr:`events` waits for the
    hooks submitted so far."""

    #: the process's one worker (a pool a session would leak a thread a
    #: session)
    _pool = None
    _pool_lock = threading.Lock()

    @classmethod
    def _worker(cls):
        import concurrent.futures

        with cls._pool_lock:
            if cls._pool is None:
                cls._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="srt-query-history")
            return cls._pool

    @classmethod
    def shutdown_worker(cls) -> None:
        """Finish the queued hooks and stop the worker thread (a later
        record starts a new one)."""
        with cls._pool_lock:
            pool, cls._pool = cls._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def __init__(self, capacity: int = 100):
        self.capacity = capacity
        self._events: list[QueryEvent] = []
        self._pending: list = []
        self._mu = threading.Lock()

    @staticmethod
    def allocate_id() -> int:
        """The next query id, claimed before execution so that spans and
        the event share it."""
        return next_query_id()

    def record(self, explain: str, exec_tree, wall_s: float,
               query_id: Optional[int] = None, start_ts: float = 0.0,
               end_ts: float = 0.0, start_ns: int = 0, end_ns: int = 0,
               conf_hash: str = "", on_event=None,
               baseline: Optional[NodeSnapshot] = None) -> QueryEvent:
        """Snapshot ``exec_tree`` (minus ``baseline``) now, on the
        calling thread, and add the event; ``on_event(ev)`` runs on the
        worker.  ``exec_tree`` None records the placeholder node."""
        if query_id is None:
            query_id = next_query_id()
        if exec_tree is None:
            root = NodeSnapshot(PLACEHOLDER_DESC, {}, [])
        else:
            root = snapshot_delta(snapshot_exec(exec_tree), baseline)
        ev = QueryEvent(query_id, explain, root, wall_s, time.time(),
                        start_ts=start_ts, end_ts=end_ts,
                        start_ns=start_ns, end_ns=end_ns,
                        conf_hash=conf_hash)
        with self._mu:
            self._events.append(ev)
            if len(self._events) > self.capacity:
                self._events.pop(0)
        if on_event is not None:
            def hook():
                try:
                    on_event(ev)
                except Exception as exc:  # noqa: BLE001 - warned
                    # a failed append (a full disk) must not fail every
                    # later read of the history: the query succeeded
                    import warnings

                    warnings.warn(
                        f"query-history on_event hook failed for query "
                        f"{ev.query_id}: {exc!r}", RuntimeWarning)

            with self._mu:
                self._pending = [f for f in self._pending if not f.done()]
                self._pending.append(self._worker().submit(hook))
        return ev

    def drain(self) -> None:
        """Wait for every hook submitted so far."""
        with self._mu:
            pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    @property
    def events(self) -> list[QueryEvent]:
        self.drain()
        with self._mu:
            return list(self._events)


def _walk_snap(s: NodeSnapshot):
    yield s
    for c in s.children:
        yield from _walk_snap(c)


def _op_key(desc: str) -> str:
    """The exec class a description starts with (the trace spans'
    ``op``)."""
    return desc.split(" ", 1)[0].split("[", 1)[0]


def _jit_cache_line(cache_stats: Optional[dict]) -> Optional[str]:
    """The program cache's hits and misses of one query (a delta of
    ``execs/jit_cache.cache_stats``)."""
    if cache_stats is None:
        return None
    hits = cache_stats.get("hits", 0)
    misses = cache_stats.get("misses", 0)
    total = hits + misses
    rate = f"{hits / total:.2f}" if total else "n/a"
    return f"jit cache: hits={hits} misses={misses} hit_rate={rate}"


def _counter_footer(counters: Optional[dict]) -> list[str]:
    """The retry ladder's, the fault registry's, the runtime filters'
    and the plan cache's activity of one query (deltas), as the event
    log records them."""
    if not counters:
        return []
    lines = []
    r = counters.get("retry")
    if r is not None:
        line = (f"retry: splits={r.get('splits', 0)} "
                f"spill_retries={r.get('spill_retries', 0)} "
                f"task_retries={r.get('task_retries', 0)} "
                f"cpu_fallbacks={r.get('cpu_fallbacks', 0)}")
        if "faults_recovered" in counters:
            line += f"; recovered_faults={counters['faults_recovered']}"
        lines.append(line)
    rf = counters.get("rf")
    if rf is not None:
        lines.append(
            f"runtime filters: built={rf.get('filters_built', 0)} "
            f"pruned_rows={rf.get('pruned_rows', 0)} "
            f"row_groups_pruned={rf.get('row_groups_pruned', 0)}")
    pc = counters.get("plan_cache")
    if pc is not None:
        lines.append(
            f"plan cache: hits={pc.get('hits', 0)} "
            f"misses={pc.get('misses', 0)} "
            f"evictions={pc.get('evictions', 0)}")
    return lines


def _ledger_footer(ledger: Optional[dict]) -> list[str]:
    """The device ledger's totals and top programs of one query (a
    ``trace.ledger.summarize`` of its delta).  Device ms are CUDA-event
    windows: they hold the host's launch gaps."""
    if not ledger:
        return []
    t = ledger.get("totals") or {}
    roof = t.get("roofline_lower_bound")
    lcr = t.get("live_capacity_ratio")
    lines = [
        f"device ledger: programs={t.get('programs', 0)} "
        f"dispatches={t.get('dispatches', 0)} "
        f"device_ms={t.get('window_ms', 0.0):.2f} "
        f"dispatch_ms={t.get('dispatch_ms', 0.0):.2f} "
        + (f"roofline={roof:.6f}" if roof is not None else "roofline=n/a")
        + (f" live/cap={lcr:.2f}" if lcr is not None else "")]
    progs = ledger.get("programs") or {}
    for p in t.get("top") or []:
        eff = (progs.get(p["key"]) or {}).get("roofline_lower_bound")
        plcr = p.get("live_capacity_ratio")
        lines.append(
            f"  top: {p['key']} op={p['op'] or '-'} "
            f"dispatches={p['dispatches']} "
            f"device_ms={p['window_ms']:.2f} share={p['share']:.0%}"
            + (f" eff={eff:.6f}" if eff is not None else " eff=n/a")
            + (f" live/cap={plcr:.2f}" if plcr is not None else ""))
    return lines


def profile_query(ev: QueryEvent, trace_events: Optional[Sequence] = None,
                  cache_stats: Optional[dict] = None,
                  counters: Optional[dict] = None,
                  ledger: Optional[dict] = None) -> str:
    """One query's operator table; with ``trace_events`` a ``self_ms``
    column (the union of each operator's spans of this query)."""
    stats: dict = {}
    if trace_events is not None:
        from spark_rapids_tpu_torch.trace.export import span_stats

        stats = span_stats(trace_events, query_id=ev.query_id)
    self_col = " self_ms |" if stats else ""
    lines = [
        f"== Query {ev.query_id} ({ev.wall_s:.3f}s wall) ==",
        "",
        f"| operator | rows | batches | time_ms |{self_col} other metrics |",
        f"|---|---|---|---|{'---|' if stats else ''}---|",
    ]
    for n in _walk_snap(ev.root):
        m = dict(n.metrics)
        rows = m.pop("numOutputRows", "")
        batches = m.pop("numOutputBatches", "")
        t = m.pop("totalTime", None)
        others = [f"{k}={v}" for k, v in sorted(m.items()) if v]
        t_ms = f"{t / 1e6:.2f}" if t is not None else ""
        extra = ""
        if stats:
            st = stats.get(_op_key(n.desc))
            extra = f" {st['wall_ns'] / 1e6:.2f} |" if st else "  |"
        lines.append(f"| {n.desc[:60]} | {rows} | {batches} | {t_ms} |"
                     f"{extra} {' '.join(others)} |")
    footer = [] if cache_stats is None else [_jit_cache_line(cache_stats)]
    footer += _counter_footer(counters)
    footer += _ledger_footer(ledger)
    if footer:
        lines += [""] + footer
    return "\n".join(lines) + "\n"


def render_analyze(ev: QueryEvent, trace_events: Optional[Sequence] = None,
                   cache_stats: Optional[dict] = None,
                   counters: Optional[dict] = None,
                   ledger: Optional[dict] = None) -> str:
    """EXPLAIN ANALYZE: the plan after its run, each operator with its
    settled metrics (``time`` is ``totalTime``; rows, batches, the
    exec's own nonzero counters); with ``trace_events`` the span
    busy / self / overlap of its class; with ``ledger`` its attributed
    roofline; then the footers."""
    stats: dict = {}
    if trace_events is not None:
        from spark_rapids_tpu_torch.trace.export import span_stats

        stats = span_stats(trace_events, query_id=ev.query_id)
    op_roof: dict = {}
    if ledger:
        from spark_rapids_tpu_torch.trace.ledger import per_op

        op_roof = per_op(ledger.get("programs") or {})
    lines = [f"== Physical Plan (ANALYZE, query {ev.query_id}, "
             f"{ev.wall_s:.3f}s wall) =="]

    def walk(n: NodeSnapshot, indent: int) -> None:
        m = n.metrics
        ann = []
        t = m.get("totalTime")
        if t is not None:
            ann.append(f"time={t / 1e6:.2f}ms")
        ann.append(f"rows={m.get('numOutputRows', 0)}")
        ann.append(f"batches={m.get('numOutputBatches', 0)}")
        st = stats.get(_op_key(n.desc))
        if st:
            ann.append(f"span(busy={st['busy_ns'] / 1e6:.2f}ms "
                       f"self={st['wall_ns'] / 1e6:.2f}ms "
                       f"overlap={st['overlap_ns'] / 1e6:.2f}ms)")
        lr = op_roof.get(_op_key(n.desc))
        if lr:
            roof = lr["roofline_lower_bound"]
            ann.append(
                "roofline=" + (f"{roof:.6f}" if roof is not None else "n/a")
                + f" device={lr['window_ms']:.2f}ms"
                  f" dispatches={lr['dispatches']}"
                + (f" live/cap={lr['live_capacity_ratio']:.2f}"
                   if lr.get("live_capacity_ratio") is not None else ""))
        extras = {k: v for k, v in m.items()
                  if k not in ("totalTime", "numOutputRows",
                               "numOutputBatches") and v}
        if extras:
            ann.append(" ".join(f"{k}={v}"
                                for k, v in sorted(extras.items())))
        lines.append("  " * indent + "+- " + n.desc
                     + "  [" + " ".join(ann) + "]")
        for c in n.children:
            walk(c, indent + 1)

    walk(ev.root, 0)
    jc = _jit_cache_line(cache_stats)
    if jc is not None:
        lines.append(jc)
    lines.extend(_counter_footer(counters))
    lines.extend(_ledger_footer(ledger))
    return "\n".join(lines) + "\n"


def profile_report(history: QueryHistory) -> str:
    """A session's report: the store's bytes and spills, then each
    query's operator table."""
    from spark_rapids_tpu_torch.memory.store import peek_store

    store = peek_store()
    ss = store.spill_stats() if store is not None else {}
    events = history.events
    lines = [
        "# Profile report",
        "",
        f"queries: {len(events)}",
        "",
        "## Memory / spill health",
        "",
        f"- device bytes in store: {ss.get('device_used', 0)}",
        f"- host bytes in store: {ss.get('host_used', 0)}",
        f"- spilled device->host: {ss.get('spilled_device_to_host', 0)}",
        f"- spilled host->disk: {ss.get('spilled_host_to_disk', 0)}",
        "",
        "## Queries",
        "",
    ]
    for ev in events:
        lines.append(profile_query(ev))
    return "\n".join(lines)


@contextlib.contextmanager
def device_trace(trace_dir: str) -> Iterator[object]:
    """Profile the enclosed work with ``torch.profiler`` (the host and,
    with CUDA, the card's kernels) and write it as a Chrome trace,
    ``<trace_dir>/trace.json`` (Perfetto, chrome://tracing); yields the
    profiler."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def generate_dot(ev: QueryEvent) -> str:
    """The recorded plan as a graphviz DOT graph."""
    lines = ["digraph plan {", "  node [shape=box fontname=monospace];"]
    ids: dict[int, int] = {}

    def nid(n) -> int:
        if id(n) not in ids:
            ids[id(n)] = len(ids)
        return ids[id(n)]

    for n in _walk_snap(ev.root):
        rows = n.metrics.get("numOutputRows")
        label = n.desc.replace("\\", "\\\\").replace('"', "'")[:80]
        if rows:
            label += f"\\nrows={rows}"
        lines.append(f'  n{nid(n)} [label="{label}"];')
        for c in n.children:
            lines.append(f"  n{nid(c)} -> n{nid(n)};")
    lines.append("}")
    return "\n".join(lines)
