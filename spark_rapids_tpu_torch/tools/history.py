"""Cross-run analysis of persisted event logs.

Counterpart of ``spark_rapids_tpu/tools/history.py`` (the reference
profiling tool's offline side, ``ProfileMain``): ``load_application``
reads one run's event log (``eventlog/``) into an
:class:`ApplicationInfo`, and four analyses work on one or many:

- ``compare`` (CompareApplications): per-query wall and per-operator
  deltas of each run against the first, queries matched across runs by
  their plan's fingerprint, regressions flagged at a threshold;
- ``health`` (HealthCheck): the rule registry, HC001-HC017 (CPU
  fallbacks, retry storms, spill thrash, program-cache misses, blocking
  readbacks, starved pipelines, runtime filters that pruned nothing,
  recovered faults, admission waits over budget, dispatch-bound
  queries, rooflines and occupancy under their floors from the ledger's
  section, result-cache thrash, cancellation leaks and breaker trips,
  long lock holds, HC016 over the ops plane's SLO records, and HC017,
  a warm-start store that mostly missed while real compiles ran);
- ``report``: one markdown document of the runs' fingerprints, the
  compare, the work-sharing rollup and each run's health;
- ``dot`` (GenerateDot): a recorded plan as annotated graphviz.

The logs of either package load here, and the JAX tool reads the
port's.  A rule's budget is its key's value in the conf
``health_check`` is given, else the key's default.  HC017 reads the
warm-start store's program-tier counters (``persist.hits`` /
``.misses``) beside ``jit.compiles``: the port ports no program tier and
compiles nothing, so its own records carry 0 for all three and the
rule fires only on a record that carries them, such as an event log
the JAX package wrote.  Left out of the JAX tool: the loaders of the
JAX bench's and sweep's own round files.

CLI::

    python -m spark_rapids_tpu_torch.tools.history compare  LOG LOG... \
        [--threshold 1.25] [--json] [-o FILE]
    python -m spark_rapids_tpu_torch.tools.history health   LOG... [--json]
    python -m spark_rapids_tpu_torch.tools.history report   LOG LOG... \
        [--threshold 1.25] [-o FILE]
    python -m spark_rapids_tpu_torch.tools.history dot      LOG \
        [--query ID] [-o FILE]
"""

from __future__ import annotations

import contextvars
import dataclasses
import json
import os
from typing import Callable, Optional, Sequence

from spark_rapids_tpu_torch import config as C

# -- thresholds (health-rule defaults; compare takes --threshold) ----- #

#: wall-clock ratio at/above which compare flags a per-query regression
DEFAULT_REGRESSION_THRESHOLD = 1.25
#: ladder activity per query that reads as a retry STORM, not a blip
RETRY_STORM_FLOOR = 3
#: per-query device->host spill volume that reads as thrash
SPILL_THRASH_BYTES = 32 << 20
#: per-query compile-cache miss budget (a steady-state query should
#: re-use programs; sustained misses mean shape-bucketing is broken)
JIT_MISS_BUDGET = 16
#: per-query blocking-readback budget (speculative sizing exists to
#: drive the STEADY-STATE count to ~0; warm-up syncs, sort sample
#: fetches and the final result fetch are legitimate, hence the slack)
BLOCKING_READBACK_BUDGET = 32
#: pipeline occupancy below this, with real traffic, means stages ran
#: starved/serial (the items floor keeps tiny unit-test-sized queries
#: from reading as starvation)
OCCUPANCY_FLOOR = 0.05
OCCUPANCY_MIN_ITEMS = 32
#: HC010 (dispatch-overhead-dominated): at/above this many program
#: dispatches in one query AND device time under the share below, the
#: chip idled between launches — fuse chains / bucket shapes instead
DISPATCH_OVERHEAD_FLOOR = 64
DISPATCH_DEVICE_SHARE = 0.2
#: HC011 (roofline below budget) only engages past this much settled
#: device time — a 3ms unit query tells you nothing about the roofline
ROOFLINE_MIN_DEVICE_MS = 50.0
#: HC015 (pad-waste) likewise only engages past this much settled
#: device time — tiny queries legitimately ride part-full buckets
PAD_WASTE_MIN_DEVICE_MS = 50.0


# ------------------------------------------------------------------ #
# Model (the ApplicationInfo analog)
# ------------------------------------------------------------------ #


@dataclasses.dataclass
class OpNode:
    """One recorded operator: desc + settled metrics."""

    desc: str
    metrics: dict
    children: list

    @property
    def op(self) -> str:
        return self.desc.split(" ", 1)[0].split("[", 1)[0]

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


@dataclasses.dataclass
class QueryRecord:
    """One collected query, loaded from a log record."""

    query_id: object
    plan: str
    plan_hash: str
    engine: str
    wall_s: float
    start_ts: float
    end_ts: float
    conf_hash: str
    counters: dict
    operators: Optional[OpNode]
    spans: Optional[dict]
    pipeline: Optional[dict]
    faults: Optional[dict]
    result_digest: Optional[str]
    rows: Optional[int]
    raw: dict
    #: device-ledger attribution ({"programs": {...}, "totals": {...}},
    #: trace/ledger.py) — None when the ledger was off for this query
    programs: Optional[dict] = None
    #: cross-tenant work sharing ({"result_cache": verdict,
    #: "counters": {...}}, serving/work_share.py) — None when the
    #: sharing tier never engaged for this query
    sharing: Optional[dict] = None

    def counter(self, key: str, default: float = 0) -> float:
        return self.counters.get(key, default) or 0

    def program_totals(self) -> dict:
        """The ledger totals for this query ({} when unrecorded)."""
        return (self.programs or {}).get("totals") or {}

    def occupancy(self) -> Optional[float]:
        """Item-weighted pipeline occupancy, or
        None when the record carries no pipeline surface."""
        if not self.pipeline:
            return None
        weighted = items = 0.0
        for s in self.pipeline.values():
            n = s.get("items", 0)
            if n:
                weighted += s.get("occupancy_fraction", 0.0) * n
                items += n
        return round(weighted / items, 3) if items else None


@dataclasses.dataclass
class ApplicationInfo:
    """One run: header fingerprint + its query records."""

    path: str
    kind: str  # "eventlog"
    header: dict
    queries: list
    #: live-telemetry gauge samples (trace/telemetry.py records), in
    #: file order; empty for sampler-off runs
    telemetry: list = dataclasses.field(default_factory=list)
    #: SLO breach records (obs/slo.py watchdog emissions), in file
    #: order; HC016's input — empty for watchdog-off runs
    slo: list = dataclasses.field(default_factory=list)

    @property
    def label(self) -> str:
        return os.path.basename(self.path)

    @property
    def conf_hash(self) -> str:
        return self.header.get("conf_hash", "")

    def by_plan(self) -> dict[str, list]:
        out: dict[str, list] = {}
        for q in self.queries:
            out.setdefault(q.plan_hash, []).append(q)
        return out


def _op_from_dict(d: Optional[dict]) -> Optional[OpNode]:
    if not d:
        return None
    return OpNode(d.get("desc", "?"), dict(d.get("metrics", {})),
                  [_op_from_dict(c) for c in d.get("children", [])])


def _query_from_record(rec: dict) -> QueryRecord:
    return QueryRecord(
        query_id=rec.get("query_id"),
        plan=rec.get("plan", ""),
        plan_hash=rec.get("plan_hash", ""),
        engine=rec.get("engine", "tpu"),
        wall_s=float(rec.get("wall_s", 0.0)),
        start_ts=float(rec.get("start_ts", 0.0)),
        end_ts=float(rec.get("end_ts", 0.0)),
        conf_hash=rec.get("conf_hash", ""),
        counters=dict(rec.get("counters", {}) or {}),
        operators=_op_from_dict(rec.get("operators")),
        spans=rec.get("spans"),
        pipeline=rec.get("pipeline"),
        faults=rec.get("faults"),
        result_digest=rec.get("result_digest"),
        rows=rec.get("rows"),
        raw=rec,
        programs=rec.get("programs"),
        sharing=rec.get("sharing"),
    )


# ------------------------------------------------------------------ #
# Loading
# ------------------------------------------------------------------ #

def load_application(path: str) -> ApplicationInfo:
    """Load one run's event log (.jsonl or .jsonl.gz)."""
    from spark_rapids_tpu_torch.eventlog.reader import read_log_all

    header, recs, telemetry, slo = read_log_all(path)
    return ApplicationInfo(path, "eventlog", header or {},
                           [_query_from_record(r) for r in recs],
                           telemetry=telemetry, slo=slo)


# ------------------------------------------------------------------ #
# compare (the CompareApplications analog)
# ------------------------------------------------------------------ #


def _median_query(qs: Sequence[QueryRecord]) -> QueryRecord:
    """Representative record for repeated runs of one plan: the one
    with the median wall clock (a real record, so operator trees and
    counters stay attached)."""
    qs = sorted(qs, key=lambda q: q.wall_s)
    return qs[len(qs) // 2]


def _query_label(q: QueryRecord) -> str:
    if isinstance(q.query_id, str):
        return q.query_id
    root = q.operators.desc if q.operators else ""
    return f"q{q.query_id} [{root[:40]}]" if root \
        else f"q{q.query_id}"


def _operator_deltas(base: OpNode, run: OpNode,
                     threshold: float) -> list[dict]:
    """Positional walk of two recorded operator trees (same plan hash
    => same shape; a mismatch just truncates), reporting per-operator
    totalTime ratios past the threshold."""
    out: list[dict] = []

    def walk(a: Optional[OpNode], b: Optional[OpNode]) -> None:
        if a is None or b is None or a.op != b.op:
            return
        ta = a.metrics.get("totalTime") or 0
        tb = b.metrics.get("totalTime") or 0
        if ta >= 1e6 and tb >= 1e6:  # ignore sub-ms noise
            ratio = tb / ta
            if ratio >= threshold or ratio <= 1.0 / threshold:
                out.append({
                    "operator": a.desc[:60],
                    "base_ms": round(ta / 1e6, 2),
                    "run_ms": round(tb / 1e6, 2),
                    "ratio": round(ratio, 3),
                })
        for ca, cb in zip(a.children, b.children):
            walk(ca, cb)

    walk(base, run)
    return sorted(out, key=lambda d: -d["ratio"])


def _program_deltas(base: dict, run: dict,
                    threshold: float) -> list[dict]:
    """Per-PROGRAM device-time deltas between two recorded ledger
    sections (the `programs` query-record field): programs match by
    their structural key hash (stable across runs — the key is built
    from expression trees and capacities, never addresses), so a
    regression is pinned to the compiled program that slowed down, not
    just the operator class.  Programs present on only one side are
    reported as appeared/vanished — a changed fusion/bucketing
    decision shows up as churn here before it shows up as wall
    time."""
    bp = (base or {}).get("programs") or {}
    rp = (run or {}).get("programs") or {}
    out: list[dict] = []
    for key in sorted(set(bp) | set(rp)):
        b, r = bp.get(key), rp.get(key)
        if b is None or r is None:
            side = "appeared" if b is None else "vanished"
            p = r or b
            out.append({"program": key, "op": p.get("op"),
                        "change": side,
                        "device_ms": p.get("device_ms", 0.0),
                        "dispatches": p.get("dispatches", 0)})
            continue
        tb, tr = b.get("device_ms", 0.0), r.get("device_ms", 0.0)
        if tb >= 1.0 and tr >= 1.0:  # ignore sub-ms noise
            ratio = tr / tb
            if ratio >= threshold or ratio <= 1.0 / threshold:
                out.append({
                    "program": key, "op": r.get("op"),
                    "change": "ratio",
                    "base_ms": round(tb, 2), "run_ms": round(tr, 2),
                    "ratio": round(ratio, 3),
                    "base_dispatches": b.get("dispatches", 0),
                    "run_dispatches": r.get("dispatches", 0),
                })
    return sorted(out, key=lambda d: -d.get("ratio", 0.0))


def compare_applications(apps: Sequence[ApplicationInfo],
                         threshold: float =
                         DEFAULT_REGRESSION_THRESHOLD) -> dict:
    """Per-query wall-clock (and per-operator) deltas of every app
    against the FIRST (the baseline).  Queries match by plan
    fingerprint; repeated collects of one plan collapse to the
    median-wall record.  Returns a JSON-able result dict."""
    assert len(apps) >= 2, "compare needs a baseline and 1+ runs"
    base = apps[0]
    base_by_plan = {h: _median_query(qs)
                    for h, qs in base.by_plan().items()}
    rows: list[dict] = []
    regressions: list[dict] = []
    unmatched: list[dict] = []
    for app in apps[1:]:
        for h, qs in app.by_plan().items():
            rq = _median_query(qs)
            bq = base_by_plan.get(h)
            if bq is None or bq.wall_s <= 0:
                unmatched.append({"run": app.label,
                                  "query": _query_label(rq),
                                  "plan_hash": h,
                                  "wall_s": round(rq.wall_s, 4)})
                continue
            ratio = rq.wall_s / bq.wall_s
            flag = ("regression" if ratio >= threshold
                    else "improvement" if ratio <= 1.0 / threshold
                    else "ok")
            row = {
                "run": app.label,
                "query": _query_label(rq),
                "plan_hash": h,
                "base_wall_s": round(bq.wall_s, 4),
                "wall_s": round(rq.wall_s, 4),
                "ratio": round(ratio, 3),
                "flag": flag,
                "conf_changed": (bq.conf_hash != rq.conf_hash
                                 and bool(bq.conf_hash)
                                 and bool(rq.conf_hash)),
            }
            if bq.operators and rq.operators:
                row["operator_deltas"] = _operator_deltas(
                    bq.operators, rq.operators, threshold)
            if bq.programs and rq.programs:
                pd = _program_deltas(bq.programs, rq.programs,
                                     threshold)
                if pd:
                    row["program_deltas"] = pd
            rows.append(row)
            if flag == "regression":
                regressions.append(row)
        seen = set(app.by_plan())
        for h, bq in base_by_plan.items():
            if h not in seen:
                unmatched.append({"run": base.label,
                                  "query": _query_label(bq),
                                  "plan_hash": h,
                                  "wall_s": round(bq.wall_s, 4),
                                  "missing_in": app.label})
    return {"baseline": base.label, "threshold": threshold,
            "rows": rows, "regressions": regressions,
            "unmatched": unmatched}


# ------------------------------------------------------------------ #
# health (the HealthCheck analog)
# ------------------------------------------------------------------ #


@dataclasses.dataclass(frozen=True)
class HealthFinding:
    rule: str
    severity: str  # "info" | "warning" | "error"
    query: str
    message: str

    def render(self) -> str:
        return f"{self.severity:7s} {self.rule} {self.query} — " \
               f"{self.message}"


#: the conf whose keys budget the rules in this health_check (None:
#: the keys' defaults)
_CONF: contextvars.ContextVar = contextvars.ContextVar(
    "health_conf", default=None)


def _budget(key: str):
    conf = _CONF.get()
    return conf.get(key) if conf is not None else C.DEFAULTS[key]


#: rule registry: (rule_id, severity, check(QueryRecord) -> msg|None).
#: Register additional rules with :func:`register_health_rule`.
HEALTH_RULES: list[tuple[str, str,
                         Callable[[QueryRecord], Optional[str]]]] = []


def register_health_rule(rule_id: str, severity: str,
                         check: Callable[[QueryRecord], Optional[str]]
                         ) -> None:
    HEALTH_RULES.append((rule_id, severity, check))


def _hc_cpu_fallback(q: QueryRecord) -> Optional[str]:
    # engine + plan marker only: retry.cpu_fallbacks is a
    # process-global delta, and a CONCURRENT session's fallback
    # bleeding into this query's window must not flag a healthy run
    if q.engine != "tpu" or "[degraded to CPU engine" in q.plan:
        return ("query degraded to the CPU engine — the last ladder "
                "rung fired (docs/robustness.md)")
    return None


def _hc_retry_storm(q: QueryRecord) -> Optional[str]:
    n = q.counter("retry.splits") + q.counter("retry.task_retries")
    if n >= RETRY_STORM_FLOOR:
        return (f"retry storm: {int(q.counter('retry.splits'))} splits"
                f" + {int(q.counter('retry.task_retries'))} task "
                f"retries in one query (floor {RETRY_STORM_FLOOR}) — "
                "the device budget is undersized for this plan")
    return None


def _hc_spill_thrash(q: QueryRecord) -> Optional[str]:
    b = q.counter("spill.device_to_host_bytes")
    if b >= SPILL_THRASH_BYTES:
        disk = q.counter("spill.host_to_disk_bytes")
        msg = (f"spill thrash: {int(b)} device->host bytes in one "
               f"query (floor {SPILL_THRASH_BYTES})")
        if disk:
            msg += f", {int(disk)} of it on to disk"
        return msg
    return None


def _hc_jit_blowout(q: QueryRecord) -> Optional[str]:
    m = q.counter("jit.misses")
    if m > JIT_MISS_BUDGET:
        return (f"jit-cache miss budget blown: {int(m)} compiles in "
                f"one query (budget {JIT_MISS_BUDGET}) — shape "
                "bucketing / fuse keys are not stabilizing")
    return None


def _hc_blocking_readbacks(q: QueryRecord) -> Optional[str]:
    r = q.counter("pipeline.readbacks")
    if r > BLOCKING_READBACK_BUDGET:
        return (f"{int(r)} blocking device->host readbacks (budget "
                f"{BLOCKING_READBACK_BUDGET}) — speculative sizing is "
                "not engaging (docs/speculation.md)")
    return None


def _hc_starved_pipeline(q: QueryRecord) -> Optional[str]:
    occ = q.occupancy()
    if occ is None or not q.pipeline:
        return None
    items = sum(s.get("items", 0) for s in q.pipeline.values())
    if items >= OCCUPANCY_MIN_ITEMS and occ < OCCUPANCY_FLOOR:
        return (f"pipeline occupancy {occ} over {items} items — "
                "stages ran starved/serial (docs/pipeline.md)")
    return None


def _hc_rf_no_prune(q: QueryRecord) -> Optional[str]:
    if q.counter("rf.filters_built") > 0 \
            and q.counter("rf.pruned_rows") == 0 \
            and q.counter("rf.row_groups_pruned") == 0:
        return ("runtime filter built but pruned nothing — build cost "
                "paid for zero wire savings (docs/runtime_filters.md)")
    return None


def _hc_recovered_faults(q: QueryRecord) -> Optional[str]:
    n = q.counter("faults.recovered")
    if n > 0:
        return (f"{int(n)} injected fault(s) recovered in this query "
                "(chaos mode)")
    return None


def _hc_admission_wait(q: QueryRecord) -> Optional[str]:
    """HC009: this query's serving-tier admission wait blew the
    conf budget (spark.rapids.tpu.serving.health.admitWaitBudgetMs) —
    the serving tier is saturated for its traffic.  Fed from the
    serve.admit_wait_ms event-log counter the scheduler deposits per
    query; queries that never passed admission carry no counter and
    stay silent."""
    w = q.counter("serve.admit_wait_ms")
    if w <= 0:
        return None
    budget = float(_budget(C.SERVING_ADMIT_WAIT_BUDGET_MS))
    if w > budget:
        tenant = ""
        serving = q.raw.get("serving") or {}
        if serving.get("tenant"):
            tenant = f" (tenant {serving['tenant']!r})"
        return (f"admission wait {w:.0f}ms above the "
                f"{budget:.0f}ms budget{tenant} — the serving tier "
                "is saturated; raise serving.maxConcurrent, shed "
                "load, or add replicas (docs/serving.md)")
    return None


def _hc_dispatch_overhead(q: QueryRecord) -> Optional[str]:
    """HC010: dispatch-overhead-dominated query — the ledger recorded
    many program launches but the chip was busy for only a small
    share of the wall, so per-dispatch overhead (program-cache lookup,
    host argument marshalling, launches) dominated.  In a port record
    ``device_ms`` is the ledger's CUDA-event window, an upper bound of
    the device time."""
    totals = q.program_totals()
    disp = totals.get("dispatches") or 0
    device_ms = totals.get("device_ms") or 0.0
    if disp < DISPATCH_OVERHEAD_FLOOR or q.wall_s <= 0:
        return None
    if device_ms < DISPATCH_DEVICE_SHARE * q.wall_s * 1e3:
        return (f"dispatch-overhead-dominated: {int(disp)} program "
                f"dispatches but only {device_ms:.0f}ms device time "
                f"in {q.wall_s * 1e3:.0f}ms wall "
                f"(< {DISPATCH_DEVICE_SHARE:.0%}) — fuse chains / "
                "bucket shapes to cut launches "
                "(docs/device_ledger.md)")
    return None


def _hc_roofline_budget(q: QueryRecord) -> Optional[str]:
    """HC011: attributed roofline below budget — the query's programs
    burned real device time at a device-time-weighted roofline
    fraction under spark.rapids.tpu.trace.ledger.health.rooflineFloor.
    Only fires past ROOFLINE_MIN_DEVICE_MS of settled device time, so
    unit-test-sized queries stay silent."""
    totals = q.program_totals()
    device_ms = totals.get("device_ms") or 0.0
    roofline = totals.get("roofline")
    if roofline is None or device_ms < ROOFLINE_MIN_DEVICE_MS:
        return None
    floor = float(_budget(C.LEDGER_ROOFLINE_FLOOR))
    if roofline < floor:
        return (f"attributed roofline {roofline:.6f} below the "
                f"{floor} budget over {device_ms:.0f}ms device time — "
                "the chip ran far under its bandwidth roofline for "
                "this plan (docs/device_ledger.md)")
    return None


def _hc_result_cache_thrash(q: QueryRecord) -> Optional[str]:
    """HC012: cross-tenant result-cache thrash — this query's window
    evicted more cached results than it served while the hit rate sat
    under spark.rapids.tpu.serving.resultCache.health.minHitRate: the
    cache budget is too small for the fleet's working set, so entries
    churn host/disk bytes without ever amortizing device work.  Fed
    from the per-query share.* counter deltas the event log records
    (docs/work_sharing.md); sharing-off fleets carry no deltas and
    stay silent."""
    ev = q.counter("share.result_evictions")
    hits = q.counter("share.result_hits")
    misses = q.counter("share.result_misses")
    window = hits + misses
    if ev <= hits or window <= 0:
        return None
    floor = float(_budget(C.RESULT_MIN_HIT_RATE))
    rate = hits / window
    if rate < floor:
        return (f"result-cache thrash: {int(ev)} eviction(s) against "
                f"{int(hits)} hit(s) at a {rate:.2f} hit rate "
                f"(< {floor}) — the cache budget "
                "(serving.resultCache.budgetBytes) is too small for "
                "the fleet's working set (docs/work_sharing.md)")
    return None


def _hc_cancellation_leak(q: QueryRecord) -> Optional[str]:
    """HC013: cancellation-storm health.  Two triggers:

    (a) a CANCELLED query record (engine "cancelled" /
    "deadline_exceeded") whose end-of-query residency gauges —
    semaphore permits in use, live pipeline stage threads, in-flight
    shared-scan entries — did not return to zero: the unwind leaked.
    The gauges are process-wide, so a concurrent fleet may carry
    another query's residency here (warning severity for that
    reason); in a serialized storm replay a nonzero reading is a real
    leak (docs/robustness.md).

    (b) any query window whose cancel.breaker_trips counter delta
    exceeds spark.rapids.tpu.serving.breaker.health.maxTrips —
    tenants are crash-looping into quarantine faster than the fleet
    should tolerate (docs/serving.md)."""
    if q.engine in ("cancelled", "deadline_exceeded"):
        leaked = {g: int(q.counter(g)) for g in
                  ("semaphore.in_use", "pipeline.stage_threads",
                   "scan.inflight")
                  if q.counter(g) > 0}
        if leaked:
            return (f"{q.engine} query left nonzero residency gauges "
                    f"{leaked} at query end — the cooperative unwind "
                    "leaked (or a concurrent query held residency); "
                    "permits/stage threads/scan shares must return "
                    "to baseline (docs/robustness.md)")
    trips = q.counter("cancel.breaker_trips")
    if trips > 0:
        budget = int(_budget(C.BREAKER_MAX_TRIPS))
        if trips > budget:
            return (f"{int(trips)} circuit-breaker trip(s) in this "
                    f"query window (> {budget} budget, "
                    "serving.breaker.health.maxTrips) — a tenant is "
                    "crash-looping into quarantine "
                    "(docs/serving.md)")
    return None


def _hc_lock_hold(q: QueryRecord) -> Optional[str]:
    """HC014: tracked-lock hold over budget.  Only queries run with
    the lock tracker armed (robustness.lockTracker.enabled) carry a
    nonzero lock.max_hold_ms gauge; a reading over
    spark.rapids.tpu.robustness.lockTracker.holdBudgetMs means some
    engine registry mutex (plan cache, scan-share registry, breaker
    table, ...) was held long enough to serialize every thread
    population behind it during this query (docs/concurrency.md)."""
    hold_ms = q.counter("lock.max_hold_ms")
    if hold_ms <= 0:
        return None
    budget = float(_budget(C.LOCK_HOLD_BUDGET_MS))
    if hold_ms > budget:
        extra = ""
        cycles = q.counter("lock.cycles")
        if cycles > 0:
            extra = (f"; {int(cycles)} lock-order cycle(s) were also "
                     "detected in this window")
        return (f"a tracked engine lock was held for {hold_ms:.1f}ms "
                f"(> {budget:g}ms budget, "
                "robustness.lockTracker.holdBudgetMs) — long registry "
                "holds serialize the fleet behind one mutex"
                f"{extra} (docs/concurrency.md)")
    return None


def _hc_pad_waste(q: QueryRecord) -> Optional[str]:
    """HC015: pad-waste — the query's dispatches carried live rows
    for under spark.rapids.tpu.trace.ledger.health.occupancyFloor of
    their padded capacity while burning real device time (>=
    PAD_WASTE_MIN_DEVICE_MS settled): most of what the chip read was
    padding.  Coalesce small batches or switch the capacity policy to
    densify (docs/occupancy.md)."""
    totals = q.program_totals()
    device_ms = totals.get("device_ms") or 0.0
    ratio = totals.get("live_capacity_ratio")
    if ratio is None or device_ms < PAD_WASTE_MIN_DEVICE_MS:
        return None
    floor = float(_budget(C.LEDGER_OCCUPANCY_FLOOR))
    if ratio < floor:
        return (f"pad-waste: live/capacity ratio {ratio:.2f} below "
                f"the {floor:g} floor over {device_ms:.0f}ms device "
                "time — programs mostly processed padding; enable "
                "sql.coalesce.enabled or capacity.policy=pow2x3 "
                "(docs/occupancy.md)")
    return None


def _hc_persist_low_hit(q: QueryRecord) -> Optional[str]:
    """HC017: a cold process against a warm store that mostly missed:
    the query's window probed the program tier (persist.hits +
    persist.misses > 0), still paid real compiles (jit.compiles > 0),
    and its hit rate sat under spark.rapids.tpu.persist.health.
    minHitRate.  The entries did not match this process (a version,
    device or conf drift) or persist.dir is wrong.  Records of a
    process with persistence off carry no persist.* deltas."""
    hits = q.counter("persist.hits")
    misses = q.counter("persist.misses")
    window = hits + misses
    compiles = q.counter("jit.compiles")
    if window <= 0 or compiles <= 0:
        return None
    floor = float(_budget(C.PERSIST_MIN_HIT_RATE))
    rate = hits / window
    if rate < floor:
        return (f"warm-start cache mostly missed: persist hit rate "
                f"{rate:.2f} (< {floor}) with {int(compiles)} real "
                "compile(s) in this window — disk entries are stale "
                "(jax/device/conf drift) or persist.dir is wrong "
                "(docs/warm_start.md)")
    return None


for _id, _sev, _fn in (
        ("HC001", "error", _hc_cpu_fallback),
        ("HC002", "warning", _hc_retry_storm),
        ("HC003", "warning", _hc_spill_thrash),
        ("HC004", "warning", _hc_jit_blowout),
        ("HC005", "warning", _hc_blocking_readbacks),
        ("HC006", "warning", _hc_starved_pipeline),
        ("HC007", "warning", _hc_rf_no_prune),
        ("HC008", "info", _hc_recovered_faults),
        ("HC009", "warning", _hc_admission_wait),
        ("HC010", "warning", _hc_dispatch_overhead),
        ("HC011", "warning", _hc_roofline_budget),
        ("HC012", "warning", _hc_result_cache_thrash),
        ("HC013", "warning", _hc_cancellation_leak),
        ("HC014", "warning", _hc_lock_hold),
        ("HC015", "warning", _hc_pad_waste),
        ("HC017", "warning", _hc_persist_low_hit)):
    register_health_rule(_id, _sev, _fn)


def _hc016_slo_breaches(app: ApplicationInfo) -> list[HealthFinding]:
    """HC016: SLO budget breach — the obs watchdog (obs/slo.py)
    recorded a tenant's rolling percentile over its
    spark.rapids.tpu.obs.slo.* budget during this run.  Unlike
    HC001-HC015 this rule reads the run-level ``slo`` records, not a
    QueryRecord: one finding per (tenant, metric) pair summarizing the
    worst observed value, so a sustained breach doesn't flood the
    report with one line per watchdog tick (docs/ops_plane.md)."""
    worst: dict[tuple[str, str], dict] = {}
    count: dict[tuple[str, str], int] = {}
    for rec in app.slo:
        key = (rec.get("tenant") or "", rec.get("metric") or "")
        count[key] = count.get(key, 0) + 1
        prev = worst.get(key)
        if prev is None or rec.get("observed_ms", 0.0) \
                > prev.get("observed_ms", 0.0):
            worst[key] = rec
    out = []
    for (tenant, metric), rec in sorted(worst.items()):
        n = count[(tenant, metric)]
        out.append(HealthFinding(
            "HC016", "warning", f"tenant:{tenant or 'default'}",
            f"SLO breach: {metric} reached "
            f"{rec.get('observed_ms', 0.0):.0f}ms against a "
            f"{rec.get('budget_ms', 0.0):.0f}ms budget "
            f"({n} breach record(s) over a "
            f"{rec.get('window', 0)}-observation window) — "
            "the tenant ran over its obs.slo.* budget "
            "(docs/ops_plane.md)"))
    return out


def health_check(app: ApplicationInfo,
                 conf: Optional[C.TorchConf] = None
                 ) -> list[HealthFinding]:
    """Run every registered rule over every query of one run, plus
    the run-level rules (HC016, fed from the SLO breach records);
    ``conf``'s keys budget the rules (None: the defaults)."""
    token = _CONF.set(conf)
    try:
        out: list[HealthFinding] = []
        for q in app.queries:
            for rule_id, severity, check in HEALTH_RULES:
                msg = check(q)
                if msg is not None:
                    out.append(HealthFinding(rule_id, severity,
                                             _query_label(q), msg))
        out.extend(_hc016_slo_breaches(app))
        return out
    finally:
        _CONF.reset(token)


# ------------------------------------------------------------------ #
# report (the fleet-style regression report)
# ------------------------------------------------------------------ #


def _fmt_ratio(row: dict) -> str:
    mark = {"regression": " ⚠ REGRESSION", "improvement": " ✓",
            "ok": ""}[row["flag"]]
    extra = " (conf changed)" if row.get("conf_changed") else ""
    return f"{row['ratio']:.3f}x{mark}{extra}"


def render_compare_md(result: dict) -> str:
    lines = [
        f"## Compare (baseline: {result['baseline']}, "
        f"threshold {result['threshold']}x)",
        "",
        "| run | query | base_s | run_s | ratio |",
        "|---|---|---|---|---|",
    ]
    for row in result["rows"]:
        lines.append(
            f"| {row['run']} | {row['query']} | {row['base_wall_s']} "
            f"| {row['wall_s']} | {_fmt_ratio(row)} |")
    for row in result["rows"]:
        for od in row.get("operator_deltas", []):
            lines.append(
                f"- {row['run']} / {row['query']}: "
                f"`{od['operator']}` {od['base_ms']}ms -> "
                f"{od['run_ms']}ms ({od['ratio']}x)")
        for pd in row.get("program_deltas", []):
            if pd["change"] == "ratio":
                lines.append(
                    f"- {row['run']} / {row['query']}: program "
                    f"`{pd['program']}` ({pd['op']}) "
                    f"{pd['base_ms']}ms -> {pd['run_ms']}ms "
                    f"({pd['ratio']}x, "
                    f"{pd['base_dispatches']}->"
                    f"{pd['run_dispatches']} dispatches)")
            else:
                lines.append(
                    f"- {row['run']} / {row['query']}: program "
                    f"`{pd['program']}` ({pd['op']}) {pd['change']} "
                    f"({pd['device_ms']}ms, "
                    f"{pd['dispatches']} dispatches)")
    if result["unmatched"]:
        lines += ["", "Unmatched queries (no counterpart run):"]
        for u in result["unmatched"]:
            lines.append(f"- {u['run']}: {u['query']} "
                         f"({u['wall_s']}s)")
    n = len(result["regressions"])
    lines += ["", f"**{n} regression(s) at >= "
                  f"{result['threshold']}x**" if n else
              "No regressions at the threshold."]
    return "\n".join(lines) + "\n"


def render_health_md(apps: Sequence[ApplicationInfo]) -> str:
    lines = ["## Health"]
    for app in apps:
        findings = health_check(app)
        lines += ["", f"### {app.label}", ""]
        if not findings:
            lines.append("no findings — run is healthy")
            continue
        for f in findings:
            lines.append(f"- **{f.rule}** ({f.severity}) {f.query}: "
                         f"{f.message}")
    return "\n".join(lines) + "\n"


def render_sharing_md(apps: Sequence[ApplicationInfo]) -> str:
    """The cross-tenant work-sharing section (docs/work_sharing.md):
    per run, the result-cache verdict mix and the shared-scan dedup
    evidence aggregated from each query's share.* counter deltas.
    Empty string when no run ever engaged the sharing tier, so
    sharing-off fleets see no section at all."""
    rows = []
    for app in apps:
        agg = {"hits": 0, "misses": 0, "evictions": 0,
               "invalidations": 0, "units_shared": 0,
               "units_decoded": 0, "rows_decoded": 0}
        served = 0
        for q in app.queries:
            if q.sharing is not None:
                served += 1
            agg["hits"] += int(q.counter("share.result_hits"))
            agg["misses"] += int(q.counter("share.result_misses"))
            agg["evictions"] += int(
                q.counter("share.result_evictions"))
            agg["invalidations"] += int(
                q.counter("share.result_invalidations"))
            agg["units_shared"] += int(
                q.counter("share.scan_units_shared"))
            agg["units_decoded"] += int(
                q.counter("share.scan_units_decoded"))
            agg["rows_decoded"] += int(
                q.counter("share.scan_rows_decoded"))
        if served or any(agg.values()):
            rows.append((app.label, served, agg))
    if not rows:
        return ""
    lines = ["## Work sharing", "",
             "| run | shared queries | hits | misses | hit rate | "
             "evictions | invalidations | scan units shared | "
             "scan units decoded |",
             "|---|---|---|---|---|---|---|---|---|"]
    for label, served, a in rows:
        total = a["hits"] + a["misses"]
        rate = f"{a['hits'] / total:.2f}" if total else "-"
        lines.append(
            f"| {label} | {served} | {a['hits']} | {a['misses']} | "
            f"{rate} | {a['evictions']} | {a['invalidations']} | "
            f"{a['units_shared']} | {a['units_decoded']} |")
    return "\n".join(lines) + "\n"


def render_report(apps: Sequence[ApplicationInfo],
                  threshold: float = DEFAULT_REGRESSION_THRESHOLD
                  ) -> str:
    """The full fleet-style markdown report: run fingerprints, the
    cross-run compare, the work-sharing rollup (when any run engaged
    the sharing tier), per-run health."""
    lines = ["# Fleet regression report", "",
             "| run | kind | queries | conf hash | runtime | devices |",
             "|---|---|---|---|---|---|"]
    for app in apps:
        env = app.header.get("env", {}) or {}
        devs = env.get("devices") or []
        dev = f"{len(devs)}x {devs[0]['platform']}" if devs else ""
        runtime = (f"torch {env['torch']}" if env.get("torch")
                   else f"jax {env['jax']}" if env.get("jax") else "-")
        lines.append(
            f"| {app.label} | {app.kind} | {len(app.queries)} | "
            f"{app.conf_hash or '-'} | {runtime} | {dev or '-'} |")
    lines.append("")
    if len(apps) >= 2:
        lines.append(render_compare_md(
            compare_applications(apps, threshold)))
    sharing = render_sharing_md(apps)
    if sharing:
        lines.append(sharing)
    lines.append(render_health_md(apps))
    return "\n".join(lines)


# ------------------------------------------------------------------ #
# dot (the GenerateDot analog)
# ------------------------------------------------------------------ #


def generate_dot(q: QueryRecord) -> str:
    """Annotated plan graph for one recorded query (rows + wall time
    per operator, health-relevant counters in the graph label)."""
    lines = ["digraph plan {",
             "  node [shape=box fontname=monospace];",
             f'  label="query {q.query_id} — {q.wall_s:.3f}s wall '
             f'({q.engine})";']
    if q.operators is None:
        lines.append('  n0 [label="(no operator snapshot recorded)"];')
        lines.append("}")
        return "\n".join(lines)
    ids: dict[int, int] = {}

    def nid(n: OpNode) -> int:
        if id(n) not in ids:
            ids[id(n)] = len(ids)
        return ids[id(n)]

    for n in q.operators.walk():
        label = n.desc.replace("\\", "\\\\").replace('"', "'")[:80]
        rows = n.metrics.get("numOutputRows")
        t = n.metrics.get("totalTime")
        if rows:
            label += f"\\nrows={rows}"
        if t:
            label += f"\\ntime={t / 1e6:.2f}ms"
        lines.append(f'  n{nid(n)} [label="{label}"];')
        for c in n.children:
            lines.append(f"  n{nid(c)} -> n{nid(n)};")
    lines.append("}")
    return "\n".join(lines)


# ------------------------------------------------------------------ #
# CLI
# ------------------------------------------------------------------ #


def _write_out(text: str, out: Optional[str]) -> None:
    if out:
        with open(out, "w") as f:
            f.write(text)
        print(f"wrote {out}")
    else:
        print(text)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_tpu_torch.tools.history",
        description="event-log analysis: compare / health / report / "
                    "dot")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("compare", help="per-query deltas across runs")
    p.add_argument("logs", nargs="+",
                   help="event logs (the first is the baseline)")
    p.add_argument("--threshold", type=float,
                   default=DEFAULT_REGRESSION_THRESHOLD)
    p.add_argument("--json", action="store_true")
    p.add_argument("-o", "--out", default=None)

    p = sub.add_parser("health", help="flag unhealthy runs")
    p.add_argument("logs", nargs="+")
    p.add_argument("--json", action="store_true")
    p.add_argument("-o", "--out", default=None)

    p = sub.add_parser("report",
                       help="markdown fleet regression report")
    p.add_argument("logs", nargs="+")
    p.add_argument("--threshold", type=float,
                   default=DEFAULT_REGRESSION_THRESHOLD)
    p.add_argument("-o", "--out", default=None)

    p = sub.add_parser("dot", help="annotated plan graphviz")
    p.add_argument("logs", nargs=1)
    p.add_argument("--query", type=int, default=None,
                   help="query id (default: the slowest query)")
    p.add_argument("-o", "--out", default=None)

    args = ap.parse_args(argv)
    apps = [load_application(p) for p in args.logs]

    if args.cmd == "compare":
        if len(apps) < 2:
            ap.error("compare needs >= 2 logs")
        result = compare_applications(apps, args.threshold)
        text = json.dumps(result, indent=1) if args.json \
            else render_compare_md(result)
        _write_out(text, args.out)
        return 1 if result["regressions"] else 0
    if args.cmd == "health":
        findings = {app.label: health_check(app) for app in apps}
        if args.json:
            text = json.dumps(
                {k: [dataclasses.asdict(f) for f in v]
                 for k, v in findings.items()}, indent=1)
        else:
            text = render_health_md(apps)
        _write_out(text, args.out)
        return 1 if any(f.severity == "error"
                        for v in findings.values() for f in v) else 0
    if args.cmd == "report":
        _write_out(render_report(apps, args.threshold), args.out)
        return 0
    # dot
    app = apps[0]
    if not app.queries:
        ap.error(f"{app.label} holds no query records")
    if args.query is not None:
        q = next((q for q in app.queries
                  if q.query_id == args.query), None)
        if q is None:
            ap.error(f"query id {args.query} not in {app.label}")
    else:
        q = max(app.queries, key=lambda q: q.wall_s)
    _write_out(generate_dot(q), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
