"""The ``/metrics`` body: OpenMetrics text over the engine's counters.

Counterpart of ``spark_rapids_tpu/obs/metrics.py``.  A metric exists
here if and only if its key exists on one of four sources, and its name
is derived from the key, so a scrape equals the in-process snapshot
and a new event-log counter shows with no code:

- ``eventlog.counters_snapshot()`` -> ``tpu_<key . -> _>`` —
  ``_total``-suffixed counter families for MONOTONIC_COUNTERS keys,
  gauges for the residency gauges riding the same snapshot;
- ``telemetry.sample_now()`` -> ``tpu_telemetry_<key>`` gauges (the
  sampler's fleet-load view, namespaced because its keys overlap the
  snapshot's);
- ``scheduler.scheduler_stats()`` + per-tenant wait stats ->
  ``tpu_serving_<key>`` gauges (``tenant=``-labelled where
  per-tenant);
- the device ledger's per-op rollup -> ``tpu_ledger_<field>`` gauges
  labelled ``op=``.

The names keep the JAX package's ``tpu_`` prefix, so one scraper reads
either package's processes.
"""

from __future__ import annotations

from typing import Optional


def metric_name(key: str, prefix: str = "tpu") -> str:
    """The mechanical derivation: eventlog/telemetry key ->
    OpenMetrics sample name."""
    return f"{prefix}_{key.replace('.', '_').replace('-', '_')}"


def counter_metric_name(key: str) -> str:
    """Monotonic counters additionally carry the OpenMetrics
    ``_total`` suffix."""
    return metric_name(key) + "_total"


def _fmt(value) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    if value is None:
        return "0"
    f = float(value)
    return repr(int(f)) if f == int(f) else repr(f)


def _labels(kv: dict) -> str:
    if not kv:
        return ""
    inner = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", "\\\\")
                         .replace('"', '\\"').replace("\n", " "))
        for k, v in sorted(kv.items()))
    return "{" + inner + "}"


def families() -> list[tuple[str, str, list[tuple[dict, float]]]]:
    """Every family as (name, type, [(labels, value), ...]): what the
    text renderer and a parity check read."""
    from spark_rapids_tpu_torch import obs as _obs
    from spark_rapids_tpu_torch.eventlog import (
        MONOTONIC_COUNTERS,
        counters_snapshot,
    )
    from spark_rapids_tpu_torch.serving.scheduler import scheduler_stats
    from spark_rapids_tpu_torch.trace import ledger as _ledger
    from spark_rapids_tpu_torch.trace.telemetry import sample_now

    out: list[tuple[str, str, list[tuple[dict, float]]]] = []
    monotonic = set(MONOTONIC_COUNTERS)
    for key, val in sorted(counters_snapshot().items()):
        if key in monotonic:
            out.append((counter_metric_name(key), "counter",
                        [({}, val)]))
        else:
            out.append((metric_name(key), "gauge", [({}, val)]))
    for key, val in sorted(sample_now().items()):
        out.append((metric_name(key, "tpu_telemetry"), "gauge",
                    [({}, val)]))
    for key, val in sorted(scheduler_stats().items()):
        out.append((metric_name(key, "tpu_serving"), "gauge",
                    [({}, val)]))
    try:
        from spark_rapids_tpu_torch.serving.scheduler import tenant_wait_stats

        waits = tenant_wait_stats()
    except Exception:
        waits = {}
    for field in ("wait_p50_ms", "wait_p99_ms", "admitted"):
        samples = [({"tenant": t}, s.get(field, 0))
                   for t, s in sorted(waits.items())]
        if samples:
            out.append((metric_name(f"tenant.{field}", "tpu_serving"),
                        "gauge", samples))
    out.append(("tpu_queries_in_flight", "gauge",
                [({}, _obs.REGISTRY.count())]))
    if _ledger.LEDGER.enabled:
        per_op = _ledger.per_op(_ledger.snapshot())
        for field in ("window_ms", "dispatches", "roofline_lower_bound",
                      "live_capacity_ratio"):
            samples = [({"op": op}, v[field])
                       for op, v in sorted(per_op.items())
                       if v.get(field) is not None]
            if samples:
                out.append((metric_name(f"ledger.{field}"), "gauge",
                            samples))
    return out


def openmetrics_text() -> str:
    """The /metrics body: OpenMetrics text exposition, terminated by
    the spec's ``# EOF`` marker."""
    lines: list[str] = []
    for name, mtype, samples in families():
        lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            lines.append(f"{name}{_labels(labels)} {_fmt(value)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def parse_openmetrics(text: str) -> dict[str, dict]:
    """An exposition back as {name: {"type": t, "samples":
    {labels_str: value}}} (stdlib only)."""
    out: dict[str, dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line == "# EOF":
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, mtype = rest.partition(" ")
            out.setdefault(name, {"type": mtype.strip(),
                                  "samples": {}})
            continue
        if line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        name, labels = head, ""
        if "{" in head:
            name, _, rest = head.partition("{")
            labels = "{" + rest
        out.setdefault(name, {"type": "untyped", "samples": {}})
        out[name]["samples"][labels] = float(val)
    return out


def scrape_value(parsed: dict, name: str,
                 labels: str = "") -> Optional[float]:
    fam = parsed.get(name)
    if fam is None:
        return None
    return fam["samples"].get(labels)
