"""`top` for the serving tier: a terminal live view over the ops
plane's HTTP endpoints (``obs/``).

Counterpart of ``spark_rapids_tpu/tools/top.py``.  Engine-free: the
standard library and ``obs/metrics.parse_openmetrics`` (which imports no
torch) only.  It polls ``/queries``, ``/slo`` and ``/metrics`` over HTTP,
so it runs from any machine that reaches the endpoint, against a
process it did not start; the metric names keep the ``tpu_`` prefix, so
it reads either package's plane.

Run::

    python -m spark_rapids_tpu_torch.tools.top [--url http://127.0.0.1:PORT]
        [--interval 1.0] [--once]

`--once` prints a single frame and exits (the test mode); otherwise
the screen redraws every ``--interval`` seconds until Ctrl-C.
"""

from __future__ import annotations

import json
import sys
import time
import urllib.request

_GAUGES = (
    ("in flight", "tpu_queries_in_flight"),
    ("sem in use", "tpu_semaphore_in_use"),
    ("adm running", "tpu_telemetry_admission_running"),
    ("adm waiting", "tpu_telemetry_admission_waiting"),
    ("store dev B", "tpu_telemetry_store_device_bytes"),
    ("result $ B", "tpu_telemetry_result_cache_bytes"),
)


def _get(url: str, timeout: float = 2.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode("utf-8")


def _metric(parsed: dict, name: str) -> float:
    fam = parsed.get(name) or {"samples": {}}
    return fam["samples"].get("", 0.0)


def render_frame(base_url: str) -> str:
    """One frame of the live view (also the test surface): header
    gauges, the in-flight query table, per-tenant SLO percentiles."""
    from spark_rapids_tpu_torch.obs.metrics import parse_openmetrics

    queries = json.loads(_get(base_url + "/queries"))
    slo = json.loads(_get(base_url + "/slo"))
    parsed = parse_openmetrics(_get(base_url + "/metrics"))
    lines = [f"tpu-top — {base_url}  "
             f"({time.strftime('%H:%M:%S')})", ""]
    lines.append("  ".join(
        f"{label}: {_metric(parsed, name):g}"
        for label, name in _GAUGES))
    lines += ["", f"in-flight queries ({len(queries)}):",
              f"{'qid':>6} {'tenant':<12} {'elapsed':>10} "
              f"{'batches':>8} {'rows':>10} {'cancel':<10} plan"]
    for q in queries:
        cancel = "-"
        if q.get("cancel"):
            c = q["cancel"]
            cancel = c.get("reason") or (
                "armed" if c.get("deadline_remaining_s") is not None
                else "token")
        lines.append(
            f"{q['query_id']:>6} {(q.get('tenant') or '-'):<12} "
            f"{q['elapsed_ms']:>8.1f}ms {q['batches']:>8} "
            f"{q['rows']:>10} {cancel:<10} "
            f"{(q.get('plan_hash') or '')[:12]}")
    tenants = slo.get("tenants", {})
    lines += ["", f"slo (window {slo['budgets']['window_s']:g}s, "
                  f"breaches {slo.get('breach_count', 0)}):",
              f"{'tenant':<12} {'n':>6} {'wall p50':>10} "
              f"{'wall p99':>10} {'wait p99':>10}"]
    for t, s in sorted(tenants.items()):
        lines.append(
            f"{(t or '-'):<12} {s['n']:>6} "
            f"{s['wall_p50_ms']:>8.1f}ms {s['wall_p99_ms']:>8.1f}ms "
            f"{s['admit_wait_p99_ms']:>8.1f}ms")
    for b in slo.get("breaches", [])[-3:]:
        lines.append(f"  BREACH {b['tenant']!r} {b['metric']} "
                     f"{b['observed_ms']:.1f}ms > "
                     f"{b['budget_ms']:g}ms (n={b['window']})")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_tpu_torch.tools.top",
        description="terminal live view over the ops plane "
                    "(obs/)")
    ap.add_argument("--url", default="http://127.0.0.1:9100",
                    help="ops-plane base URL (spark.rapids.tpu.obs.*)")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit")
    args = ap.parse_args(argv)
    base = args.url.rstrip("/")
    try:
        while True:
            frame = render_frame(base)
            if args.once:
                print(frame)
                return 0
            # clear + home, then the frame: flicker-free enough for a
            # 1 Hz operator view without a curses dependency
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    except OSError as e:
        print(f"tpu-top: cannot reach {base}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
