"""Trace tool: run a workload with the tracer on and export a
Chrome-trace JSON timeline.

Counterpart of ``spark_rapids_tpu/tools/trace.py``.

Usage::

    python -m spark_rapids_tpu_torch.tools.trace [-o trace.json]
                                                 [--buffer N]
                                                 script.py [args...]

Runs ``script.py`` in this process (so the engine's process state, the
trace rings among it, is shared) with tracing forced on (``trace.enable``
wins over every session's conf), then writes the spans and events
through ``trace/export.py`` as Chrome Trace Format JSON, even when the
script exits early.  Open it in Perfetto (ui.perfetto.dev) or
chrome://tracing; ``tools.profiling.device_trace`` captures the card's
kernels of a run to lay beside it.

In-process alternative: ``session.export_trace(path)`` after queries run
with ``spark.rapids.tpu.trace.enabled``.
"""

from __future__ import annotations

import argparse
import runpy
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_tpu_torch.tools.trace",
        description="run a python workload with engine tracing enabled "
                    "and export a Chrome-trace JSON (Perfetto-viewable)")
    ap.add_argument("-o", "--output", default="trace.json",
                    help="output Chrome-trace JSON path "
                         "(default: trace.json)")
    ap.add_argument("--buffer", type=int, default=None,
                    help="per-thread ring-buffer capacity "
                         "(default: spark.rapids.tpu.trace.bufferSize)")
    ap.add_argument("script", help="python script to run under tracing")
    ap.add_argument("args", nargs=argparse.REMAINDER,
                    help="arguments passed to the script")
    args = ap.parse_args(argv)

    from spark_rapids_tpu_torch import trace
    from spark_rapids_tpu_torch.trace.export import export_chrome_trace

    trace.enable(args.buffer)
    old_argv = sys.argv
    sys.argv = [args.script] + list(args.args)
    code = 0
    try:
        try:
            runpy.run_path(args.script, run_name="__main__")
        except SystemExit as e:  # still export what was traced
            code = int(e.code or 0) if not isinstance(e.code, str) else 1
    finally:
        sys.argv = old_argv
        events = trace.snapshot()
        path = export_chrome_trace(args.output, events)
        dropped = trace.TRACER.dropped()
        print(f"wrote {path}: {len(events)} events"
              + (f" ({dropped} evicted from full ring buffers)"
                 if dropped else "")
              + " — open in Perfetto (ui.perfetto.dev)")
    return code


if __name__ == "__main__":
    raise SystemExit(main())
