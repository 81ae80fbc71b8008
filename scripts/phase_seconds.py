#!/usr/bin/env python3
"""Each phase's seconds in a ``chip_smoke.py`` log.

    python3 chip_smoke.py > smoke.log
    python3 scripts/phase_seconds.py smoke.log [more.log ...]

Every JSON line chip_smoke prints carries ``t_s``, the seconds since the
script started.  A phase's seconds are its last line's ``t_s`` less the
``t_s`` of the line before its first; the lines a phase prints as it
goes (``sql_text``, ``adaptive_query`` ...) count toward the phase line
that follows them.  Prints one row a log: the phases in run order, and
the ``t_s`` of ``main``.
"""

import json
import sys

#: lines printed as a phase goes -> the phase they belong to
PART_OF = {"sql_text": "sql", "types_text": "types",
           "nested_query": "nested", "long_tail_query": "long_tail",
           "python_query": "python", "adaptive_query": "adaptive",
           "channel_text": "channels", "memory_spill": "memory",
           "memory_split": "memory", "memory_oom": "memory",
           "memory_ooc_sort": "memory", "scan_host_q6": "scan_host",
           "scan_host_q1": "scan_host", "scan_host_q3ds": "scan_host"}


def phase_seconds(path: str) -> list:
    """[(phase, seconds)] in run order."""
    out: list = []
    last_t = 0.0
    for line in open(path, encoding="utf-8", errors="replace"):
        line = line.strip()
        if not line.startswith('{"phase"'):
            continue
        rec = json.loads(line)
        phase = PART_OF.get(rec["phase"], rec["phase"])
        dt = rec["t_s"] - last_t
        last_t = rec["t_s"]
        if out and out[-1][0] == phase:
            out[-1] = (phase, out[-1][1] + dt)
        else:
            out.append((phase, dt))
    return out


def main() -> int:
    for path in sys.argv[1:]:
        rows = phase_seconds(path)
        main_t = sum(s for _, s in rows)
        print(path)
        print("  " + ", ".join(f"{p} {s:.1f}" for p, s in rows))
        print(f"  to main: {main_t:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
