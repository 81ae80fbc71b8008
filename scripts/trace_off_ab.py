#!/usr/bin/env python3
"""What the observability layer costs with every key off: two checkouts
of the PyTorch port, in turns, on one NVIDIA card.

    python3 scripts/trace_off_ab.py --trees _archive/parent . . _archive/parent

Generates chip_smoke.py's data once (TPC-H q3's 6 x 2^20 lineitem rows
and 2^20 orders; TPC-DS q3's whole calendar, 18 000 items and 6 x 2^20
store_sales rows; q93's store_returns and reasons), then runs each
``--trees`` entry (a directory holding a ``spark_rapids_tpu_torch``
package, e.g. the parent commit unpacked with ``git archive``) in a
process of its own, in the order given, with chip_smoke.py's scan
tasks: q3 and q93 with the adaptive key off (the static partition-wise
plans), q3ds with the default keys; tracing, the ledger and telemetry
off, as by default.  For each query: one warm-up, then ``--runs``
timed runs (a ``collect()`` ended by ``torch.cuda.synchronize()``,
host clock).  Every tree's result of a query must equal the first
tree's, bit for bit (an Arrow IPC digest).  Prints one JSON line per
tree and query, then the nvidia-smi line.  Needs CUDA; exits non-zero
without it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAPTIVE = "spark.rapids.tpu.sql.adaptive.enabled"


def digest(table) -> str:
    import pyarrow as pa

    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return hashlib.sha256(sink.getvalue().to_pybytes()).hexdigest()[:16]


def run_tree(tree: str, data: str, runs: int) -> int:
    """One tree's walls (in a process of its own)."""
    sys.path.insert(0, os.path.abspath(tree))
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke as cs
    from spark_rapids_tpu_torch import TorchSession, tpcds, tpch
    from spark_rapids_tpu_torch.config import TASK_TARGET_BYTES as TTB

    spec = json.load(open(os.path.join(data, "paths.json")))
    li, orders = spec["lineitem"], spec["orders"]
    dd, ss, item = spec["star"]
    sr, reason = spec["q93"]
    queries = {
        "q3": ({TTB: cs.TASK_TARGET_BYTES, ADAPTIVE: False},
               lambda s: tpch.q3_dataframe(s, li, orders)),
        "q3ds": ({TTB: cs.Q3DS_TASK_TARGET_BYTES},
                 lambda s: tpcds.q3_dataframe(s, dd, ss, item)),
        "q93": ({TTB: cs.Q3DS_TASK_TARGET_BYTES, ADAPTIVE: False},
                lambda s: tpcds.q93_dataframe(s, ss, sr, reason)),
    }
    for name, (keys, make) in queries.items():
        session = TorchSession(keys, device="cuda")
        first = make(session).collect()
        walls = []
        for _ in range(runs):
            t0 = time.perf_counter()
            out = make(session).collect()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if not out.equals(first):
                raise AssertionError(f"{tree} {name}: runs differ")
        print(json.dumps({"tree": tree, "query": name, "wall_s": walls,
                          "median_s": statistics.median(walls),
                          "rows": first.num_rows,
                          "digest": digest(first)}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--run-tree")
    ap.add_argument("--data")
    args = ap.parse_args()
    if args.run_tree:
        return run_tree(args.run_tree, args.data, args.runs)
    import torch

    if not torch.cuda.is_available():
        print("trace_off_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from spark_rapids_tpu_torch import tpcds, tpch

    work = os.path.join(ROOT, "spark_rapids_tpu_torch", "_build")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as data:
        q3_dir = os.path.join(data, "q3")
        os.makedirs(q3_dir)
        li = tpch.make_lineitem(q3_dir, with_orderkey=True)
        orders = tpch.make_orders(q3_dir)
        star_dir = os.path.join(data, "star")
        os.makedirs(star_dir)
        dd, ss, item = tpcds.write_q3_tables(
            star_dir, n_files=cs.Q3DS_FILES,
            rows_per_file=cs.Q3DS_ROWS_PER_FILE)
        sr, reason = tpcds.write_q93_tables(star_dir, ss)
        with open(os.path.join(data, "paths.json"), "w") as f:
            json.dump({"lineitem": li, "orders": orders,
                       "star": [dd, ss, item], "q93": [sr, reason]}, f)
        lines = []
        for tree in args.trees:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--run-tree",
                 tree, "--data", data, "--runs", str(args.runs)],
                cwd=ROOT, capture_output=True, text=True)
            sys.stdout.write(proc.stdout)
            sys.stderr.write(proc.stderr[-4000:])
            if proc.returncode:
                return proc.returncode
            lines += [json.loads(ln) for ln in proc.stdout.splitlines()
                      if ln.startswith("{")]
    for name in ("q3", "q3ds", "q93"):
        got = {r["digest"] for r in lines if r["query"] == name}
        if len(got) != 1:
            raise AssertionError(f"{name}: the trees' results differ {got}")
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
