#!/usr/bin/env python3
"""The scan's host path of two checkouts of the PyTorch port, in turns,
on one NVIDIA card: TPC-H q6 and q1 and TPC-DS q3.

    python3 scripts/scan_host_ab.py --trees _archive/parent . . _archive/parent

Generates chip_smoke.py's data once (6 x 2^20 lineitem rows with q1's
columns; the whole date_dim calendar, 18 000 items and 6 x 2^20
store_sales rows), then runs each ``--trees`` entry (a directory holding
a ``spark_rapids_tpu_torch`` package, e.g. the parent commit unpacked
with ``git archive``) in a process of its own, in the order given, with
chip_smoke.py's scan tasks and the default keys.  For each query: one
warm-up, ``--runs`` timed runs (a ``collect()`` ended by
``torch.cuda.synchronize()``, host clock), every scan task drained
alone serially (stages off, one thread) and pooled with the host split,
and the scans' counters from one kept run (rows uploaded, row groups
pruned, rows filtered on the host, files on the fast and standard
path; a tree that predates a counter reports none).  Every result is
held against chip_smoke.py's pyarrow reference.  Prints one JSON line
per tree and query, then the nvidia-smi line.  Needs CUDA; exits
non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTERS = ("numOutputRows", "rowGroupsPruned", "hostFilteredRows",
            "rfPrunedRows", "fastDecodedFiles", "standardDecodedFiles")


def run_tree(tree: str, data: str, runs: int) -> int:
    """One tree's measurements (in a process of its own)."""
    sys.path.insert(0, os.path.abspath(tree))
    sys.path.insert(1, ROOT)
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import torch

    import chip_smoke as cs
    from spark_rapids_tpu_torch import TorchSession, tpcds, tpch
    from spark_rapids_tpu_torch.config import TASK_TARGET_BYTES as TTB
    from spark_rapids_tpu_torch.plan.planner import collect_exec

    spec = json.load(open(os.path.join(data, "paths.json")))
    li, (dd, ss, item) = spec["lineitem"], spec["star"]
    tables = pa.concat_tables([pq.read_table(p) for p in li])
    ref6, ref1 = cs.reference_q6(pa, pc, tables), cs.reference_q1(pa, pc,
                                                                  tables)
    del tables
    star = {"date_dim": pq.read_table(dd), "item": pq.read_table(item),
            "sales": pa.concat_tables([pq.read_table(p, columns=[
                "ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"])
                for p in ss])}
    ref3 = cs.reference_star(
        pc, star, lambda d: pc.equal(d["d_moy"], 11),
        lambda i: pc.equal(i["i_manufact_id"], 128),
        ["d_year", "i_brand_id", "i_brand"], {},
        [("d_year", False), ("sum", True), ("i_brand_id", False)])
    del star
    queries = {
        "q6": (cs.TASK_TARGET_BYTES, lambda s: tpch.q6_dataframe(s, li),
               lambda t: cs.compare(t, ref6, 0)),
        "q1": (cs.TASK_TARGET_BYTES, lambda s: tpch.q1_dataframe(s, li),
               lambda t: cs.compare(t, ref1, 2)),
        "q3ds": (cs.Q3DS_TASK_TARGET_BYTES,
                 lambda s: tpcds.q3_dataframe(s, dd, ss, item),
                 lambda t: cs.compare_ranked(
                     t, ref3, 100, ("d_year", "i_brand_id", "i_brand"),
                     "sum_agg", "sum")),
    }
    for name, (target, make, check) in queries.items():
        session = TorchSession({TTB: target}, device="cuda")
        worst = check(make(session).collect())
        walls = []
        for _ in range(runs):
            t0 = time.perf_counter()
            out = make(session).collect()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            worst = max(worst, check(out))
        plan = make(session).physical_plan()
        worst = max(worst, check(collect_exec(plan, session.conf)))
        scans = [{"files": len(n.paths), "columns": n.schema.names,
                  **{k: n.metrics[k] for k in COUNTERS if k in n.metrics}}
                 for n in plan.walk()
                 if type(n).__name__ == "ParquetScanExec"]
        alone = {mode: cs.scan_alone(torch, make(session).physical_plan(),
                                     serial=mode == "serial")
                 for mode in ("serial", "pooled")}
        print(json.dumps({
            "tree": tree, "query": name, "wall_s": walls,
            "median_s": statistics.median(walls), "max_rel_err": worst,
            "device_filter": any(type(n).__name__ == "TpuFilterExec"
                                 for n in plan.walk()),
            "scans": scans,
            "scan_only_s": alone["serial"]["wall_s"],
            "scan_only_pooled_s": alone["pooled"]["wall_s"],
            "host_split_serial_s": alone["serial"]["host_split_s"],
            "host_split_pooled_s": alone["pooled"]["host_split_s"]}),
            flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--run-tree")
    ap.add_argument("--data")
    args = ap.parse_args()
    if args.run_tree:
        return run_tree(args.run_tree, args.data, args.runs)
    import torch

    if not torch.cuda.is_available():
        print("scan_host_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from spark_rapids_tpu_torch import tpcds, tpch

    work = os.path.join(ROOT, "spark_rapids_tpu_torch", "_build")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as data:
        li = tpch.make_lineitem(data, with_q1_cols=True)
        star_dir = os.path.join(data, "q3ds")
        os.makedirs(star_dir)
        dd, ss, item = tpcds.write_q3_tables(
            star_dir, n_files=cs.Q3DS_FILES,
            rows_per_file=cs.Q3DS_ROWS_PER_FILE)
        with open(os.path.join(data, "paths.json"), "w") as f:
            json.dump({"lineitem": li, "star": [dd, ss, item]}, f)
        for tree in args.trees:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--run-tree",
                 tree, "--data", data, "--runs", str(args.runs)],
                cwd=ROOT)
            if proc.returncode:
                return proc.returncode
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
