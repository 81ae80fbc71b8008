#!/usr/bin/env python3
"""Query walls of two or more source trees on one card, in turns: what a
tree's per-query layers (the query history's snapshot, each exec's
output counting) cost a query against another tree's.

    python3 scripts/query_overhead_ab.py --trees PARENT . . PARENT
        [--runs 7] [--out chiprun_out/query_overhead_ab.json]

The data is written once, by the package of the tree this script lies
in (chip_smoke's: 6 x 2^20 lineitem rows with q1's columns; q3's
lineitem and 2^20 orders; q3ds's calendar, 18 000 items and 6 x 2^20
store_sales rows).  Each tree then runs in a process of its own, in the
order given, with the default keys but 8 MiB scan tasks: TPC-H q6, q1
and q3 and TPC-DS q3 (q3ds), one warm-up and ``--runs`` timed runs each
(the host's clock to a ``torch.cuda.synchronize()``), and the digests
of its results (``pyarrow`` IPC bytes, sha256; a float sum on the card
may differ in its last bits from run to run: its atomic adds keep no
order).  Prints the card's name and
power limit, then one JSON object a tree: the walls, their medians and
the digests.  ``--device cpu --rows 4096`` checks the script on a host
without a card (no time is meaningful there).
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

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
QUERIES = ("q6", "q1", "q3", "q3ds")


def write_data(d: str, rows: int) -> dict:
    sys.path.insert(0, HERE)
    from spark_rapids_tpu_torch import tpcds, tpch

    os.makedirs(os.path.join(d, "li"))
    li = tpch.make_lineitem(os.path.join(d, "li"), with_q1_cols=True,
                            rows_per_file=rows)
    q3_dir = os.path.join(d, "q3")
    os.makedirs(q3_dir)
    li3 = tpch.make_lineitem(q3_dir, with_orderkey=True, rows_per_file=rows,
                             n_orders=rows)
    orders = tpch.make_orders(q3_dir, n_orders=rows)
    star = os.path.join(d, "star")
    os.makedirs(star)
    dd, ss, item = tpcds.write_q3_tables(star, n_files=6, rows_per_file=rows)
    return {"li": li, "li3": li3, "orders": orders, "dd": dd, "ss": ss,
            "item": item}


def worker(root: str, data: dict, runs: int, device: str) -> dict:
    sys.path.insert(0, root)
    import hashlib

    import pyarrow as pa
    import torch

    from spark_rapids_tpu_torch import TorchSession, tpcds, tpch

    if device == "cuda":
        from spark_rapids_tpu_torch.ops import kernels

        kernels.build_library("hash_string")
        kernels.load_library("hash_string")
    s = TorchSession({TTB: 8 << 20}, device=device)
    make = {
        "q6": lambda: tpch.q6_dataframe(s, data["li"]),
        "q1": lambda: tpch.q1_dataframe(s, data["li"]),
        "q3": lambda: tpch.q3_dataframe(s, data["li3"], data["orders"]),
        "q3ds": lambda: tpcds.q3_dataframe(s, data["dd"], data["ss"],
                                           data["item"]),
    }

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def digest(t: pa.Table) -> str:
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, t.schema) as w:
            for b in t.combine_chunks().to_batches():
                w.write_batch(b)
        return hashlib.sha256(memoryview(sink.getvalue())).hexdigest()[:16]

    out: dict = {"root": root, "walls_s": {}, "median_s": {}, "digests": {}}
    for name in QUERIES:
        make[name]().collect()  # warm-up
        walls, digests = [], set()
        for _ in range(runs):
            sync()
            t0 = time.perf_counter()
            t = make[name]().collect()
            sync()
            walls.append(time.perf_counter() - t0)
            digests.add(digest(t))
        out["walls_s"][name] = walls
        out["median_s"][name] = statistics.median(walls)
        out["digests"][name] = sorted(digests)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=[HERE])
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        root, data_path = args.worker
        with open(data_path) as f:
            data = json.load(f)
        print(json.dumps(worker(root, data, args.runs, args.device)))
        return 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("query_overhead_ab: no CUDA device", file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    results = []
    work = os.path.join(HERE, "spark_rapids_tpu_torch", "_build")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as d:
        data = write_data(d, args.rows)
        data_path = os.path.join(d, "data.json")
        with open(data_path, "w") as f:
            json.dump(data, f)
        for tree in args.trees:
            root = os.path.abspath(tree)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", root,
                 data_path, "--runs", str(args.runs), "--device",
                 args.device], capture_output=True, text=True, check=True,
                cwd=root)
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(rec), flush=True)
            results.append(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
