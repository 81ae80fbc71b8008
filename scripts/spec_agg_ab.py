"""Speculative sizing on against off, on the card, for the grouped
aggregate's update loop and for TPC-DS q93, in one or more source trees.

Two cells, each run with ``spark.rapids.tpu.sql.speculation.enabled`` on
and off in alternating pairs after one warm run of each side:

- ``agg``: ``SELECT k, sum(v), count(*) GROUP BY k`` over one Parquet
  file of ``--batches`` row groups of ``--rows`` (2^20) rows, read at
  ``batchSizeRows`` = ``--rows`` (one scan task, so one task updates
  every batch), int64 keys drawn uniformly from ``--keys`` values and
  float64 values, from seed 20;
- ``q93``: ``tpcds.q93_dataframe`` over six store_sales files of
  ``--rows`` rows and the store_returns rows derived from them (~628 000
  at 2^20), as chip_smoke's ``q93`` phase runs it (8 MiB scan tasks,
  adaptive execution off).

Per run it records the wall, the aggregate execs' merges (calls of
``TpuHashAggregateExec._merge``, the final drain's merge included), the
peak of ``torch.cuda.max_memory_allocated`` and the speculation
counters' deltas; each on run is held against the first off run row
for row (``on_equals_off``: bit for bit) and by the largest relative
difference of a float (``max_rel_diff``).  Each tree runs in a
process of its own, in the order given, so ``--trees parent . .
parent`` compares two versions within one call.  The data is written
once, by the package of the tree this script lies in.

    python3 scripts/spec_agg_ab.py [--trees DIR ...] [--pairs 3]
        [--batches 8] [--keys 262144] [--rows 1048576]
        [--out chiprun_out/spec_agg_ab.json]

Prints the card's name and power limit first and one JSON object per
tree.  ``--device cpu --rows 16384 --keys 4096`` checks the script on a
host without a card (no kernel is built, no time is meaningful).
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
ADAPTIVE = "spark.rapids.tpu.sql.adaptive.enabled"
ENABLED = "spark.rapids.tpu.sql.speculation.enabled"
TAGS = ("join.probe", "agg.size", "exchange.split")
BATCH_ROWS = "spark.rapids.tpu.sql.batchSizeRows"


def write_data(d: str, batches: int, keys: int, rows: int) -> dict:
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    sys.path.insert(0, HERE)
    from spark_rapids_tpu_torch import tpcds

    rng = np.random.default_rng(20)
    n = batches * rows
    agg_path = os.path.join(d, "agg.parquet")
    pq.write_table(pa.table({
        "k": rng.integers(0, keys, n, dtype=np.int64),
        "v": rng.standard_normal(n)}), agg_path, row_group_size=rows)
    star = os.path.join(d, "star")
    os.makedirs(star)
    _, ss_paths, _ = tpcds.write_q3_tables(star, n_files=6,
                                           rows_per_file=rows)
    sr_path, reason_path = tpcds.write_q93_tables(star, ss_paths)
    return {"agg": agg_path, "ss": ss_paths, "sr": sr_path,
            "reason": reason_path}


def worker(root: str, data: dict, pairs: int, device: str,
           rows: int) -> dict:
    sys.path.insert(0, root)
    import torch

    from spark_rapids_tpu_torch import TorchSession, col, count_star, sum_
    from spark_rapids_tpu_torch import tpcds
    from spark_rapids_tpu_torch.config import TorchConf
    from spark_rapids_tpu_torch.execs.aggregate import TpuHashAggregateExec
    from spark_rapids_tpu_torch.ops import kernels
    from spark_rapids_tpu_torch.parallel import speculation as SP
    from spark_rapids_tpu_torch.plugin import TorchPlugin

    cuda = device == "cuda"
    TorchPlugin.get_or_create(TorchConf(), device)
    if cuda:
        kernels.build_library("hash_string")
        kernels.load_library("hash_string")
    merges = [0]
    merge = TpuHashAggregateExec._merge

    def counted(self, partial):
        merges[0] += 1
        return merge(self, partial)

    TpuHashAggregateExec._merge = counted

    def agg(s):
        return (s.read_parquet(data["agg"]).group_by(col("k"))
                .agg((sum_(col("v")), "s"), (count_star(), "n")))

    def q93(s):
        return tpcds.q93_dataframe(s, data["ss"], data["sr"],
                                   data["reason"])

    cells = {"agg": ({TTB: 1 << 40, BATCH_ROWS: rows}, agg),
             "q93": ({TTB: 8 << 20, ADAPTIVE: False}, q93)}
    out = {"root": root}
    for name, (keys, make) in cells.items():
        sessions = {"on": TorchSession(keys, device=device),
                    "off": TorchSession({**keys, ENABLED: False},
                                        device=device)}
        SP.reset_predictors()
        SP.reset_stats()

        def run(side):
            merges[0] = 0
            before = SP.stats()
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            table = make(sessions[side]).collect()
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = SP.stats()
            spec = {t: {k: after.get(t, {}).get(k, 0)
                        - before.get(t, {}).get(k, 0)
                        for k in ("hits", "overflows", "synced")}
                    for t in TAGS}
            out_rows = sorted(table.to_pylist(), key=lambda r: tuple(
                (v is not None, v) for v in r.values()))
            return out_rows, {"wall_s": wall, "merges": merges[0],
                          "peak_alloc_bytes": (
                              torch.cuda.max_memory_allocated() if cuda
                              else None),
                          "spec": {t: v for t, v in spec.items()
                                   if any(v.values())}}

        def rel_diff(got, want):
            if len(got) != len(want):
                return float("inf")
            worst = 0.0
            for g, w in zip(got, want):
                for k, v in w.items():
                    u = g[k]
                    if isinstance(v, float) and isinstance(u, float):
                        worst = max(worst, abs(u - v) / max(abs(v), 1e-300))
                    elif u != v:
                        return float("inf")
            return worst

        want, first_off = run("off")
        got, first_on = run("on")
        same, worst = got == want, rel_diff(got, want)
        runs = {"on": [], "off": []}
        for i in range(pairs):
            for side in (("on", "off") if i % 2 == 0 else ("off", "on")):
                got, r = run(side)
                if side == "on":
                    same = same and got == want
                    worst = max(worst, rel_diff(got, want))
                runs[side].append(r)
        out[name] = {
            "on_equals_off": same, "max_rel_diff": worst,
            "first_on": first_on,
            "first_off": first_off, "on": runs["on"], "off": runs["off"],
            "on_median_s": statistics.median(r["wall_s"] for r in runs["on"]),
            "off_median_s": statistics.median(
                r["wall_s"] for r in runs["off"])}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--keys", type=int, default=1 << 18)
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "spec_agg_ab.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--data", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.worker, json.loads(a.data), a.pairs,
                                a.device, a.rows)), flush=True)
        return 0
    import torch

    if a.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card (or --device cpu)", file=sys.stderr)
        return 1
    if a.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip(), flush=True)
    results = []
    with tempfile.TemporaryDirectory() as d:
        data = write_data(d, a.batches, a.keys, a.rows)
        for tree in a.trees:
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 os.path.abspath(tree), "--data", json.dumps(data),
                 "--pairs", str(a.pairs), "--device", a.device,
                 "--rows", str(a.rows)],
                capture_output=True, text=True, check=False, cwd=tree)
            if p.returncode:
                print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
                return p.returncode
            r = json.loads(p.stdout.strip().splitlines()[-1])
            results.append(r)
            print(json.dumps({"root": tree, **{
                c: {k: r[c][k] for k in ("on_equals_off", "max_rel_diff",
                                         "on_median_s", "off_median_s")}
                | {"merges_on": r[c]["on"][0]["merges"],
                   "merges_off": r[c]["off"][0]["merges"],
                   "peak_on": max(x["peak_alloc_bytes"] or 0
                                  for x in r[c]["on"]),
                   "peak_off": max(x["peak_alloc_bytes"] or 0
                                   for x in r[c]["off"])}
                for c in ("agg", "q93")}}), flush=True)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
