#!/usr/bin/env python3
"""The port's host concurrency keys, one setting at a time, on one
NVIDIA card: where the pooled run gains and where it loses.

    python3 scripts/concurrency_sweep.py [--rounds 3]

Generates chip_smoke.py's data for TPC-H q1, q6 and q3 (filter on) and
TPC-DS q93 (6 x 2^20 fact rows, a scan task a file), and runs each
query under five settings in rotating order, ``--rounds`` times after a
warm-up of each: ``serial`` (``config.SERIAL``), ``stages`` (one task
thread; the decode pool and the stages on), ``threads2`` (two task
threads), ``default`` (four), and ``default_si`` (four, with the
interpreter's thread switch interval cut from 5 ms to 0.1 ms for the
run: a thread that gave up the GIL for a short native call then waits
less to take it back).  Each result must equal the serial one
(``pyarrow.Table.equals``); each run's process CPU time is kept beside
its wall.  Then one profiled run of ``serial``, ``default`` and
``default_si`` each: the host time the CUDA runtime spent in
synchronising calls (``cudaStreamSynchronize``, ``cudaMemcpyAsync``,
``cudaDeviceSynchronize``, summed over threads), the CPU time of every
CUDA runtime call and of the 8 costliest ATen ops by self CPU time, the
device's busy time and kernel count.  Prints one JSON line per query.
Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNC_CALLS = ("cudaStreamSynchronize", "cudaMemcpyAsync",
              "cudaDeviceSynchronize")


def profile_run(torch, run) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    kern = [e for e in ev if e.device_type == DeviceType.CUDA]
    sync = {e.key: (e.count, e.cpu_time_total / 1e6) for e in ev
            if e.key in SYNC_CALLS}
    runtime = {e.key: (e.count, e.cpu_time_total / 1e6) for e in ev
               if e.key.startswith("cuda")}
    aten = sorted((e for e in ev if e.key.startswith("aten::")),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    return {"wall_s": wall,
            "runtime_calls": runtime,
            "aten_self_cpu_s": [[e.key, e.count, e.self_cpu_time_total / 1e6]
                                for e in aten],
            "device_busy_s": sum(e.self_device_time_total
                                 for e in kern) / 1e6,
            "device_kernel_count": sum(e.count for e in kern),
            "sync_calls": sync,
            "sync_host_s": sum(s for _, s in sync.values())}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("concurrency_sweep: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from spark_rapids_tpu_torch import TorchSession, tpcds, tpch
    from spark_rapids_tpu_torch import config as C

    confs = {"serial": C.SERIAL, "stages": {C.TASK_THREADS: 1},
             "threads2": {C.TASK_THREADS: 2}, "default": {},
             "default_si": {}}
    work = os.path.join(ROOT, "spark_rapids_tpu_torch", "_build")
    os.makedirs(work, exist_ok=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    with tempfile.TemporaryDirectory(dir=work) as d:
        q1 = tpch.make_lineitem(d, with_q1_cols=True)
        os.makedirs(os.path.join(d, "q3"))
        li = tpch.make_lineitem(os.path.join(d, "q3"), with_orderkey=True)
        orders = tpch.make_orders(os.path.join(d, "q3"))
        os.makedirs(os.path.join(d, "star"))
        _, ss, _ = tpcds.write_q3_tables(os.path.join(d, "star"))
        sr, reason = tpcds.write_q93_tables(os.path.join(d, "star"), ss)
        ttb = {C.TASK_TARGET_BYTES: 8 << 20}
        queries = {
            "q1": lambda s: tpch.q1_dataframe(s, q1),
            "q6": lambda s: tpch.q6_dataframe(s, q1),
            "q3_rf_on": lambda s: tpch.q3_dataframe(s, li, orders),
            "q93": lambda s: tpcds.q93_dataframe(s, ss, sr, reason),
        }
        for name, make in queries.items():
            sessions = {k: TorchSession({**ttb, **v})
                        for k, v in confs.items()}

            def run(k):
                old = sys.getswitchinterval()
                if k == "default_si":
                    sys.setswitchinterval(1e-4)
                try:
                    c0, t0 = time.process_time(), time.perf_counter()
                    t = make(sessions[k]).collect()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    cpu_s = time.process_time() - c0
                finally:
                    sys.setswitchinterval(old)
                return wall, t, cpu_s

            want = run("serial")[1]
            cpu: dict = {k: [] for k in confs}
            for k in confs:
                run(k)
            walls = {k: [] for k in confs}
            keys = list(confs)
            for r in range(args.rounds):
                for k in keys[r % len(keys):] + keys[:r % len(keys)]:
                    w, t, c = run(k)
                    if not t.equals(want):
                        raise AssertionError(f"{name} {k}: result differs")
                    walls[k].append(w)
                    cpu[k].append(c)
            out = {"query": name, "rounds": args.rounds,
                   "wall_s": walls, "cpu_s": cpu,
                   "median_s": {k: statistics.median(v)
                                for k, v in walls.items()}}
            for k in ("serial", "default", "default_si"):
                out[f"profiled_{k}"] = profile_run(torch, lambda k=k: run(k))
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
