#!/usr/bin/env python3
"""Device kernels of one TPC-H q1 run of the PyTorch port, on one
NVIDIA card.

    python3 scripts/q1_device_kernels.py [--root DIR] [--files 6]

Imports ``spark_rapids_tpu_torch`` from DIR (this checkout by default,
or an unpacked older commit, so two versions of the port are counted
the same way), generates ``--files`` x 2^20 lineitem rows, runs q1 once
to warm up and once under torch.profiler, with one scan task per file
(scan.taskTargetBytes = 8 MiB, as chip_smoke.py), and prints one JSON
line: the run's device kernel count, its device busy time, and the
kernels launched most often.  Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--files", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("q1_device_kernels: needs an NVIDIA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_tpu_torch import TorchSession, tpch

    work = os.path.join(root, "spark_rapids_tpu_torch", "_build")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as data_dir:
        paths = tpch.make_lineitem(data_dir, n_files=args.files,
                                   with_q1_cols=True)
        session = TorchSession(
            {"spark.rapids.tpu.sql.scan.taskTargetBytes": 8 << 20},
            device="cuda")
        tpch.q1_dataframe(session, paths).collect()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rows = tpch.q1_dataframe(session, paths).collect().num_rows
            torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    top = sorted(kern, key=lambda e: -e.count)[:8]
    print(json.dumps({
        "root": os.path.relpath(root, ROOT), "files": args.files,
        "rows": rows, "device_kernel_count": sum(e.count for e in kern),
        "device_busy_ms": sum(e.self_device_time_total for e in kern) / 1e3,
        "most_launched": [[e.key[:70], e.count] for e in top]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
