#!/usr/bin/env python3
"""Are the port's float results the same from one run to the next on one
NVIDIA card?  And what do a deterministic and a non-deterministic
segment sum cost there?

    python3 scripts/repeatability.py [--runs 3]

1. Segment sums of 6 x 2^20 float64 values into 6 groups (q1's coded
   partial group-by) and into 344 342 groups (q3's aggregate), by
   ``index_add_`` (atomic adds), by ``index_put_(accumulate=True)``
   (sorted indices, a fixed order), and for 6 groups by a masked dense
   sum per group, and for 344 342 by ``segment_reduce`` over indices
   sorted first: ``--runs`` results of each compared bit for bit, and
   the CUDA-event time of each.
2. TPC-H q6 and q1 over chip_smoke.py's lineitem data (6 files of 2^20
   rows, a scan task each), run ``--runs`` times serially
   (``config.SERIAL``) and as many pooled (the default keys), in turns:
   each result compared with the first serial one by
   ``pyarrow.Table.equals``, and q6's revenue printed in hex.

Prints one JSON line per part.  Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def event_ms(torch, fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def segment_sums(torch, runs: int) -> dict:
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    n = 6 << 20
    vals = torch.rand(n, generator=g, device="cuda",
                      dtype=torch.float64) * 1e5
    out = {}
    for groups in (6, 344342):
        gid = torch.randint(0, groups, (n,), generator=g, device="cuda")

        def add():
            s = torch.zeros(groups, dtype=torch.float64, device="cuda")
            return s.index_add_(0, gid, vals)

        def put():
            s = torch.zeros(groups, dtype=torch.float64, device="cuda")
            return s.index_put_((gid,), vals, accumulate=True)

        ways = [("index_add_", add), ("index_put_acc", put)]
        if groups <= 64:
            ids = torch.arange(groups, device="cuda")[:, None]
            ways.append(("masked_sum", lambda: torch.where(
                gid[None, :] == ids, vals[None, :], 0.0).sum(1)))
        else:
            sgid, order = torch.sort(gid, stable=True)
            svals = vals[order]
            lengths = torch.bincount(sgid, minlength=groups)
            ways.append(("segment_reduce_sorted", lambda: torch.segment_reduce(
                svals, "sum", lengths=lengths)))
            ways.append(("index_put_acc_sorted", lambda: torch.zeros(
                groups, dtype=torch.float64, device="cuda").index_put_(
                    (sgid,), svals, accumulate=True)))
        for name, fn in ways:
            first = fn()
            same = all(torch.equal(first, fn()) for _ in range(runs - 1))
            out[f"{name}/{groups}"] = {"bitwise_repeatable": same,
                                      "ms": event_ms(torch, fn)}
    return out


def queries(torch, runs: int) -> dict:
    sys.path.insert(0, ROOT)
    from spark_rapids_tpu_torch import TorchSession, tpch
    from spark_rapids_tpu_torch.config import SERIAL, TASK_TARGET_BYTES

    work = os.path.join(ROOT, "spark_rapids_tpu_torch", "_build")
    os.makedirs(work, exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=work) as d:
        paths = tpch.make_lineitem(d, with_q1_cols=True)
        ttb = {TASK_TARGET_BYTES: 8 << 20}
        sessions = {"serial": TorchSession({**ttb, **SERIAL}),
                    "pooled": TorchSession(ttb)}
        for name, fn in (("q6", tpch.q6_dataframe),
                         ("q1", tpch.q1_dataframe)):
            first, rec = None, {"serial": [], "pooled": []}
            for _ in range(runs):
                for side in ("serial", "pooled"):
                    t0 = time.perf_counter()
                    t = fn(sessions[side], paths).collect()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    if first is None:
                        first = t
                    rec[side].append({
                        "wall_s": wall, "equal_to_first": t.equals(first),
                        "first_float": float.hex(next(
                            v for v in t.to_pylist()[0].values()
                            if isinstance(v, float)))})
            out[name] = rec
    return out


def main() -> int:
    import torch

    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("repeatability: needs an NVIDIA card", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch.ops import groupby

    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "fixed_order_float_sums": hasattr(groupby, "Groups"),
                      "segment_sums": segment_sums(torch, args.runs)}),
          flush=True)
    print(json.dumps({"queries": queries(torch, args.runs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
