#!/usr/bin/env python3
"""The runtime join filter on and off, in alternating order, on one
NVIDIA card: TPC-H q3 and TPC-DS q3 of the PyTorch port.

    python3 scripts/rf_ab.py [--pairs 10]

Generates chip_smoke.py's data for both queries (6 x 2^20 lineitem rows
and 2^20 orders; the whole date_dim calendar, 18 000 items and 6 x 2^20
store_sales rows), with chip_smoke.py's scan tasks, warms both sessions
of each query up, then runs ``--pairs`` pairs: even pairs with the
filter on first, odd pairs off first.  A run is one ``collect()`` ended
by ``torch.cuda.synchronize()``, timed by the host clock.  The two
sides' rows must agree (keys exact, sums within rel 1e-9).  Prints one
JSON line per query: every wall, each side's median and quartiles, and
the pairs the filter won.  Needs CUDA; exits non-zero without it.
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
REL_TOL = 1e-9


def same_rows(a, b, keys, value) -> None:
    ra, rb = a.to_pylist(), b.to_pylist()
    if len(ra) != len(rb):
        raise AssertionError(f"{len(ra)} rows against {len(rb)}")
    for x, y in zip(ra, rb):
        if [x[k] for k in keys] != [y[k] for k in keys] or abs(
                x[value] - y[value]) > REL_TOL * abs(y[value]):
            raise AssertionError(f"{x} against {y}")


def ab(torch, make_df, pairs: int, keys, value) -> dict:
    """Alternating pairs of the query with the filter on and off."""
    def run(on: bool):
        t0 = time.perf_counter()
        out = make_df(on).collect()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    for on in (True, False):
        run(on)
    walls = {True: [], False: []}
    won = 0
    for i in range(pairs):
        order = (True, False) if i % 2 == 0 else (False, True)
        got = {}
        for on in order:
            w, got[on] = run(on)
            walls[on].append(w)
        same_rows(got[True], got[False], keys, value)
        won += walls[True][-1] < walls[False][-1]

    def side(ws):
        q = statistics.quantiles(ws, n=4)
        return {"wall_s": ws, "median_s": statistics.median(ws),
                "q1_s": q[0], "q3_s": q[2]}

    return {"pairs": pairs, "filter_won": won, "on": side(walls[True]),
            "off": side(walls[False])}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rf_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from spark_rapids_tpu_torch import TorchSession, tpcds, tpch
    from spark_rapids_tpu_torch.config import RF_ENABLED
    from spark_rapids_tpu_torch.config import TASK_TARGET_BYTES as TTB

    print(cs.nvidia_smi(), flush=True)
    work = os.path.join(ROOT, "spark_rapids_tpu_torch", "_build")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as data_dir:
        li = tpch.make_lineitem(data_dir, with_orderkey=True)
        orders = tpch.make_orders(data_dir)
        s3 = {on: TorchSession({TTB: cs.TASK_TARGET_BYTES, RF_ENABLED: on},
                               device="cuda") for on in (True, False)}
        q3 = ab(torch, lambda on: tpch.q3_dataframe(s3[on], li, orders),
                args.pairs, ["l_orderkey", "o_orderdate", "o_shippriority"],
                "revenue")
        print(json.dumps({"query": "q3", **q3}), flush=True)
        dd, ss, item = tpcds.write_q3_tables(
            data_dir, n_files=cs.Q3DS_FILES,
            rows_per_file=cs.Q3DS_ROWS_PER_FILE)
        sds = {on: TorchSession({TTB: cs.Q3DS_TASK_TARGET_BYTES,
                                 RF_ENABLED: on}, device="cuda")
               for on in (True, False)}
        q3ds = ab(torch, lambda on: tpcds.q3_dataframe(sds[on], dd, ss,
                                                        item),
                  args.pairs, ["d_year", "i_brand_id", "i_brand"],
                  "sum_agg")
        print(json.dumps({"query": "q3ds", **q3ds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
