#!/usr/bin/env python3
"""Run chip_smoke.py's ``ops`` phase alone on one NVIDIA card.

    python3 scripts/ops_phase.py [--pairs N]

Builds K1 and the host codec, writes the tables the whole script writes
for it (6 x 2^20 lineitem rows with q1's columns; q3's lineitem and
2^20 orders; q3ds's calendar, 18 000 items and 6 x 2^20 store_sales
rows), and runs ``chip_smoke.ops_phase`` with ``--pairs`` (default
chip_smoke.OPS_PAIRS) q3 pairs with the event log on and off.  Prints
the phase's JSON line, then the card's name and power limit.  Exits 2
without CUDA.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ops_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    import chip_smoke as cs
    from spark_rapids_tpu_torch import TorchSession, native, tpcds, tpch
    from spark_rapids_tpu_torch.config import TASK_TARGET_BYTES as TTB
    from spark_rapids_tpu_torch.config import TorchConf
    from spark_rapids_tpu_torch.ops import kernels
    from spark_rapids_tpu_torch.plugin import TorchPlugin

    if args.pairs is not None:
        cs.OPS_PAIRS = args.pairs
    TorchPlugin.get_or_create(TorchConf(), "cuda")
    kernels.build_library("hash_string")
    kernels.load_library("hash_string")
    native.build()
    native.load()
    work = os.path.join(ROOT, "spark_rapids_tpu_torch", "_build")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as data_dir:
        paths = tpch.make_lineitem(data_dir, with_q1_cols=True)
        tables = pa.concat_tables([pq.read_table(p) for p in paths])
        ref6 = cs.reference_q6(pa, pc, tables)
        ref1 = cs.reference_q1(pa, pc, tables)
        del tables
        q3_dir = os.path.join(data_dir, "q3")
        os.makedirs(q3_dir)
        li_paths = tpch.make_lineitem(q3_dir, with_orderkey=True)
        orders_path = tpch.make_orders(q3_dir)
        ref3 = cs.reference_q3(
            pa, pc, pa.concat_tables([pq.read_table(p) for p in li_paths]),
            pq.read_table(orders_path)).to_pylist()
        star = cs.star_tables(pa, pq, data_dir, tpcds)
        cs.ops_phase(torch, pa, pc, kernels, TorchSession, tpch, tpcds, TTB,
                     paths, ref6, ref1, star, li_paths, orders_path, ref3)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
