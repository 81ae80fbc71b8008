#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each:
  device   card name, and its name and power limit from nvidia-smi;
  build    nvcc build of every kernel from csrc/, with its time;
  kernels  each kernel against its plain PyTorch version (exact match
           over a grid of shapes) and timed at large shapes;
  q6, q1   TPC-H q6 and q1 over 6 x 2^20 generated lineitem rows (about
           SF1) through TorchSession(device="cuda"), six scan tasks
           (scan.taskTargetBytes = 8 MiB): one warm-up, then the median
           of 3 wall times; each result held against a pyarrow.compute
           reference on the same files.  Kernel launch counts are reset
           just before each query's runs and read just after.
Then the per-kernel summary line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failure raises before that line and
exits non-zero.  Without CUDA, or outside a checkout of the repository,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the 32-bit rate
#: outside the tensor cores, which bounds the integer mixing arithmetic
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

EXACT_WIDTHS = (1, 2, 3, 4, 5, 7, 8, 16, 33, 128, 200)
EXACT_ROWS = (1, 1023, 1025, 65537)
TIMED_ROWS = 6 * (1 << 20)
TIMED_WIDTHS = (1, 16, 64)
TASK_TARGET_BYTES = 8 << 20
REL_TOL = 1e-9


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of fn over iters launches, by CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def string_inputs(torch, n: int, width: int, gen):
    """Random bytes (>= 0x80 included), lengths 0..W, zeroed padding."""
    dev = gen.device
    chars = torch.randint(0, 256, (n, width), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    lengths = torch.randint(0, width + 1, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
    pad = torch.arange(width, device=dev)[None, :] < lengths[:, None]
    return (chars * pad).contiguous(), lengths


def k1_bound_ms(torch, lengths, width: int) -> tuple[float, str]:
    """Least time for K1 on these inputs: bytes (N*W chars + 4N lengths
    + 4N seeds read, 4N hashes written) over HBM bandwidth, or the
    integer operations these lengths need over the 32-bit ALU rate
    (~15 per 4-byte block, ~11 per tail byte, ~12 for fmix and the
    loads of length and seed), whichever is larger."""
    n = int(lengths.shape[0])
    lens = lengths.clamp(0, width).long()
    blocks = int((lens // 4).sum())
    tails = int((lens % 4).sum())
    ops = 15 * blocks + 11 * tails + 12 * n
    t_bytes = (n * width + 12 * n) / HBM_BYTES_PER_S
    t_ops = ops / ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_k1(torch, kernels, dev) -> dict:
    """K1 against its plain version, bit for bit, chained seeds."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    checked = 0
    for width in EXACT_WIDTHS:
        for n in EXACT_ROWS:
            c1, l1 = string_inputs(torch, n, width, gen)
            c2, l2 = string_inputs(torch, n, width, gen)
            seeds = torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen,
                                  device=dev, dtype=torch.int64).to(
                                      torch.int32)
            k = kernels.hash_string(c1, l1, seeds)
            r = kernels.hash_string_bytes_reference(c1, l1, seeds)
            k2 = kernels.hash_string(c2, l2, k)  # chained: hash seeds next
            r2 = kernels.hash_string_bytes_reference(c2, l2, r)
            torch.cuda.synchronize()
            for got, want in ((k, r), (k2, r2)):
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    raise AssertionError(
                        f"K1 disagrees with its plain version at N={n} "
                        f"W={width}: {bad} rows differ")
            checked += 2
    return {"cases": checked, "widths": list(EXACT_WIDTHS),
            "rows": list(EXACT_ROWS), "max_abs_err": 0}


def time_k1(torch, kernels, dev, n: int, width: int, gen,
            plain_iters: int) -> dict:
    chars, lengths = string_inputs(torch, n, width, gen)
    seeds = torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen,
                          device=dev, dtype=torch.int64).to(torch.int32)
    got = kernels.hash_string(chars, lengths, seeds)
    want = kernels.hash_string_bytes_reference(chars, lengths, seeds)
    max_abs_err = int((got.long() - want.long()).abs().max()) if n else 0
    if max_abs_err:
        raise AssertionError(f"K1 disagrees at N={n} W={width}")
    ms = cuda_ms(torch, lambda: kernels.hash_string(chars, lengths, seeds),
                 iters=20)
    plain_ms = cuda_ms(
        torch, lambda: kernels.hash_string_bytes_reference(
            chars, lengths, seeds), iters=plain_iters)
    bound_ms, bound_by = k1_bound_ms(torch, lengths, width)
    return {"n": n, "w": width, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": max_abs_err}


def reference_q1(pa, pc, tables) -> dict:
    t = tables.filter(pc.less_equal(tables["l_shipdate"], 10471))
    price, disc = t["l_extendedprice"], t["l_discount"]
    disc_price = pc.multiply(price, pc.subtract(1.0, disc))
    charge = pc.multiply(disc_price, pc.add(1.0, t["l_tax"]))
    t = t.append_column("disc_price", disc_price).append_column(
        "charge", charge)
    g = t.group_by(["l_returnflag", "l_linestatus"]).aggregate([
        ("l_quantity", "sum"), ("l_extendedprice", "sum"),
        ("disc_price", "sum"), ("charge", "sum"), ("l_quantity", "mean"),
        ("l_extendedprice", "mean"), ("l_discount", "mean"),
        ("l_quantity", "count")])
    names = ["sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
             "avg_qty", "avg_price", "avg_disc", "count_order"]
    cols = ["l_quantity_sum", "l_extendedprice_sum", "disc_price_sum",
            "charge_sum", "l_quantity_mean", "l_extendedprice_mean",
            "l_discount_mean", "l_quantity_count"]
    out = {}
    for row in g.to_pylist():
        key = (row["l_returnflag"], row["l_linestatus"])
        out[key] = {n: row[c] for n, c in zip(names, cols)}
    return out


def reference_q6(pa, pc, tables) -> dict:
    t = tables
    cond = pc.and_(
        pc.and_(pc.and_(pc.greater_equal(t["l_shipdate"], 8766),
                        pc.less(t["l_shipdate"], 9131)),
                pc.and_(pc.greater_equal(t["l_discount"], 0.05),
                        pc.less_equal(t["l_discount"], 0.07))),
        pc.less(t["l_quantity"], 24.0))
    t = t.filter(cond)
    rev = pc.sum(pc.multiply(t["l_extendedprice"], t["l_discount"]))
    return {(): {"revenue": rev.as_py()}}


def compare(got_table, want: dict, n_keys: int) -> float:
    """Keys and integer columns exact, floats within REL_TOL; returns
    the largest relative float error."""
    rows = got_table.to_pylist()
    names = got_table.schema.names
    if len(rows) != len(want):
        raise AssertionError(f"{len(rows)} result rows, reference has "
                             f"{len(want)}")
    worst = 0.0
    for row in rows:
        key = tuple(row[n] for n in names[:n_keys])
        if key not in want:
            raise AssertionError(f"unexpected group {key}")
        for name, ref in want[key].items():
            v = row[name]
            if isinstance(ref, int):
                if v != ref:
                    raise AssertionError(f"{key} {name}: {v} != {ref}")
                continue
            rel = abs(v - ref) / max(abs(ref), 1e-300)
            worst = max(worst, rel)
            if rel > REL_TOL:
                raise AssertionError(
                    f"{key} {name}: {v} vs {ref} (rel {rel:.3e})")
    return worst


def run_query(torch, qfn, session, paths, kernels, ref, n_keys: int,
              shapes: list) -> dict:
    """The main path: counts reset just before, read just after."""
    original = kernels.hash_string

    def recording(chars, lengths, seeds):
        shapes.append(tuple(chars.shape))
        return original(chars, lengths, seeds)

    kernels.hash_string = recording
    original.launches = 0
    try:
        t0 = time.perf_counter()
        qfn(session, paths).collect()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        walls = []
        result = None
        for _ in range(3):
            t0 = time.perf_counter()
            result = qfn(session, paths).collect()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        kernels.hash_string = original
    launches = original.launches
    worst = compare(result, ref, n_keys)
    return {"rows": result.num_rows, "warmup_s": warm_s,
            "wall_s": walls, "median_s": statistics.median(walls),
            "k1_launches": launches, "max_rel_err": worst,
            **breakdown(torch, qfn, session, paths)}


def breakdown(torch, qfn, session, paths) -> dict:
    """Where one run's time goes: the scan alone (Parquet decode and
    upload of every task, drained with nothing above it), and the
    device's busy time over a profiled run, whose complement over the
    run's wall time is the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plan = qfn(session, paths).physical_plan()
    scan = [n for n in plan.walk() if not n.children][0]
    t0 = time.perf_counter()
    for _ in scan.execute():
        pass
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        qfn(session, paths).collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    return {"scan_only_s": scan_s, "profiled_wall_s": wall,
            "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "device_kernels": [[e.key[:60], e.count,
                                e.self_device_time_total / 1e3]
                               for e in top]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on an NVIDIA card only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch import TorchSession, tpch
    from spark_rapids_tpu_torch.config import TASK_TARGET_BYTES as TTB
    from spark_rapids_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = kernels.build_library("hash_string")
    kernels.load_library("hash_string")
    build_s = time.perf_counter() - t0
    ptxas = built.with_suffix(".log").read_text() if \
        built.with_suffix(".log").exists() else ""
    emit("build", seconds=build_s, library=os.path.relpath(built, ROOT),
         ptxas=[ln for ln in ptxas.splitlines() if "registers" in ln
                or "spill" in ln])

    exact = check_k1(torch, kernels, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    large = [time_k1(torch, kernels, dev, TIMED_ROWS, w, gen, plain_iters=3)
             for w in TIMED_WIDTHS]
    emit("kernels", name="hash_string", exact=exact, timed=large)

    work = os.path.join(ROOT, "spark_rapids_tpu_torch", "_build")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as data_dir:
        t0 = time.perf_counter()
        paths = tpch.make_lineitem(data_dir, with_q1_cols=True)
        gen_s = time.perf_counter() - t0
        tables = pa.concat_tables([pq.read_table(p) for p in paths])
        session = TorchSession({TTB: TASK_TARGET_BYTES}, device="cuda")
        n_tasks = tpch.q1_dataframe(session, paths).physical_plan()
        scans = [n for n in n_tasks.walk()
                 if type(n).__name__ == "ParquetScanExec"]
        if scans[0].num_partitions != len(paths):
            raise AssertionError(f"{scans[0].num_partitions} scan tasks, "
                                 f"expected {len(paths)}")
        q6_shapes: list = []
        q6 = run_query(torch, tpch.q6_dataframe, session, paths, kernels,
                       reference_q6(pa, pc, tables), 0, q6_shapes)
        emit("q6", rows_in=tables.num_rows, datagen_s=gen_s, **q6)
        q1_shapes: list = []
        q1 = run_query(torch, tpch.q1_dataframe, session, paths, kernels,
                       reference_q1(pa, pc, tables), 2, q1_shapes)
        emit("q1", rows_in=tables.num_rows, k1_shapes=sorted(set(q1_shapes)),
             **q1)
    if q1["k1_launches"] <= 0:
        raise AssertionError("q1 ran without launching K1")

    # K1 at the shapes q1 gave it (launch-latency bound at these sizes)
    main_shapes = sorted(set(q1_shapes))
    at_main = [time_k1(torch, kernels, dev, n, w, gen, plain_iters=20)
               for n, w in main_shapes]
    worst = max(at_main, key=lambda r: r["ms"])
    summary = {
        "name": "hash_string", "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/hash_string.cu",
        "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:138",
        "launches": q1["k1_launches"] + q6["k1_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in at_main + large),
        "ms": worst["ms"], "plain_ms": worst["plain_ms"],
        "bound_ms": worst["bound_ms"], "bound_by": worst["bound_by"],
        "library_ms": None,
        "shape": [worst["n"], worst["w"]],
        "main_path_shapes": at_main, "large_shapes": large,
    }
    print(json.dumps({"kernels": [summary]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
