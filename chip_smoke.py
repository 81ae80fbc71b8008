#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each:
  device   card name, and its name and power limit from nvidia-smi;
  build    nvcc build of every kernel from csrc/, with its time;
  kernels  both entry points of K1 (hash_string: one string column;
           hash_columns: a key tuple -> hash or partition id) against
           their plain PyTorch versions, bit for bit, over a grid of
           widths (the direct-load width included), row counts,
           partition counts, type mixes and a row slice whose data_ptr()
           is not aligned; then timed at N = 6 x 2^20 rows (the
           device's own time per launch, from torch.profiler);
  q6, q1   TPC-H q6 and q1 over 6 x 2^20 generated lineitem rows (about
           SF1) through TorchSession(device="cuda"), six scan tasks
           (scan.taskTargetBytes = 8 MiB): one warm-up, then the median
           of 3 wall times; each result held against a pyarrow.compute
           reference on the same files.  Kernel launch counts are reset
           just before each query's runs and read just after; q1 must
           launch hash_columns once per map batch and hash_string never;
  q3       TPC-H q3 (lineitem JOIN orders, revenue per order, ORDER BY
           revenue DESC LIMIT 10) over 6 x 2^20 lineitem rows with order
           keys and 2^20 orders, the same way: the top 10 held against
           a pyarrow join / group_by / sort of the same files (keys
           exact, revenue within REL_TOL; rows tied on revenue at the
           10th place by revenue only); hash_columns must launch once
           per non-empty map batch of its three exchanges (counted by
           draining each exchange's child before the runs) and
           hash_string never.  Its orders side is too large to
           broadcast, so it plans a partition-wise shuffled join.  It
           runs first with the runtime filter off (the earlier slices'
           plan and launches), then with it on, as users get it: a
           filter from the orders keys, built under the orders side's
           exchange, on the lineitem scan, which adds two hash_columns
           launches per batch it folds and two for its range table;
  q67      TPC-DS q67 (sales per store and item, ranked within each store
           by a rank() window, the top 10 of each store ORDER BY store,
           rank, item) over 6 x 2^20 generated store_sales rows in six
           files, one scan task each (scan.taskTargetBytes = 4 MiB, below
           one ~4.6 MiB file), the same way: the rows held against a
           pyarrow group_by and a numpy rank of the same files (keys and
           ranks exact, sums within REL_TOL; two rows of one store whose
           sums agree within REL_TOL may come in either order);
           hash_columns must launch once per non-empty map batch of its
           two hash exchanges (the range exchange of its ORDER BY hashes
           nothing) and hash_string never;
  q3ds     TPC-DS q3 (date_dim JOIN store_sales JOIN item, November sales
           of manufacturer 128's brands by year, ORDER BY year, sales DESC,
           brand LIMIT 100) over the whole calendar (73 049 days), 18 000
           items and 6 x 2^20 store_sales rows in six files, a scan task
           each, the same way: two broadcast joins (date_dim built left,
           item built right), a runtime filter from date_dim's keys on the
           store_sales scan, whose two Bloom lanes K1 hashes; the 100 rows
           held against a pyarrow join / group_by / sort (keys exact, sums
           within REL_TOL, rows tied on sales may trade places); the
           filter's state, what it pruned and the rows each scan uploaded
           from one more run; then all of it again with the filter off,
           whose rows must be the same.  hash_columns must launch once per
           non-empty map batch of the aggregate's exchange plus twice per
           non-empty batch the filter folds plus twice per filter
           published with a range table, and hash_string never;
  q93      TPC-DS q93 over the same store_sales files and a store_returns
           derived from them (~10 % of the sales rows, the spec's SF1
           ratio; each return copies the keys of a sale) with the ten
           reasons, the same way: store_sales LEFT OUTER JOIN
           store_returns, too large to broadcast, plans a partition-wise
           shuffled join (a hash exchange on each side's (LONG, LONG)
           key), and the one reason row broadcasts; no runtime filter;
           the 100 rows held against a pyarrow left outer join /
           filter / CASE / group_by / sort (customers exact, sums within
           REL_TOL, rows whose sums tie may trade places); hash_columns
           must launch once per non-empty map batch of its three
           exchanges and hash_string never;
  star     TPC-DS q42, q52 and q55 (the star join under other filters
           and STRING group keys) once each over the same tables, not
           profiled: two broadcast joins and the runtime filter on the
           store_sales scan, the rows held against a pyarrow reference,
           and hash_columns launched as q3ds's rule says;
  main     hash_columns at the calls q1, q3 (filter off and on), q67,
           q3ds, q93 and the star queries made (the largest call of
           each key signature and seed in each phase: the filters'
           lanes and range tables hash from seeds 42 and 0x9747B28C),
           and hash_string on one of q1's key columns, against their
           plain versions, with the device's own time per launch
           (torch.profiler kernel time over a loop) and the
           host-inclusive time per call (host clock over the same loop)
           reported apart.
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

#: direct loads up to 56, staged from 57 (kernels.NARROW_WIDTH)
EXACT_WIDTHS = (1, 2, 3, 4, 5, 7, 8, 16, 33, 56, 57, 64, 128, 200)
#: staged through shared memory, and read straight from global memory
WIDE_WIDTH, DIRECT_WIDTH = 256, 8000
EXACT_ROWS = (1, 1023, 1025, 65537)
EXACT_PARTITIONS = (0, 1, 8, 200)
#: rows cut off the front of a matrix so its data_ptr() is unaligned
SLICE_ROWS = 3
TIMED_ROWS = 6 * (1 << 20)
TIMED_WIDTHS = (1, 16, 64, 256)
#: hash_columns' timed tuple: (STRING W=16, LONG, DOUBLE), 20 % NULLs
TIMED_TUPLE = (("string", 16), ("long",), ("double",))
TIMED_PARTITIONS = 8
NULL_SHARE = 0.2
#: type mixes of the exact check (17 columns: two launches, chained)
MIXES = {
    "timed": TIMED_TUPLE,
    "all_types": (("bool",), ("int",), ("date",), ("long",), ("double",),
                  ("string", 3), ("string", 64)),
    "strings": (("string", WIDE_WIDTH), ("string", 2), ("string", 128)),
    "direct": (("string", DIRECT_WIDTH), ("string", 5), ("int",)),
    "chained_17": (("string", 1), ("int",), ("long",), ("double",),
                   ("string", 7), ("bool",), ("date",), ("string", 33),
                   ("long",), ("string", 4), ("double",), ("int",),
                   ("string", 1), ("bool",), ("string", 200), ("date",),
                   ("string", 16)),
}
TASK_TARGET_BYTES = 8 << 20
#: q67: six files of 2^20 store_sales rows, ~4.6 MiB each, a task each
Q67_ROWS, Q67_FILES, Q67_TASK_TARGET_BYTES = 6 << 20, 6, 4 << 20
#: q3ds: six store_sales files of 2^20 rows and 23 columns, a task each
Q3DS_FILES, Q3DS_ROWS_PER_FILE, Q3DS_TASK_TARGET_BYTES = 6, 1 << 20, 8 << 20
REL_TOL = 1e-9
#: launches timed at each main-path shape: the kernel's, and its plain
#: version's (tens to hundreds of PyTorch kernels a call, so fewer)
KERNEL_ITERS, PLAIN_ITERS = 50, 10


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script began."""
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - _START,
                      **fields}), flush=True)


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


def random_seeds(torch, n: int, gen):
    return torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen,
                         device=gen.device, dtype=torch.int64).to(
                             torch.int32)


def k1_bound_ms(torch, lengths, width: int) -> tuple[float, str]:
    """Least time for hash_string on these inputs: bytes (N*W chars +
    4N lengths + 4N seeds read, 4N hashes written) over HBM bandwidth,
    or the integer operations these lengths need over the 32-bit ALU
    rate (~15 per 4-byte block, ~11 per tail byte, ~12 for fmix and the
    loads of length and seed), whichever is larger."""
    n = int(lengths.shape[0])
    lens = lengths.clamp(0, width).long()
    blocks = int((lens // 4).sum())
    tails = int((lens % 4).sum())
    ops = 15 * blocks + 11 * tails + 12 * n
    return bound(n * width + 12 * n, ops)


def bound(n_bytes: float, ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tile_of(geo) -> dict:
    return {"threads": geo.threads, "pitches": geo.pitches,
            "smem_words": geo.smem_words}


def check_k1(torch, kernels, dev) -> dict:
    """hash_string against its plain version, bit for bit, with chained
    seeds, over every width and row count, and over row slices whose
    data_ptr() is not 4-byte aligned."""
    def staged(width):
        return kernels.tile_geometry([(kernels.STRING_TAG, width)],
                                     max(EXACT_ROWS)).pitches[0] > 0

    if (staged(DIRECT_WIDTH) or not staged(WIDE_WIDTH) or staged(56)
            or not staged(57)):
        raise AssertionError("the widths no longer take the branches "
                             "they are meant to check")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    checked = 0
    widths = EXACT_WIDTHS + (WIDE_WIDTH, DIRECT_WIDTH)
    for width in widths:
        for n in EXACT_ROWS:
            c1, l1 = string_inputs(torch, n, width, gen)
            c2, l2 = string_inputs(torch, n + SLICE_ROWS, width, gen)
            c2, l2 = c2[SLICE_ROWS:], l2[SLICE_ROWS:]
            seeds = random_seeds(torch, n, gen)
            k = kernels.hash_string(c1, l1, seeds)
            r = kernels.hash_string_bytes_reference(c1, l1, seeds)
            k2 = kernels.hash_string(c2, l2, k)  # chained: hash seeds next
            r2 = kernels.hash_string_bytes_reference(c2, l2, r)
            torch.cuda.synchronize()
            for got, want in ((k, r), (k2, r2)):
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    raise AssertionError(
                        f"hash_string disagrees with its plain version at "
                        f"N={n} W={width}: {bad} rows differ")
            checked += 2
    return {"cases": checked, "widths": list(widths),
            "rows": list(EXACT_ROWS), "sliced_rows": SLICE_ROWS,
            "max_abs_err": 0}


def make_column(torch, spec: tuple, n: int, gen, offset: int = 0):
    """One random column of ``spec`` with NULL_SHARE NULLs; doubles hold
    -0.0, 0.0 and NaNs with several payloads.  ``offset`` > 0 cuts that
    many rows off the front of every tensor (unaligned data_ptr())."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import Column, StringColumn

    dev = gen.device
    m = n + offset
    valid = (torch.rand(m, generator=gen, device=dev) >= NULL_SHARE)[offset:]
    kind = spec[0]
    if kind == "string":
        chars, lengths = string_inputs(torch, m, spec[1], gen)
        return StringColumn(chars[offset:], lengths[offset:], valid)
    if kind == "double":
        x = torch.randn(m, generator=gen, device=dev,
                        dtype=torch.float64) * 1e6
        x[::7] = -0.0
        x[1::11] = 0.0
        x[2::13] = float("nan")
        bits = x.view(torch.int64)
        bits[3::13] = 0x7FF0000000000001      # signalling NaN payload
        bits[4::17] = -0x0008000000000000     # 0xFFF8...: negative NaN
        return Column(x[offset:], valid, T.DOUBLE)
    if kind == "bool":
        data = torch.randint(0, 2, (m,), generator=gen, device=dev).bool()
        return Column(data[offset:], valid, T.BOOLEAN)
    if kind == "long":
        data = torch.randint(-(1 << 62), 1 << 62, (m,), generator=gen,
                             device=dev, dtype=torch.int64)
        return Column(data[offset:], valid, T.LONG)
    data = random_seeds(torch, m, gen)
    return Column(data[offset:], valid, T.DATE if kind == "date" else T.INT)


def check_hash_columns(torch, kernels, dev) -> dict:
    """hash_columns against its plain version, bit for bit: every type
    mix x row count x partition count (0 = hashes), each mix once more
    on row slices with unaligned data_ptr(), and once from a seed other
    than 42."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    checked = 0
    for name, mix in MIXES.items():
        cases = [(n, 0, parts, 42) for n in EXACT_ROWS
                 for parts in EXACT_PARTITIONS]
        cases += [(1025, SLICE_ROWS, 8, 42), (1023, 0, 0, 7)]
        for n, offset, parts, seed in cases:
            cols = [make_column(torch, spec, n, gen, offset) for spec in mix]
            seeds = torch.full((n,), seed, dtype=torch.int32, device=dev)
            got = kernels.hash_columns(cols, n, dev, seed, parts)
            want = kernels.hash_columns_reference(cols, seeds, parts)
            torch.cuda.synchronize()
            if got.dtype != want.dtype or not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(
                    f"hash_columns disagrees with its plain version on "
                    f"{name} N={n} offset={offset} partitions={parts} "
                    f"seed={seed}: {bad} rows differ")
            checked += 1
    return {"cases": checked, "mixes": {k: [list(s) for s in v]
                                        for k, v in MIXES.items()},
            "rows": list(EXACT_ROWS), "partitions": list(EXACT_PARTITIONS),
            "max_abs_err": 0}


def time_k1(torch, kernels, dev, n: int, width: int, gen,
            plain_iters: int) -> dict:
    chars, lengths = string_inputs(torch, n, width, gen)
    seeds = random_seeds(torch, n, gen)
    got = kernels.hash_string(chars, lengths, seeds)
    want = kernels.hash_string_bytes_reference(chars, lengths, seeds)
    max_abs_err = int((got.long() - want.long()).abs().max()) if n else 0
    if max_abs_err:
        raise AssertionError(f"hash_string disagrees at N={n} W={width}")
    t = device_and_host_ms(
        torch, lambda: kernels.hash_string(chars, lengths, seeds), iters=20)
    plain_ms = cuda_ms(
        torch, lambda: kernels.hash_string_bytes_reference(
            chars, lengths, seeds), iters=plain_iters)
    bound_ms, bound_by = k1_bound_ms(torch, lengths, width)
    return {"n": n, "w": width, "ms": t["device_ms"],
            "host_ms": t["host_ms"], "event_ms": t["event_ms"],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / t["device_ms"],
            "max_abs_err": max_abs_err,
            "tile": tile_of(kernels.tile_geometry(
                [(kernels.STRING_TAG, width)], n))}


def tuple_bound_ms(torch, cols, n: int, num_partitions: int):
    """Least time for hash_columns: every column read once (values or
    chars + lengths, and validity), the output written once, over HBM
    bandwidth; or the integer operations the values need (~15 per
    4-byte block, ~11 per string tail byte, ~12 per fmix, ~10 for a
    double's normalisation and ~10 for pmod) over the 32-bit rate."""
    from spark_rapids_tpu_torch.columnar.column import StringColumn

    n_bytes = (8 if num_partitions else 4) * n
    ops = (10 * n if num_partitions else 0)
    for c in cols:
        n_bytes += c.validity.numel()
        if isinstance(c, StringColumn):
            n_bytes += c.chars.numel() + 4 * n
            lens = c.lengths.clamp(0, c.width).long()
            ops += 15 * int((lens // 4).sum()) + 11 * int((lens % 4).sum())
            ops += 12 * n
        else:
            size = c.data.element_size()
            n_bytes += size * n
            ops += (15 * max(1, size // 4) + 12) * n
            if c.data.dtype == torch.float64:
                ops += 10 * n
    return bound(n_bytes, ops)


def time_hash_columns(torch, kernels, dev, n: int, gen) -> dict:
    cols = [make_column(torch, spec, n, gen) for spec in TIMED_TUPLE]
    seeds = torch.full((n,), 42, dtype=torch.int32, device=dev)
    got = kernels.hash_columns(cols, n, dev, num_partitions=TIMED_PARTITIONS)
    want = kernels.hash_columns_reference(cols, seeds, TIMED_PARTITIONS)
    max_abs_err = int((got - want).abs().max())
    if max_abs_err:
        raise AssertionError(f"hash_columns disagrees at N={n}")
    t = device_and_host_ms(torch, lambda: kernels.hash_columns(
        cols, n, dev, num_partitions=TIMED_PARTITIONS), iters=20)
    plain_ms = cuda_ms(torch, lambda: kernels.hash_columns_reference(
        cols, seeds, TIMED_PARTITIONS), iters=3)
    bound_ms, bound_by = tuple_bound_ms(torch, cols, n, TIMED_PARTITIONS)
    return {"n": n, "tuple": [list(s) for s in TIMED_TUPLE],
            "null_share": NULL_SHARE, "partitions": TIMED_PARTITIONS,
            "ms": t["device_ms"], "host_ms": t["host_ms"],
            "event_ms": t["event_ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / t["device_ms"],
            "max_abs_err": max_abs_err,
            "tile": tile_of(kernels.tile_geometry(
                [(kernels.STRING_TAG, 16), (kernels.INT64_TAG, 0),
                 (kernels.FLOAT64_TAG, 0)], n))}


def device_and_host_ms(torch, fn, iters: int) -> dict:
    """The device's own time per call (the CUDA kernel time that
    torch.profiler records over ``iters`` calls, over ``iters``), the
    host-inclusive time per call (host clock over ``iters`` calls ending
    in a synchronize, profiler off) and the CUDA-event time of the same
    loop, reported apart: where the host enqueues a call more slowly than
    the device runs it, the event time is the host's, not the device's.
    The profiler now and then records no device event for a loop; it is
    asked up to 3 times, then the event time stands in, and
    ``device_ms_source`` says which it is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    event_ms = cuda_ms(torch, fn, iters)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in kern)
        if device_us > 0:
            return {"device_ms": device_us / 1e3 / iters,
                    "device_ms_source": "profiler", "host_ms": host_ms,
                    "event_ms": event_ms,
                    "device_kernels_per_call":
                        sum(e.count for e in kern) / iters}
    return {"device_ms": event_ms, "device_ms_source": "cuda_events",
            "host_ms": host_ms, "event_ms": event_ms,
            "device_kernels_per_call": None}


def signature(cols) -> tuple:
    """A key tuple's column types, strings with their width."""
    return tuple(f"{c.dtype.name}{getattr(c, 'width', '')}" for c in cols)


def at_main_path(torch, kernels, calls: dict) -> dict:
    """hash_columns at the largest call of each key signature each phase
    of the main path made (``calls``: phase -> its calls): held against
    its plain version on the same inputs, then timed both ways."""
    largest: dict = {}
    for phase, phase_calls in calls.items():
        for call in phase_calls:
            cols, n, seed, parts = call
            key = (phase, signature(cols), seed, parts)
            if key not in largest or n > largest[key][1]:
                largest[key] = call
    rows = []
    for (phase, sig, _, _), (cols, n, seed, parts) in largest.items():
        key = (n, sig, seed, parts)
        dev = cols[0].validity.device if cols else torch.device("cuda")
        seeds = torch.full((n,), seed - (1 << 32) if seed >= 1 << 31
                           else seed, dtype=torch.int32, device=dev)
        got = kernels.hash_columns(cols, n, dev, seed, parts)
        want = kernels.hash_columns_reference(cols, seeds, parts)
        err = int((got.long() - want.long()).abs().max()) if n else 0
        if err:
            raise AssertionError(f"hash_columns disagrees at {key}")
        kt = device_and_host_ms(
            torch, lambda: kernels.hash_columns(cols, n, dev, seed, parts),
            iters=KERNEL_ITERS)
        pt = device_and_host_ms(
            torch, lambda: kernels.hash_columns_reference(cols, seeds, parts),
            iters=PLAIN_ITERS)
        bound_ms, bound_by = tuple_bound_ms(torch, cols, n, parts)
        rows.append({"phase": phase, "n": n, "columns": list(sig),
                     "seed": seed,
                     "partitions": parts,
                     "max_abs_err": err, "ms": kt["device_ms"],
                     "ms_source": kt["device_ms_source"],
                     "host_ms": kt["host_ms"],
                     "plain_ms": pt["host_ms"],
                     "plain_device_ms": pt["device_ms"],
                     "plain_device_kernels": pt["device_kernels_per_call"],
                     "kernels_per_call": kt["device_kernels_per_call"],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "share_of_bound": bound_ms / kt["device_ms"]})
    return max(rows, key=lambda r: r["ms"]), rows


def k1_at_main_path(torch, kernels, calls: list) -> dict:
    """hash_string on the first string key column of q1's first call
    (the shape a per-column hash of q1's keys takes), against its plain
    version, timed both ways."""
    from spark_rapids_tpu_torch.columnar.column import StringColumn

    cols, n, seed, _ = calls[0]
    c = next(c for c in cols if isinstance(c, StringColumn))
    seeds = torch.full((n,), seed, dtype=torch.int32, device=c.chars.device)
    got = kernels.hash_string(c.chars, c.lengths, seeds)
    want = kernels.hash_string_bytes_reference(c.chars, c.lengths, seeds)
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError(f"hash_string disagrees at q1's ({n}, "
                             f"{c.width})")
    kt = device_and_host_ms(
        torch, lambda: kernels.hash_string(c.chars, c.lengths, seeds),
        iters=KERNEL_ITERS)
    pt = device_and_host_ms(
        torch, lambda: kernels.hash_string_bytes_reference(
            c.chars, c.lengths, seeds), iters=PLAIN_ITERS)
    bound_ms, bound_by = k1_bound_ms(torch, c.lengths, c.width)
    return {"n": n, "w": c.width, "max_abs_err": err,
            "ms": kt["device_ms"], "host_ms": kt["host_ms"],
            "event_ms": kt["event_ms"], "plain_ms": pt["host_ms"],
            "plain_device_ms": pt["device_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by}


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


def reference_q3(pa, pc, lineitem, orders):
    """q3 by pyarrow: every (order, date, priority) group with its
    revenue, largest revenue first."""
    li = lineitem.filter(pc.greater(lineitem["l_shipdate"], 9500))
    od = orders.filter(pc.less(orders["o_orderdate"], 9500))
    j = li.join(od, keys="l_orderkey", right_keys="o_orderkey",
                join_type="inner")
    j = j.append_column("rev", pc.multiply(
        j["l_extendedprice"], pc.subtract(1.0, j["l_discount"])))
    g = j.group_by(["l_orderkey", "o_orderdate", "o_shippriority"]) \
        .aggregate([("rev", "sum")])
    return g.sort_by([("rev_sum", "descending")])


def compare_ranked(got_table, want: list, n: int, keys: tuple, got_sum: str,
                   want_sum: str) -> float:
    """Rows of a ranking against the reference's first n (``want``: every
    group, in order), place by place: keys exact and sums within
    REL_TOL, except that a row may trade places with one whose sum
    agrees within REL_TOL (rows tied at the n-th place included).
    Returns the largest relative sum error."""
    got = got_table.to_pylist()
    sums = {tuple(r[k] for k in keys): r[want_sum] for r in want}
    want = want[:n]
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} rows, reference has {len(want)}")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        key = tuple(g[k] for k in keys)
        if key not in sums:
            raise AssertionError(f"place {i}: unexpected group {key}")
        ref_sum = sums[key]
        rel = abs(g[got_sum] - ref_sum) / max(abs(ref_sum), 1e-300)
        worst = max(worst, rel)
        if rel > REL_TOL:
            raise AssertionError(f"place {i} {key}: {g[got_sum]} vs "
                                 f"{ref_sum} (rel {rel:.3e})")
        tied = abs(g[got_sum] - w[want_sum]) <= REL_TOL * max(
            abs(w[want_sum]), 1e-300)
        if key != tuple(w[k] for k in keys) and not tied:
            raise AssertionError(f"place {i}: {g} vs reference {w}")
    return worst


def reference_q67(pc, tables):
    """q67 by pyarrow and numpy: every (store, item) group's sales, and
    the rows q67 keeps (rank within the store by sales, descending, ties
    sharing the lowest rank; rank <= 10), by (store, rank, item)."""
    import numpy as np

    t = tables.append_column("sales", pc.multiply(
        tables["ss_sales_price"], tables["ss_quantity"]))
    g = t.group_by(["ss_store_sk", "ss_item_sk"]).aggregate(
        [("sales", "sum")])
    store = g["ss_store_sk"].to_numpy()
    item = g["ss_item_sk"].to_numpy()
    sums = g["sales_sum"].to_numpy()
    rows = []
    for s in np.unique(store):
        m = store == s
        desc = np.sort(-sums[m])
        rank = np.searchsorted(desc, -sums[m], side="left") + 1
        for it, v, rk in zip(item[m], sums[m], rank):
            if rk <= 10:
                rows.append({"ss_store_sk": int(s), "ss_item_sk": int(it),
                             "sumsales": float(v), "rk": int(rk)})
    rows.sort(key=lambda r: (r["ss_store_sk"], r["rk"], r["ss_item_sk"]))
    all_sums = {(int(a), int(b)): float(v)
                for a, b, v in zip(store, item, sums)}
    return rows, all_sums


def compare_q67(got_table, want: list, all_sums: dict) -> float:
    """q67's rows against the reference's, place by place: keys and ranks
    exact and sums within REL_TOL, except that two rows of one store
    whose sums agree within REL_TOL may come in either order.  Returns
    the largest relative sum error."""
    got = got_table.to_pylist()
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} rows, reference has {len(want)}")
    order = [(r["ss_store_sk"], r["rk"], r["ss_item_sk"]) for r in got]
    if order != sorted(order):
        raise AssertionError("rows are not in (store, rank, item) order")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        key = (g["ss_store_sk"], g["ss_item_sk"])
        if key not in all_sums:
            raise AssertionError(f"place {i}: unexpected group {key}")
        ref = all_sums[key]
        rel = abs(g["sumsales"] - ref) / abs(ref)
        worst = max(worst, rel)
        if rel > REL_TOL:
            raise AssertionError(f"place {i} {key}: sales {g['sumsales']} "
                                 f"vs {ref} (rel {rel:.3e})")
        same = all(g[k] == w[k] for k in ("ss_store_sk", "ss_item_sk", "rk"))
        tied = g["ss_store_sk"] == w["ss_store_sk"] and abs(
            ref - w["sumsales"]) <= REL_TOL * abs(w["sumsales"])
        if not (same or tied):
            raise AssertionError(f"place {i}: {g} vs reference {w}")
    return worst


def reference_star(pc, star, date_cond, item_cond, keys: list,
                   names: dict, order: list) -> list:
    """A star query by pyarrow: the date_dim rows ``date_cond(date_dim)``
    keeps x store_sales x the items ``item_cond(item)`` keeps, the sales
    summed by ``keys``; every group as a row of the query's output names
    (``names``: key -> output name) and ``sum``, sorted by ``order``
    ((output name, descending), most significant first)."""
    dd, item = star["date_dim"], star["item"]
    dd = dd.filter(date_cond(dd)).select(["d_date_sk", "d_year"])
    it = item.filter(item_cond(item)).select(
        ["i_item_sk"] + [k for k in keys if k.startswith("i_")])
    j = dd.join(star["sales"], keys="d_date_sk",
                right_keys="ss_sold_date_sk", join_type="inner")
    j = j.join(it, keys="ss_item_sk", right_keys="i_item_sk",
               join_type="inner")
    g = j.group_by(keys).aggregate([("ss_ext_sales_price", "sum")])
    rows = [{**{names.get(k, k): r[k] for k in keys},
             "sum": r["ss_ext_sales_price_sum"]} for r in g.to_pylist()]
    for col_name, desc in reversed(order):
        rows.sort(key=lambda r: r[col_name], reverse=desc)
    return rows


def same_rows(a, b) -> float:
    """Two runs' q3 rows: keys equal place by place, sums within REL_TOL
    (the card's atomic adds sum in no fixed order).  Returns the largest
    relative sum difference."""
    worst = 0.0
    ra, rb = a.to_pylist(), b.to_pylist()
    if len(ra) != len(rb):
        raise AssertionError(f"{len(ra)} rows against {len(rb)}")
    for i, (x, y) in enumerate(zip(ra, rb)):
        keys = ("d_year", "i_brand_id", "i_brand")
        rel = abs(x["sum_agg"] - y["sum_agg"]) / abs(y["sum_agg"])
        worst = max(worst, rel)
        if [x[k] for k in keys] != [y[k] for k in keys] or rel > REL_TOL:
            raise AssertionError(f"place {i}: {x} against {y}")
    return worst


def join_strategies(plan) -> list:
    """Each join of the plan: its exec, type, and the side it builds."""
    return [[type(n).__name__, n.join_type,
             "right" if n.build_is_right else "left"]
            for n in plan.walk() if hasattr(n, "build_is_right")]


def filter_folds(plan) -> tuple:
    """(folds, tables): the non-empty batches the plan's runtime filters
    fold, once for each filter of a build exec, and the filters published
    with a range table (each fold and each table hashes the key's two
    lanes, one K1 launch each): each build exec drained on its own, which
    publishes its filters."""
    folds = tables = 0
    for node in plan.walk():
        if type(node).__name__ == "TpuRuntimeFilterBuildExec":
            folds += len(node.entries) * sum(
                1 for p in range(node.num_partitions)
                for b in node.execute_partition(p) if b.num_rows)
            tables += sum(rf.range_table is not None
                          for _k, rf in node.entries)
    for node in plan.walk():
        if hasattr(node, "close"):
            node.close()
    return folds, tables


def filtered_run(make_df, RF) -> dict:
    """One more run of the plan, kept: its filter's state and build
    time, what each scan pruned, and the rows each uploaded."""
    plan = make_df().physical_plan()
    t0 = time.perf_counter()
    rows = sum(b.num_rows for b in plan.execute())
    wall = time.perf_counter() - t0
    filters = RF.plan_runtime_filters(plan)
    scans = [n for n in plan.walk() if type(n).__name__ == "ParquetScanExec"]
    out = {"rows": rows, "wall_s": wall,
           "pruned_rows": sum(n.metrics["rfPrunedRows"] for n in scans),
           "filters": [{"describe": rf.describe(), "n_keys": rf.n_keys,
                        "min": rf.min_val, "max": rf.max_val,
                        "range_table": None if rf.range_table is None
                        else len(rf.range_table),
                        "build_ms": rf.build_ms} for rf in filters],
           "scans": [{"columns": n.schema.names, "files": len(n.paths),
                      "filters": [c for c, _ in n.runtime_filters],
                      **n.metrics} for n in scans]}
    for node in plan.walk():
        if hasattr(node, "close"):
            node.close()
    return out


def map_batches(plan) -> int:
    """Non-empty batches the plan's hash exchanges hash: each exchange's
    child drained on its own (its own hashes launch here too).  A range
    exchange hashes nothing."""
    n = 0
    for ex in plan.walk():
        if type(ex).__name__ == "TpuShuffleExchangeExec" and type(
                ex.partitioning).__name__ == "HashPartitioning":
            child = ex.children[0]
            n += sum(1 for p in range(child.num_partitions)
                     for b in child.execute_partition(p) if b.num_rows)
    for node in plan.walk():
        if hasattr(node, "close"):
            node.close()
    return n


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


def run_query(torch, make_df, kernels, check, calls: list,
              quick: bool = False) -> dict:
    """The main path: ``make_df()`` is the query's DataFrame, ``check``
    holds a result against its reference and returns the largest
    relative float error.  One warm-up, 3 timed runs and ``breakdown``;
    ``quick``: one timed run only.  Counts reset just before, read just
    after; every hash_columns call is recorded with its inputs."""
    runs = 1 if quick else 4
    original = kernels.hash_columns

    def recording(cols, num_rows, device, seed=42, num_partitions=0):
        calls.append((list(cols), num_rows, seed, num_partitions))
        return original(cols, num_rows, device, seed, num_partitions)

    kernels.hash_columns = recording
    original.launches = 0
    kernels.hash_string.launches = 0
    walls = []
    try:
        for _ in range(runs):
            t0 = time.perf_counter()
            result = make_df().collect()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        kernels.hash_columns = original
    launches = {"hash_columns": original.launches,
                "hash_string": kernels.hash_string.launches}
    worst = check(result)
    warm = None if quick else walls.pop(0)
    return {"rows": result.num_rows, "warmup_s": warm,
            "wall_s": walls, "median_s": statistics.median(walls),
            "runs": runs, "launches": launches, "max_rel_err": worst,
            **({} if quick else breakdown(torch, make_df))}


def breakdown(torch, make_df) -> dict:
    """Where one run's time goes: the scans alone (Parquet decode and
    upload of every task of every scan, drained with nothing above
    them), and the device's busy time and kernel count over a profiled
    run, whose busy time over the run's wall time gives the device's
    idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plan = make_df().physical_plan()
    scans = [n for n in plan.walk() if not n.children]
    t0 = time.perf_counter()
    for scan in scans:
        for _ in scan.execute():
            pass
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        make_df().collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {"scan_only_s": scan_s, "profiled_wall_s": wall,
            "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "device_kernel_count": sum(e.count for e in kern),
            "device_kernels": [[e.key[:60], e.count,
                                e.self_device_time_total / 1e3]
                               for e in top]}


def q3_phase(torch, kernels, RF, tpch, session, li_paths, orders_path, ref3,
             rf_on: bool) -> tuple:
    """TPC-H q3 in one session: the plan's shape (six lineitem tasks,
    one partition-wise shuffled join; with the filter on, its build exec
    under the orders side's exchange and the filter on the lineitem
    scan), the top 10 against the reference, and K1's launches.  Returns
    the record and the hash_columns calls."""
    def q3_df():
        return tpch.q3_dataframe(session, li_paths, orders_path)

    plan = q3_df().physical_plan()
    tasks = [n.num_partitions for n in plan.walk() if not n.children]
    if tasks != [len(li_paths), 1]:
        raise AssertionError(f"q3 scan tasks {tasks}, expected "
                             f"{[len(li_paths), 1]}")
    joins = join_strategies(plan)
    join = next(n for n in plan.walk() if hasattr(n, "build_is_right"))
    if joins != [["TpuShuffledHashJoinExec", "inner", "right"]] or \
            not join.partition_wise:
        raise AssertionError(f"q3 joins {joins}, expected one "
                             f"partition-wise shuffled join")
    built = type(join.children[1].children[0]).__name__ == \
        "TpuRuntimeFilterBuildExec"
    applied = [(n.paths, c) for n in plan.walk()
               for c, _ in getattr(n, "runtime_filters", ())]
    want_rf = (True, [(li_paths, "l_orderkey")]) if rf_on else (False, [])
    if (built, applied) != want_rf:
        raise AssertionError(f"q3 (filter {'on' if rf_on else 'off'}): "
                             f"build exec under the orders exchange "
                             f"{built}, filters {applied}")
    planned = map_batches(q3_df().physical_plan())
    folds, tables = filter_folds(q3_df().physical_plan())
    calls: list = []
    rec = run_query(torch, q3_df, kernels,
                    lambda t: compare_ranked(
                        t, ref3, 10, ("l_orderkey", "o_orderdate",
                                      "o_shippriority"), "revenue",
                        "rev_sum"), calls)
    want = {"hash_columns": rec["runs"] * (planned + 2 * folds + 2 * tables),
            "hash_string": 0}
    if rec["launches"] != want:
        raise AssertionError(
            f"q3 (filter {'on' if rf_on else 'off'}) launched "
            f"{rec['launches']}, expected {want} ({planned} map batches + "
            f"2 x {folds} filter folds + 2 x {tables} range tables a run)")
    out = {"joins": joins, "planned_map_batches": planned,
           "planned_filter_folds": folds, "planned_range_tables": tables,
           "hash_columns_calls": sorted({(n, signature(cols), seed, parts)
                                         for cols, n, seed, parts in calls}),
           **rec}
    if rf_on:
        run = filtered_run(q3_df, RF)
        if not (run["pruned_rows"] > 0 and run["filters"][0]["n_keys"] > 0):
            raise AssertionError(f"q3 filter pruned nothing: {run}")
        # the scans alone run with nothing built: no filter applies
        out["scan_only_unfiltered_s"] = out.pop("scan_only_s")
        out["kept_run"] = run
    return out, calls


def q3ds_phase(torch, pc, star, kernels, RF, TorchSession, tpcds, TTB,
               RF_ENABLED):
    """TPC-DS q3 with its runtime filter, then without: each run held
    against the pyarrow reference, the plan's shape and K1's launches
    checked; emits the phase's line.  ``star``: the tables' paths and
    what the references read of them.  Returns both runs' records and
    the filtered runs' hash_columns calls."""
    dd_path, ss_paths, item_path = star["paths"]
    date_dim, sales, item = star["date_dim"], star["sales"], star["item"]
    gen_s = star["datagen_s"]
    ref = reference_star(
        pc, star, lambda d: pc.equal(d["d_moy"], 11),
        lambda i: pc.equal(i["i_manufact_id"], 128),
        ["d_year", "i_brand_id", "i_brand"], {},
        [("d_year", False), ("sum", True), ("i_brand_id", False)])
    results: dict = {}
    records = {}
    calls_on: list = []
    for rf_on in (True, False):
        session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES,
                                RF_ENABLED: rf_on}, device="cuda")

        def q3ds_df():
            return tpcds.q3_dataframe(session, dd_path, ss_paths, item_path)

        plan = q3ds_df().physical_plan()
        tasks = [n.num_partitions for n in plan.walk() if not n.children]
        if tasks != [1, Q3DS_FILES, 1]:
            raise AssertionError(f"q3ds scan tasks {tasks}, expected "
                                 f"{[1, Q3DS_FILES, 1]}")
        joins = join_strategies(plan)
        want_joins = [["TpuBroadcastHashJoinExec", "inner", "right"],
                      ["TpuBroadcastHashJoinExec", "inner", "left"]]
        if joins != want_joins:
            raise AssertionError(f"q3ds joins {joins}, expected "
                                 f"{want_joins}")
        builds = [n for n in plan.walk()
                  if type(n).__name__ == "TpuRuntimeFilterBuildExec"]
        applied = [(n.paths, c) for n in plan.walk()
                   for c, _ in getattr(n, "runtime_filters", ())]
        want_rf = ([(ss_paths, "ss_sold_date_sk")], 1) if rf_on else ([], 0)
        if (applied, len(builds)) != want_rf:
            raise AssertionError(f"q3ds runtime filters {applied} from "
                                 f"{len(builds)} builds")
        planned = map_batches(q3ds_df().physical_plan())
        folds, tables = filter_folds(q3ds_df().physical_plan())
        calls: list = calls_on if rf_on else []
        kept: list = []

        def check(t):
            kept.append(t)
            return compare_ranked(t, ref, 100, ("d_year", "i_brand_id",
                                                "i_brand"), "sum_agg", "sum")

        rec = run_query(torch, q3ds_df, kernels, check, calls)
        results[rf_on] = kept[-1]
        # the scans alone run with nothing built: no filter applies
        rec["scan_only_unfiltered_s"] = rec.pop("scan_only_s")
        want = {"hash_columns": rec["runs"] * (planned + 2 * folds
                                               + 2 * tables),
                "hash_string": 0}
        if rec["launches"] != want:
            raise AssertionError(
                f"q3ds (filter {'on' if rf_on else 'off'}) launched "
                f"{rec['launches']}, expected {want} ({planned} map batches "
                f"+ 2 x {folds} filter folds + 2 x {tables} range tables "
                f"a run)")
        run = filtered_run(q3ds_df, RF)
        if rf_on and not (run["pruned_rows"] > 0
                          and run["filters"][0]["n_keys"] > 0):
            raise AssertionError(f"q3ds filter pruned nothing: {run}")
        records[rf_on] = {"plan": plan.tree_string().splitlines(),
                          "joins": joins, "planned_map_batches": planned,
                          "planned_filter_folds": folds,
                          "planned_range_tables": tables,
                          "hash_columns_calls": sorted(
                              {(n, signature(cols), seed, parts)
                               for cols, n, seed, parts in calls}),
                          "kept_run": run, **rec}
    off_err = same_rows(results[True], results[False])
    on, off = records[True], records[False]
    emit("q3ds", rows_in=sales.num_rows, date_dim_rows=date_dim.num_rows,
         item_rows=item.num_rows, groups=len(ref),
         file_bytes=[os.path.getsize(p) for p in ss_paths],
         datagen_s=gen_s, rf_off_max_rel_diff=off_err,
         rf_off_median_s=off["median_s"],
         rf_off_wall_s=off["wall_s"], rf_off_launches=off["launches"],
         rf_off_scan_rows=[sc["numOutputRows"]
                           for sc in off["kept_run"]["scans"]],
         rf_off_device_busy_s=off["device_busy_s"],
         rf_off_device_idle_share=off["device_idle_share"],
         rf_off_profiled_wall_s=off["profiled_wall_s"], **on)
    return on, off, calls_on


def star_tables(pa, pq, data_dir, tpcds) -> dict:
    """q3ds's tables (the whole calendar, 18 000 items, six store_sales
    files), written once for q3ds, q93 and q42/q52/q55, and what the
    star references read of them."""
    star_dir = os.path.join(data_dir, "q3ds")
    os.makedirs(star_dir)
    t0 = time.perf_counter()
    paths = tpcds.write_q3_tables(star_dir, n_files=Q3DS_FILES,
                                  rows_per_file=Q3DS_ROWS_PER_FILE)
    gen_s = time.perf_counter() - t0
    dd_path, ss_paths, item_path = paths
    return {"dir": star_dir, "paths": paths, "datagen_s": gen_s,
            "date_dim": pq.read_table(dd_path),
            "item": pq.read_table(item_path),
            "sales": pa.concat_tables([pq.read_table(p, columns=[
                "ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"])
                for p in ss_paths])}


def reference_q93(pa, pc, sales, returns, reason, reason_desc: str):
    """q93 by pyarrow: store_sales LEFT OUTER JOIN store_returns, the
    reason filter, the CASE per row, the sum per customer; every group,
    by (sum, customer with NULL first).  Returns the rows and the row
    counts after the outer join and after the reason filter."""
    keys = reason.filter(pc.equal(reason["r_reason_desc"], reason_desc))[
        "r_reason_sk"]
    j = sales.join(returns, keys=["ss_item_sk", "ss_ticket_number"],
                   right_keys=["sr_item_sk", "sr_ticket_number"],
                   join_type="left outer")
    joined_rows = j.num_rows
    j = j.filter(pc.is_in(j["sr_reason_sk"], value_set=keys))
    qty, rq, price = j["ss_quantity"], j["sr_return_quantity"], \
        j["ss_sales_price"]
    act = pc.if_else(pc.is_valid(rq),
                     pc.multiply(pc.subtract(qty, rq), price),
                     pc.multiply(qty, price))
    g = pa.table({"ss_customer_sk": j["ss_customer_sk"], "act": act}) \
        .group_by(["ss_customer_sk"]).aggregate([("act", "sum")])
    rows = sorted(g.to_pylist(), key=lambda r: (
        r["act_sum"], r["ss_customer_sk"] is not None,
        r["ss_customer_sk"] or 0))
    return rows, joined_rows, j.num_rows


def q93_phase(torch, pa, pc, pq, star, kernels, TorchSession, tpcds, TTB):
    """TPC-DS q93 over q3ds's store_sales files and a store_returns
    derived from them: the plan (a partition-wise shuffled left outer
    join under the broadcast reason join, no runtime filter), the 100
    rows against the pyarrow reference, and K1's launches: one
    hash_columns per map batch of its three exchanges.  Emits the
    phase's line; returns its record and hash_columns calls."""
    _, ss_paths, _ = star["paths"]
    t0 = time.perf_counter()
    sr_path, reason_path = tpcds.write_q93_tables(star["dir"], ss_paths)
    gen_s = time.perf_counter() - t0
    session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES}, device="cuda")

    def q93_df():
        return tpcds.q93_dataframe(session, ss_paths, sr_path, reason_path)

    plan = q93_df().physical_plan()
    tasks = [n.num_partitions for n in plan.walk() if not n.children]
    if tasks != [Q3DS_FILES, 1, 1]:
        raise AssertionError(f"q93 scan tasks {tasks}, expected "
                             f"{[Q3DS_FILES, 1, 1]}")
    joins = join_strategies(plan)
    want_joins = [["TpuBroadcastHashJoinExec", "inner", "right"],
                  ["TpuShuffledHashJoinExec", "left_outer", "right"]]
    outer = [n for n in plan.walk() if hasattr(n, "partition_wise")]
    if joins != want_joins or not outer[0].partition_wise:
        raise AssertionError(f"q93 joins {joins}, expected {want_joins} "
                             f"with the outer join partition-wise")
    if any(type(n).__name__ == "TpuRuntimeFilterBuildExec"
           or getattr(n, "runtime_filters", None) for n in plan.walk()):
        raise AssertionError("q93 planned a runtime filter")
    planned = map_batches(q93_df().physical_plan())
    sales = pa.concat_tables([pq.read_table(p, columns=[
        "ss_item_sk", "ss_ticket_number", "ss_customer_sk", "ss_quantity",
        "ss_sales_price"]) for p in ss_paths])
    returns = pq.read_table(sr_path, columns=[
        "sr_item_sk", "sr_ticket_number", "sr_reason_sk",
        "sr_return_quantity"])
    ref, joined_rows, reason_rows = reference_q93(
        pa, pc, sales, returns, pq.read_table(reason_path), tpcds.Q93_REASON)
    calls: list = []
    rec = run_query(torch, q93_df, kernels, lambda t: compare_ranked(
        t, ref, 100, ("ss_customer_sk",), "sumsales", "act_sum"), calls)
    want = {"hash_columns": rec["runs"] * planned, "hash_string": 0}
    if rec["launches"] != want:
        raise AssertionError(f"q93 launched {rec['launches']}, expected "
                             f"{want} ({planned} map batches a run)")
    out = {"plan": plan.tree_string().splitlines(), "joins": joins,
           "planned_map_batches": planned,
           "hash_columns_calls": sorted({(n, signature(cols), seed, parts)
                                         for cols, n, seed, parts in calls}),
           **rec}
    emit("q93", rows_in=sales.num_rows, returns_in=returns.num_rows,
         store_returns_bytes=os.path.getsize(sr_path), datagen_s=gen_s,
         outer_join_rows=joined_rows, reason_rows=reason_rows,
         groups=len(ref), **out)
    return out, calls


#: query -> (DataFrame name, (year, manager), group keys, output names of
#: keys, sum column, the order: (column, descending) over output names)
STAR_QUERIES = {
    "q42": ("q42_dataframe", (2000, 1),
            ["d_year", "i_category_id", "i_category"], {}, "sum_agg",
            [("sum", True), ("d_year", False), ("i_category_id", False),
             ("i_category", False)]),
    "q52": ("q52_dataframe", (2000, 1), ["d_year", "i_brand", "i_brand_id"],
            {"i_brand_id": "brand_id", "i_brand": "brand"}, "ext_price",
            [("d_year", False), ("sum", True), ("brand_id", False)]),
    "q55": ("q55_dataframe", (1999, 28), ["i_brand", "i_brand_id"],
            {"i_brand_id": "brand_id", "i_brand": "brand"}, "ext_price",
            [("sum", True), ("brand_id", False)]),
}


def star_phase(torch, pc, star, kernels, TorchSession, tpcds, TTB):
    """TPC-DS q42, q52 and q55 once each over q3ds's tables: the plan
    (two broadcast joins, the runtime filter on the store_sales scan),
    the rows against the pyarrow reference, and K1's launches (the
    aggregate's map batches, the filter's two lanes per folded batch and
    per range table).  No profile.  Emits the phase's line; returns the
    records and the hash_columns calls."""
    dd_path, ss_paths, item_path = star["paths"]
    session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES}, device="cuda")
    records, calls = {}, []
    for name, (fn, (year, manager), keys, names, sum_col, order) in \
            STAR_QUERIES.items():
        def star_df(fn=fn):
            return getattr(tpcds, fn)(session, dd_path, ss_paths, item_path)

        plan = star_df().physical_plan()
        joins = join_strategies(plan)
        want_joins = [["TpuBroadcastHashJoinExec", "inner", "right"],
                      ["TpuBroadcastHashJoinExec", "inner", "left"]]
        applied = [(n.paths, c) for n in plan.walk()
                   for c, _ in getattr(n, "runtime_filters", ())]
        if joins != want_joins or applied != [(ss_paths,
                                               "ss_sold_date_sk")]:
            raise AssertionError(f"{name}: joins {joins}, runtime filters "
                                 f"{applied}")
        planned = map_batches(star_df().physical_plan())
        folds, tables = filter_folds(star_df().physical_plan())
        ref = reference_star(
            pc, star, lambda d, y=year: pc.and_(pc.equal(d["d_moy"], 11),
                                                pc.equal(d["d_year"], y)),
            lambda i, m=manager: pc.equal(i["i_manager_id"], m), keys,
            names, order)
        out_keys = tuple(names.get(k, k) for k in keys)
        rec = run_query(torch, star_df, kernels, lambda t: compare_ranked(
            t, ref, 100, out_keys, sum_col, "sum"), calls, quick=True)
        want = {"hash_columns": planned + 2 * folds + 2 * tables,
                "hash_string": 0}
        if rec["launches"] != want:
            raise AssertionError(
                f"{name} launched {rec['launches']}, expected {want} "
                f"({planned} map batches + 2 x {folds} filter folds + "
                f"2 x {tables} range tables)")
        records[name] = {"groups": len(ref), "joins": joins,
                         "planned_map_batches": planned,
                         "planned_filter_folds": folds,
                         "planned_range_tables": tables, **rec}
    emit("star", **records)
    return records, calls


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

    from spark_rapids_tpu_torch import TorchSession, tpcds, tpch
    from spark_rapids_tpu_torch.config import RF_ENABLED
    from spark_rapids_tpu_torch.config import TASK_TARGET_BYTES as TTB
    from spark_rapids_tpu_torch.ops import kernels
    from spark_rapids_tpu_torch.plan import runtime_filter as RF

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
                or "spill" in ln or "smem" in ln])

    exact = check_k1(torch, kernels, dev)
    exact_cols = check_hash_columns(torch, kernels, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    large = [time_k1(torch, kernels, dev, TIMED_ROWS, w, gen, plain_iters=3)
             for w in TIMED_WIDTHS]
    large_cols = time_hash_columns(torch, kernels, dev, TIMED_ROWS, gen)
    emit("kernels", hash_string={"exact": exact, "timed": large},
         hash_columns={"exact": exact_cols, "timed": large_cols})

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
        q6_calls: list = []
        ref6 = reference_q6(pa, pc, tables)
        q6 = run_query(torch, lambda: tpch.q6_dataframe(session, paths),
                       kernels, lambda t: compare(t, ref6, 0), q6_calls)
        emit("q6", rows_in=tables.num_rows, datagen_s=gen_s, **q6)
        q1_calls: list = []
        ref1 = reference_q1(pa, pc, tables)
        q1 = run_query(torch, lambda: tpch.q1_dataframe(session, paths),
                       kernels, lambda t: compare(t, ref1, 2), q1_calls)
        emit("q1", rows_in=tables.num_rows, hash_columns_calls=sorted(
            {(n, signature(cols), parts)
             for cols, n, _, parts in q1_calls}), **q1)
        del tables

        q3_dir = os.path.join(data_dir, "q3")
        os.makedirs(q3_dir)
        t0 = time.perf_counter()
        li_paths = tpch.make_lineitem(q3_dir, with_orderkey=True)
        orders_path = tpch.make_orders(q3_dir)
        gen3_s = time.perf_counter() - t0
        lineitem = pa.concat_tables([pq.read_table(p) for p in li_paths])
        orders = pq.read_table(orders_path)
        ref3 = reference_q3(pa, pc, lineitem, orders).to_pylist()

        q3_runs = {}
        for rf_on in (False, True):
            q3_runs[rf_on] = q3_phase(
                torch, kernels, RF, tpch, TorchSession({
                    TTB: TASK_TARGET_BYTES, RF_ENABLED: rf_on},
                    device="cuda"), li_paths, orders_path, ref3, rf_on)
        q3, q3_calls = q3_runs[False]
        q3_rf, q3_rf_calls = q3_runs[True]
        emit("q3", rows_in=lineitem.num_rows, orders_in=orders.num_rows,
             groups=len(ref3), datagen_s=gen3_s, **q3)
        emit("q3_rf_on", rf_off_median_s=q3["median_s"], **q3_rf)
        del lineitem, orders

        q67_dir = os.path.join(data_dir, "q67")
        os.makedirs(q67_dir)
        t0 = time.perf_counter()
        ss_paths = tpcds.make_store_sales(q67_dir, n_rows=Q67_ROWS,
                                          n_files=Q67_FILES)
        gen67_s = time.perf_counter() - t0
        sales = pa.concat_tables([pq.read_table(p) for p in ss_paths])
        ref67, sums67 = reference_q67(pc, sales)
        session67 = TorchSession({TTB: Q67_TASK_TARGET_BYTES}, device="cuda")

        def q67_df():
            return tpcds.q67_dataframe(session67, ss_paths)

        tasks = [n.num_partitions for n in q67_df().physical_plan().walk()
                 if not n.children]
        if tasks != [Q67_FILES]:
            raise AssertionError(f"q67 scan tasks {tasks}, expected "
                                 f"{[Q67_FILES]}")
        planned67 = map_batches(q67_df().physical_plan())
        q67_calls: list = []
        q67 = run_query(torch, q67_df, kernels,
                        lambda t: compare_q67(t, ref67, sums67), q67_calls)
        emit("q67", rows_in=sales.num_rows, groups=len(sums67),
             rows_out=q67["rows"], file_bytes=[os.path.getsize(p)
                                               for p in ss_paths],
             datagen_s=gen67_s, planned_map_batches=planned67,
             hash_columns_calls=sorted(
                 {(n, signature(cols), parts)
                  for cols, n, _, parts in q67_calls}), **q67)
        del sales

        star = star_tables(pa, pq, data_dir, tpcds)
        q3ds, q3ds_off, q3ds_calls = q3ds_phase(torch, pc, star, kernels,
                                                RF, TorchSession, tpcds, TTB,
                                                RF_ENABLED)
        q93, q93_calls = q93_phase(torch, pa, pc, pq, star, kernels,
                                   TorchSession, tpcds, TTB)
        star_runs, star_calls = star_phase(torch, pc, star, kernels,
                                           TorchSession, tpcds, TTB)
    want = {"hash_columns": q1["runs"] * len(paths), "hash_string": 0}
    if q1["launches"] != want:
        raise AssertionError(f"q1 launched {q1['launches']}, expected "
                             f"{want} (one hash_columns per map batch)")
    if q6["launches"] != {"hash_columns": 0, "hash_string": 0}:
        raise AssertionError(f"q6 launched {q6['launches']}")
    want = {"hash_columns": q67["runs"] * planned67, "hash_string": 0}
    if q67["launches"] != want:
        raise AssertionError(f"q67 launched {q67['launches']}, expected "
                             f"{want} (one hash_columns per hash map "
                             f"batch)")

    worst, at_main = at_main_path(torch, kernels, {
        "q1": q1_calls, "q3": q3_calls, "q3_rf_on": q3_rf_calls,
        "q67": q67_calls, "q3ds": q3ds_calls, "q93": q93_calls,
        "star": star_calls})
    k1_main = k1_at_main_path(torch, kernels, q1_calls)
    emit("main", hash_columns=at_main, hash_string=k1_main)
    w64 = next(r for r in large if r["w"] == 64)
    summary = [{
        "name": "hash_columns", "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/hash_string.cu",
        "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:138",
        "launches": sum(q["launches"]["hash_columns"]
                        for q in (q6, q1, q3, q3_rf, q67, q3ds, q3ds_off,
                                  q93, *star_runs.values())),
        "max_abs_err": max(r["max_abs_err"] for r in at_main + [large_cols]),
        "ms": worst["ms"], "plain_ms": worst["plain_ms"],
        "bound_ms": worst["bound_ms"], "bound_by": worst["bound_by"],
        "library_ms": None,
        "shape": "the largest of q1's, q3's (filter off and on), q67's, "
                 "q3ds's, q93's and q42/q52/q55's calls; ms is the "
                 "device's own time per launch",
        "host_ms": worst["host_ms"], "main_path_shapes": at_main,
        "large_shape": large_cols,
    }, {
        "name": "hash_string", "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/hash_string.cu",
        "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:138",
        "launches": sum(q["launches"]["hash_string"]
                        for q in (q6, q1, q3, q3_rf, q67, q3ds, q3ds_off,
                                  q93, *star_runs.values())),
        "max_abs_err": max(r["max_abs_err"] for r in large),
        "ms": w64["ms"], "plain_ms": w64["plain_ms"],
        "bound_ms": w64["bound_ms"], "bound_by": w64["bound_by"],
        "library_ms": None,
        "shape": [w64["n"], w64["w"]], "large_shapes": large,
        "q1_shape": k1_main,
    }]
    print(json.dumps({"kernels": summary}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
