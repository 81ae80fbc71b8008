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
           device's own time per launch, from torch.profiler); the
           seconds each of the three parts took;
  q6, q1   TPC-H q6 and q1 over 6 x 2^20 generated lineitem rows (about
           SF1) through TorchSession(device="cuda") under the default
           keys (map tasks, coalesced partitions and scan files on pools
           of host threads, decode / upload / result fetch as stages,
           uploads on a side stream), six scan tasks
           (scan.taskTargetBytes = 8 MiB): one warm-up, then the median
           of 3 wall times; each result held against a pyarrow.compute
           reference on the same files.  Each query's breakdown drains
           its scans alone twice, serially and with their tasks on the
           pool, and prints each run's host split (decode, Arrow ->
           numpy, owned copy, pin, copy enqueue, the wait on the upload
           event, and how many batches' copies were still running).
           Kernel launch counts are reset just before each query's runs
           and read just after; q1 must launch hash_columns once per map
           batch and hash_string never;
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
  q67_rollup
           TPC-DS q67 as written (store_sales x date_dim x store x item,
           months 1200-1211, the sales ROLLUP over eight keys: nine
           grouping sets, an Expand of nine projections under the
           partial aggregate, K1 hashing the 9-column key tuple with
           NULLs where a set drops a key; a rank within each category,
           its NULL one too; the first 100 rows in key order) over q3ds's
           tables and SF1's 12 stores, the same way: three broadcast
           joins, the date filter on the store_sales scan, the rows held
           against a pyarrow reference (nine group_bys concatenated, a
           numpy rank; keys exact, sums within REL_TOL, a rank within
           the span of sums tied within REL_TOL), hash_columns as q3ds's
           rule says; the joined rows, the expanded rows (x 9) and the
           groups;
  q5       TPC-DS q5's store channel: store_sales UNION ALL q93's
           store_returns (the union's partitions its members', seven),
           two weeks of dates and the 12 stores, summed by store id, the
           same way: two broadcast joins, no runtime filter (none
           reaches through a union, as in the JAX plan), the rows against
           pyarrow;
  q27      TPC-DS q27 with SF1's 1 920 800 customer_demographics rows
           (too large to broadcast: a partition-wise shuffled join whose
           runtime filter prunes the store_sales scan) and the three
           grouping sets of (item id, state): the text's states match
           no store, so it gives 0 rows and, its store join's build side
           empty, launches nothing (one run, no profile); the variant
           asks for the state most stores are in, and its 100 rows are
           held against pyarrow;
  agg_family
           store_sales in (ticket, item) order (a range exchange and a
           sort of each partition) grouped by store with min, max, first
           and last (NULLs kept and skipped), and COUNT(DISTINCT
           ss_customer_sk) by store, each against pyarrow: the first and
           last rows of the stable sort, exact;
  concurrency
           q6, q1, q3 (filter on), q67, q3ds and q93 at the sizes above,
           and q67_rollup and q5,
           each serially (config.SERIAL: one task thread, one decode
           thread, no stages) and pooled (the default keys) in
           alternating pairs (CONCURRENCY_PAIRS, NEW_PAIRS for the
           last two) after a warm-up of each:
           every result equal to the first serial one by
           pyarrow.Table.equals (floats included), the K1 launches of
           every run equal, and no stage or pool thread alive after any
           run; both walls of every pair, the medians, the pairs the
           pooled run won, and one profiled run of each side (device
           busy, idle share, kernel count: the profiler sees the pool
           threads' kernels);
  main     hash_columns at the calls q1, q3 (filter off and on), q67,
           q3ds, q93, the star queries, q67_rollup, q5, q27 and
           agg_family made (the largest call of
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
#: version's (tens to hundreds of PyTorch kernels a call, so fewer; 10
#: until the run passed 9 minutes)
KERNEL_ITERS, PLAIN_ITERS = 50, 5
#: serial / pooled pairs of each earlier query in the concurrency phase
#: (4 until the run passed 9 minutes), and of q67_rollup and q5
CONCURRENCY_PAIRS, NEW_PAIRS = 2, 1


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
    """The device's own time per call, the host-inclusive time per call
    (host clock over ``iters`` calls ending in a synchronize, profiler
    off) and the CUDA-event time of the same loop, reported apart: where
    the host enqueues a call more slowly than the device runs it, the
    event time is the host's, not the device's.  The device time comes
    from torch.profiler over a second loop of ``iters`` calls, after a
    warm-up loop under the profiler's schedule (it records fewer kernels
    than ran when it starts cold): each kernel's mean time, times how
    many of it a call launches (its count over ``iters``, rounded), so a
    launch the profiler still missed does not lower it;
    ``device_kernels_per_call`` is the count it recorded over ``iters``.
    The profiler now and then records no device event for a loop; it is
    asked up to 3 times, then the event time stands in, and
    ``device_ms_source`` says which it is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

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
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count]
        device_us = sum(e.self_device_time_total / e.count
                        * round(e.count / iters) for e in kern)
        if device_us > 0:
            return {"device_ms": device_us / 1e3,
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
    child drained on its own (its own hashes launch here too), so an
    Expand under it counts its batches (it multiplies rows, not
    batches) and a union its members' partitions.  A range exchange
    hashes nothing."""
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


def launches_planned(make_df) -> dict:
    """What one run launches, from its plan drained piece by piece: the
    hash exchanges' map batches, and the runtime filters' folds and
    range tables (two K1 launches each)."""
    planned = map_batches(make_df().physical_plan())
    folds, tables = filter_folds(make_df().physical_plan())
    return {"planned_map_batches": planned, "planned_filter_folds": folds,
            "planned_range_tables": tables,
            "per_run": planned + 2 * folds + 2 * tables}


def check_launches(name: str, rec: dict, planned: dict) -> None:
    want = {"hash_columns": rec["runs"] * planned["per_run"],
            "hash_string": 0}
    if rec["launches"] != want:
        raise AssertionError(f"{name} launched {rec['launches']}, expected "
                             f"{want} ({planned} a run)")


def compare(got_table, want: dict, n_keys: int) -> float:
    """Keys, integer columns and NULLs exact, floats within REL_TOL;
    returns the largest relative float error."""
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
            if ref is None or isinstance(ref, int):
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


#: the scan's host split (io/scan.py, columnar/arrow.py): nanosecond
#: timers, then the count of batches whose copy was still running
SCAN_SPLIT = ("decodeTime", "convertTime", "hostCopyTime", "pinTime",
              "copyEnqueueTime", "uploadWaitTime")


def scan_alone(torch, plan, serial: bool) -> dict:
    """Every task of every scan of ``plan`` drained with nothing above
    them: one after another with the scans' stages and decode pool off
    (``serial``, as the earlier slices ran them), or through
    ``run_tasks`` on the session's task threads, as the query's map
    tasks run them.  The wall, and the scans' host split summed."""
    import dataclasses

    from spark_rapids_tpu_torch.execs.base import run_tasks

    scans = [n for n in plan.walk() if not n.children]
    if serial:
        for scan in scans:
            scan.runtime = dataclasses.replace(
                scan.runtime, task_threads=1, decode_threads=1,
                stage_depth=0)
    t0 = time.perf_counter()
    for scan in scans:
        run_tasks(lambda p, scan=scan: sum(
            b.num_rows for b in scan.execute_partition(p)),
            scan.num_partitions, scan.runtime.task_threads)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    split = {k: sum(n.metrics[k] for n in scans) / 1e9 for k in SCAN_SPLIT}
    return {"wall_s": wall, "host_split_s": split,
            "upload_pending": sum(n.metrics["uploadPending"] for n in scans),
            "batches_rows": sum(n.metrics["numOutputRows"] for n in scans)}


def profiled_run(torch, make_df) -> dict:
    """One run under torch.profiler: the device's busy time and kernel
    count, and busy over wall as the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    return {"profiled_wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "device_kernel_count": sum(e.count for e in kern),
            "device_kernels": [[e.key[:60], e.count,
                                e.self_device_time_total / 1e3]
                               for e in top],
            "kernel_counts": {e.key: e.count for e in kern}}


def breakdown(torch, make_df) -> dict:
    """Where one run's time goes: the scans alone (Parquet decode and
    upload of every task of every scan, drained with nothing above
    them), serially and pooled, each with its host split; and the
    device's busy time and kernel count over a profiled run, whose busy
    time over the run's wall time gives the device's idle share."""
    serial = scan_alone(torch, make_df().physical_plan(), serial=True)
    pooled = scan_alone(torch, make_df().physical_plan(), serial=False)
    prof = profiled_run(torch, make_df)
    del prof["kernel_counts"]
    return {"scan_only_s": serial["wall_s"],
            "scan_only_pooled_s": pooled["wall_s"],
            "scan_split_serial": serial, "scan_split_pooled": pooled,
            **prof}


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
    planned = launches_planned(q3_df)
    calls: list = []
    rec = run_query(torch, q3_df, kernels,
                    lambda t: compare_ranked(
                        t, ref3, 10, ("l_orderkey", "o_orderdate",
                                      "o_shippriority"), "revenue",
                        "rev_sum"), calls)
    check_launches(f"q3 (filter {'on' if rf_on else 'off'})", rec, planned)
    out = {"joins": joins, **planned,
           "hash_columns_calls": sorted({(n, signature(cols), seed, parts)
                                         for cols, n, seed, parts in calls}),
           **rec}
    if rf_on:
        run = filtered_run(q3_df, RF)
        if not (run["pruned_rows"] > 0 and run["filters"][0]["n_keys"] > 0):
            raise AssertionError(f"q3 filter pruned nothing: {run}")
        # the scans alone run with nothing built: no filter applies
        out["scan_only_unfiltered_s"] = out.pop("scan_only_s")
        out["scan_only_pooled_unfiltered_s"] = out.pop("scan_only_pooled_s")
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
        planned = launches_planned(q3ds_df)
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
        rec["scan_only_pooled_unfiltered_s"] = rec.pop("scan_only_pooled_s")
        check_launches(f"q3ds (filter {'on' if rf_on else 'off'})", rec,
                       planned)
        run = filtered_run(q3ds_df, RF)
        if rf_on and not (run["pruned_rows"] > 0
                          and run["filters"][0]["n_keys"] > 0):
            raise AssertionError(f"q3ds filter pruned nothing: {run}")
        records[rf_on] = {"plan": plan.tree_string().splitlines(),
                          "joins": joins, **planned,
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
    star["q93_paths"] = (sr_path, reason_path)
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
    planned = launches_planned(q93_df)
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
    check_launches("q93", rec, planned)
    out = {"plan": plan.tree_string().splitlines(), "joins": joins,
           **planned,
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
        planned = launches_planned(star_df)
        ref = reference_star(
            pc, star, lambda d, y=year: pc.and_(pc.equal(d["d_moy"], 11),
                                                pc.equal(d["d_year"], y)),
            lambda i, m=manager: pc.equal(i["i_manager_id"], m), keys,
            names, order)
        out_keys = tuple(names.get(k, k) for k in keys)
        rec = run_query(torch, star_df, kernels, lambda t: compare_ranked(
            t, ref, 100, out_keys, sum_col, "sum"), calls, quick=True)
        check_launches(name, rec, planned)
        records[name] = {"groups": len(ref), "joins": joins, **planned,
                         **rec}
    emit("star", **records)
    return records, calls


def dimension_tables(pq, star, tpcds) -> None:
    """SF1's 12 stores and 1 920 800 customer_demographics rows, written
    beside q3ds's tables; their paths (and the stores) go into ``star``."""
    t0 = time.perf_counter()
    star["store_path"] = tpcds.write_store(star["dir"])
    star["cdemo_path"] = tpcds.write_customer_demographics(star["dir"])
    star["dimensions_datagen_s"] = time.perf_counter() - t0
    star["store"] = pq.read_table(star["store_path"])


def read_sales(pa, pq, star, columns: list):
    return pa.concat_tables([pq.read_table(p, columns=columns)
                             for p in star["paths"][1]])


def reference_q67_rollup(pa, pc, pq, star, tpcds) -> dict:
    """q67 as written by pyarrow and numpy: the year's joined rows, the
    sales of each of the nine ROLLUP levels (the dropped keys NULL),
    ranked within each category (its NULL one too) by sum, descending,
    ties sharing the lowest rank; the rows ranked 1-100 in the text's
    order (keys with NULLs first, sum, rank), the first 100.  Returns
    those rows, each category's sums sorted descending (for ties), the
    joined rows and the groups."""
    import numpy as np

    keys = list(tpcds.Q67_KEYS)
    dd = star["date_dim"]
    dd = dd.filter(pc.and_(pc.greater_equal(dd["d_month_seq"], 1200),
                           pc.less_equal(dd["d_month_seq"], 1211))).select(
        ["d_date_sk", "d_year", "d_qoy", "d_moy"])
    item = star["item"].select(["i_item_sk", "i_category", "i_class",
                                "i_brand", "i_product_name"])
    store = star["store"].select(["s_store_sk", "s_store_id"])
    j = read_sales(pa, pq, star, ["ss_sold_date_sk", "ss_item_sk",
                                  "ss_store_sk", "ss_quantity",
                                  "ss_sales_price"])
    j = j.join(dd, keys="ss_sold_date_sk", right_keys="d_date_sk",
               join_type="inner")
    j = j.join(store, keys="ss_store_sk", right_keys="s_store_sk",
               join_type="inner")
    j = j.join(item, keys="ss_item_sk", right_keys="i_item_sk",
               join_type="inner")
    j = j.append_column("sales", pc.coalesce(pc.multiply(
        j["ss_sales_price"], pc.cast(j["ss_quantity"], pa.float64())), 0.0))
    levels = []
    for n in range(len(keys), -1, -1):
        if n:
            g = j.group_by(keys[:n]).aggregate([("sales", "sum")])
        else:
            g = pa.table({"sales_sum": [pc.sum(j["sales"]).as_py()]})
        cols = [g[k] if k in keys[:n] else pa.nulls(g.num_rows,
                                                     j.schema.field(k).type)
                for k in keys]
        levels.append(pa.table(cols + [g["sales_sum"]],
                               names=keys + ["sumsales"]))
    groups = pa.concat_tables(levels)
    cat = groups["i_category"].combine_chunks().dictionary_encode()
    codes = cat.indices.fill_null(-1).to_numpy(zero_copy_only=False)
    sums = groups["sumsales"].to_numpy()
    order = np.lexsort((-sums, codes))
    cs, ss = codes[order], sums[order]
    idx = np.arange(len(order))
    new_cat = np.r_[True, cs[1:] != cs[:-1]]
    new_run = new_cat | np.r_[True, ss[1:] != ss[:-1]]
    seg = np.maximum.accumulate(np.where(new_cat, idx, 0))
    run = np.maximum.accumulate(np.where(new_run, idx, 0))
    rank = np.empty(len(order), np.int64)
    rank[order] = run - seg + 1
    kept = groups.take(pa.array(np.nonzero(rank <= 100)[0])).append_column(
        "rk", pa.array(rank[rank <= 100]))
    rows = sorted(kept.to_pylist(), key=lambda r: [
        *[(r[k] is not None, r[k]) for k in keys], r["sumsales"], r["rk"]])
    by_cat = {}
    for c in {r["i_category"] for r in rows[:100]}:
        m = codes == (-1 if c is None else cat.dictionary.index(c).as_py())
        by_cat[c] = np.sort(sums[m])[::-1]
    return {"rows": rows[:100], "sums_by_category": by_cat,
            "joined_rows": j.num_rows, "groups": groups.num_rows}


def compare_q67_rollup(got_table, ref: dict) -> float:
    """q67's 100 rows against the reference's, place by place: keys
    exact, sums within REL_TOL, and the rank exact unless other sums of
    the category lie within REL_TOL of the row's (then within their
    span).  Returns the largest relative sum error."""
    import numpy as np

    got, want = got_table.to_pylist(), ref["rows"]
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} rows, reference has {len(want)}")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        keys = [k for k in g if k not in ("sumsales", "rk")]
        if [g[k] for k in keys] != [w[k] for k in keys]:
            raise AssertionError(f"place {i}: {g} vs reference {w}")
        rel = abs(g["sumsales"] - w["sumsales"]) / max(abs(w["sumsales"]),
                                                       1e-300)
        worst = max(worst, rel)
        if rel > REL_TOL:
            raise AssertionError(f"place {i}: sum {g['sumsales']} vs "
                                 f"{w['sumsales']} (rel {rel:.3e})")
        desc = ref["sums_by_category"][g["i_category"]]
        tol = REL_TOL * abs(w["sumsales"])
        lo = 1 + int(np.sum(desc > w["sumsales"] + tol))
        hi = 1 + int(np.sum(desc > w["sumsales"] - tol))
        if not lo <= g["rk"] <= hi:
            raise AssertionError(f"place {i}: rank {g['rk']}, reference "
                                 f"{w['rk']} (ties allow {lo}-{hi})")
    return worst


def expect_plan(name: str, plan, star, joins: list, filters: list) -> None:
    """The plan's joins (exec, type, build side, in plan order) and the
    runtime filters' keys on the store_sales scan."""
    got = join_strategies(plan)
    if got != joins:
        raise AssertionError(f"{name} joins {got}, expected {joins}")
    applied = [(n.paths, c) for n in plan.walk()
               for c, _ in getattr(n, "runtime_filters", ())]
    if applied != [(star["paths"][1], k) for k in filters]:
        raise AssertionError(f"{name} runtime filters {applied}, expected "
                             f"{filters} on the store_sales scan")


BCAST_RIGHT = ["TpuBroadcastHashJoinExec", "inner", "right"]


def q67_rollup_phase(torch, pa, pc, pq, star, kernels, TorchSession, tpcds,
                     TTB) -> tuple:
    """TPC-DS q67 as written over q3ds's tables and the 12 stores: the
    plan (three broadcast joins, the date filter on the store_sales
    scan, the Expand of nine projections under the partial aggregate),
    the 100 rows against the pyarrow reference, K1's launches, and the
    expanded rows and groups.  Emits the phase's line; returns its
    record and hash_columns calls."""
    dd_path, ss_paths, item_path = star["paths"]
    session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES}, device="cuda")

    def q67r_df():
        return tpcds.q67_rollup_dataframe(session, dd_path, ss_paths,
                                          item_path, star["store_path"])

    plan = q67r_df().physical_plan()
    expect_plan("q67_rollup", plan, star, [BCAST_RIGHT] * 3,
                ["ss_sold_date_sk"])
    [expand] = [n for n in plan.walk() if type(n).__name__ ==
                "TpuExpandExec"]
    partial = [n for n in plan.walk() if getattr(n, "mode", "") ==
               "partial"]
    if len(expand.projections) != 9 or partial[0].children[0] is not expand:
        raise AssertionError("q67_rollup: no Expand of 9 projections under "
                             "the partial aggregate")
    planned = launches_planned(q67r_df)
    t0 = time.perf_counter()
    ref = reference_q67_rollup(pa, pc, pq, star, tpcds)
    ref_s = time.perf_counter() - t0
    calls: list = []
    rec = run_query(torch, q67r_df, kernels,
                    lambda t: compare_q67_rollup(t, ref), calls)
    check_launches("q67_rollup", rec, planned)
    out = {"plan": plan.tree_string().splitlines(), **planned,
           "joined_rows": ref["joined_rows"],
           "expanded_rows": 9 * ref["joined_rows"], "groups": ref["groups"],
           "reference_s": ref_s,
           "hash_columns_calls": sorted({(n, signature(cols), seed, parts)
                                         for cols, n, seed, parts in calls}),
           **rec}
    emit("q67_rollup", stores=star["store"].num_rows, **out)
    return out, calls


def reference_q5(pa, pc, pq, star, tpcds) -> dict:
    """q5's store channel by pyarrow: each store id's sales, returns and
    profit net of losses over the two weeks."""
    dd = star["date_dim"]
    d = pc.cast(dd["d_date"], pa.int32())
    keys = dd.filter(pc.and_(pc.greater_equal(d, tpcds.Q5_DATES[0]),
                             pc.less_equal(d, tpcds.Q5_DATES[1])))[
        "d_date_sk"]
    names = ["store_sk", "date_sk", "sales_price", "profit", "return_amt",
             "net_loss"]
    ss = read_sales(pa, pq, star, ["ss_store_sk", "ss_sold_date_sk",
                                   "ss_ext_sales_price", "ss_net_profit"])
    zero = pa.array([0.0] * ss.num_rows)
    ss = pa.table(list(ss.columns) + [zero, zero], names=names)
    sr = pq.read_table(star["q93_paths"][0], columns=[
        "sr_store_sk", "sr_returned_date_sk", "sr_return_amt",
        "sr_net_loss"])
    zero = pa.array([0.0] * sr.num_rows)
    sr = pa.table([sr.column(0), sr.column(1), zero, zero, sr.column(2),
                   sr.column(3)], names=names)
    u = pa.concat_tables([ss, sr])
    u = u.filter(pc.is_in(u["date_sk"], value_set=keys))
    u = u.join(star["store"].select(["s_store_sk", "s_store_id"]),
               keys="store_sk", right_keys="s_store_sk", join_type="inner")
    g = u.group_by(["s_store_id"]).aggregate([
        ("sales_price", "sum"), ("profit", "sum"), ("return_amt", "sum"),
        ("net_loss", "sum")])
    return {(r["s_store_id"],): {
        "sales": r["sales_price_sum"], "returns_amt": r["return_amt_sum"],
        "profit": r["profit_sum"] - r["net_loss_sum"]}
        for r in g.to_pylist()}, u.num_rows


def q5_phase(torch, pa, pc, pq, star, kernels, TorchSession, tpcds,
             TTB) -> tuple:
    """TPC-DS q5's store channel over q3ds's store_sales, q93's
    store_returns and the 12 stores: the plan (the union of both,
    numbered member after member, under the date and store broadcasts;
    no runtime filter reaches through the union, as in the JAX plan),
    the rows against the pyarrow reference, K1's launches.  Emits the
    phase's line; returns its record and hash_columns calls."""
    dd_path, ss_paths, _ = star["paths"]
    sr_path = star["q93_paths"][0]
    session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES}, device="cuda")

    def q5_df():
        return tpcds.q5_dataframe(session, dd_path, ss_paths, sr_path,
                                  star["store_path"])

    plan = q5_df().physical_plan()
    expect_plan("q5", plan, star, [BCAST_RIGHT] * 2, [])
    [union] = [n for n in plan.walk() if type(n).__name__ == "TpuUnionExec"]
    if union.num_partitions != Q3DS_FILES + 1:
        raise AssertionError(f"q5 union of {union.num_partitions} "
                             f"partitions, expected {Q3DS_FILES + 1}")
    planned = launches_planned(q5_df)
    ref, union_rows = reference_q5(pa, pc, pq, star, tpcds)

    def check(t):
        ids = t["s_store_id"].to_pylist()
        if ids != sorted(ids):
            raise AssertionError("q5 rows are not in store id order")
        return compare(t, ref, 1)

    calls: list = []
    rec = run_query(torch, q5_df, kernels, check, calls)
    check_launches("q5", rec, planned)
    out = {"plan": plan.tree_string().splitlines(), **planned,
           "union_rows_in_dates": union_rows,
           "hash_columns_calls": sorted({(n, signature(cols), seed, parts)
                                         for cols, n, seed, parts in calls}),
           **rec}
    emit("q5", returns_in=pq.read_metadata(sr_path).num_rows, **out)
    return out, calls


def reference_q27(pa, pc, pq, star, tpcds, states) -> list:
    """q27 by pyarrow: the year's sales to the text's demographic in the
    stores of ``states``, averaged over its three grouping sets; the
    rows by item id and state (NULLs last), the first 100."""
    gender, marital, education = tpcds.Q27_DEMOGRAPHICS
    cd = pq.read_table(star["cdemo_path"])
    cd = cd.filter(pc.and_(pc.and_(
        pc.equal(cd["cd_gender"], gender),
        pc.equal(cd["cd_marital_status"], marital)),
        pc.equal(cd["cd_education_status"], education)))
    dd = star["date_dim"]
    dd = dd.filter(pc.equal(dd["d_year"], 2002))
    st = star["store"]
    st = st.filter(pc.is_in(st["s_state"], value_set=pa.array(states)))
    j = read_sales(pa, pq, star, [
        "ss_sold_date_sk", "ss_item_sk", "ss_store_sk", "ss_cdemo_sk",
        "ss_quantity", "ss_list_price", "ss_coupon_amt", "ss_sales_price"])
    j = j.filter(pc.is_in(j["ss_cdemo_sk"], value_set=cd["cd_demo_sk"]))
    j = j.filter(pc.is_in(j["ss_sold_date_sk"], value_set=dd["d_date_sk"]))
    j = j.join(st.select(["s_store_sk", "s_state"]), keys="ss_store_sk",
               right_keys="s_store_sk", join_type="inner")
    j = j.join(star["item"].select(["i_item_sk", "i_item_id"]),
               keys="ss_item_sk", right_keys="i_item_sk", join_type="inner")
    vals = [("ss_quantity", "agg1"), ("ss_list_price", "agg2"),
            ("ss_coupon_amt", "agg3"), ("ss_sales_price", "agg4")]
    rows = []
    for keys in (["i_item_id", "s_state"], ["i_item_id"], []):
        if keys:
            g = j.group_by(keys).aggregate([(c, "mean") for c, _ in vals])
            got = g.to_pylist()
        else:  # a grouping set's groups: none over no rows
            got = [{f"{c}_mean": pc.mean(j[c]).as_py() for c, _ in vals}
                   ] if j.num_rows else []
        for r in got:
            rows.append({"i_item_id": r.get("i_item_id"),
                         "s_state": r.get("s_state"),
                         **{a: r[f"{c}_mean"] for c, a in vals}})
    rows.sort(key=lambda r: [(r[k] is None, r[k] or "")
                             for k in ("i_item_id", "s_state")])
    return rows[:100]


def compare_rows(got_table, want: list, n_keys: int) -> float:
    """Rows place by place: the first ``n_keys`` columns exact, the rest
    within REL_TOL (NULL where the reference has None).  Returns the
    largest relative error."""
    got = got_table.to_pylist()
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} rows, reference has {len(want)}")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        names = list(g)
        if [g[k] for k in names[:n_keys]] != [w[k] for k in names[:n_keys]]:
            raise AssertionError(f"place {i}: {g} vs reference {w}")
        for k in names[n_keys:]:
            if g[k] is None or w[k] is None:
                if g[k] is not w[k]:
                    raise AssertionError(f"place {i} {k}: {g[k]} vs "
                                         f"{w[k]}")
                continue
            rel = abs(g[k] - w[k]) / max(abs(w[k]), 1e-300)
            worst = max(worst, rel)
            if rel > REL_TOL:
                raise AssertionError(f"place {i} {k}: {g[k]} vs {w[k]} "
                                     f"(rel {rel:.3e})")
    return worst


def q27_phase(torch, pa, pc, pq, star, kernels, TorchSession, tpcds,
              TTB) -> tuple:
    """TPC-DS q27 over q3ds's tables, the 12 stores and SF1's
    customer_demographics: the text's values (Tennessee, which no store
    of the catalog is in) give 0 rows and launch nothing (the empty
    store side ends the joins above the exchanges); the variant with the
    state most of the stores are in gives the rows of the pyarrow
    reference of its three grouping sets.  Each with the plan
    (customer_demographics too large to broadcast: a shuffled join, its
    filter on the store_sales scan) and K1's launches.  Emits the
    phase's line; returns its records and the variant's hash_columns
    calls."""
    dd_path, ss_paths, item_path = star["paths"]
    states = star["store"]["s_state"].to_pylist()
    state = max(sorted(set(states)), key=states.count)
    session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES}, device="cuda")
    records, calls = {}, []
    for name, st in (("text", tpcds.Q27_STATES), ("variant", (state,))):
        def q27_df(st=st):
            return tpcds.q27_dataframe(session, dd_path, ss_paths, item_path,
                                       star["store_path"],
                                       star["cdemo_path"], states=st)

        plan = q27_df().physical_plan()
        expect_plan(f"q27 {name}", plan, star, [BCAST_RIGHT] * 3 + [
            ["TpuShuffledHashJoinExec", "inner", "right"]], ["ss_cdemo_sk"])
        ref = reference_q27(pa, pc, pq, star, tpcds, st)
        if name == "variant":
            planned = launches_planned(q27_df)
        elif ref or set(states) & set(st):
            raise AssertionError(f"q27's text matched {len(ref)} rows")
        else:
            # no store is in the text's states: the store join's build
            # side is empty, so it never pulls the joins under it, and no
            # exchange or filter runs
            planned = {"per_run": 0, "store_rows": 0}
        if name == "variant" and len(ref) < 100:
            raise AssertionError(f"q27's variant matched {len(ref)} rows")
        rec = run_query(torch, q27_df, kernels,
                        lambda t, ref=ref: compare_rows(t, ref, 2),
                        calls if name == "variant" else [],
                        quick=name == "text")
        check_launches(f"q27 {name}", rec, planned)
        records[name] = {"states": list(st),
                         "plan": plan.tree_string().splitlines(),
                         **planned, **rec}
    emit("q27", cdemo_rows=pq.read_metadata(star["cdemo_path"]).num_rows,
         store_states=states,
         dimensions_datagen_s=star["dimensions_datagen_s"],
         hash_columns_calls=sorted({(n, signature(cols), seed, parts)
                                    for cols, n, seed, parts in calls}),
         **records)
    return records, calls


def agg_family_dataframes(session, ss_paths) -> dict:
    """store_sales in (ticket, item) order, grouped by store with min,
    max, first and last (both NULL modes); and the distinct customers of
    each store."""
    from spark_rapids_tpu_torch.session import (
        col,
        count_distinct,
        first,
        last,
        max_,
        min_,
    )

    ss = session.read_parquet(*ss_paths)
    ordered = ss.order_by(col("ss_ticket_number"), col("ss_item_sk"))
    return {
        "values": ordered.group_by(col("ss_store_sk")).agg(
            (min_(col("ss_sales_price")), "min_price"),
            (max_(col("ss_sales_price")), "max_price"),
            (min_(col("ss_sold_date_sk")), "min_date"),
            (max_(col("ss_net_profit")), "max_profit"),
            (first(col("ss_customer_sk")), "first_customer"),
            (last(col("ss_customer_sk"), True), "last_customer"),
            (first(col("ss_sold_date_sk"), True), "first_date"),
            (last(col("ss_sold_date_sk")), "last_date")),
        "distinct": ss.group_by(col("ss_store_sk")).agg(
            (count_distinct(col("ss_customer_sk")), "customers")),
    }


def reference_agg_family(pa, pc, pq, star) -> dict:
    """The agg_family queries by pyarrow and numpy: the rows in (ticket,
    item) order (a stable sort of the files' rows in file order), each
    store's extremes, and its first and last rows' values by position
    (all rows, or the non-NULL ones)."""
    import numpy as np

    t = read_sales(pa, pq, star, [
        "ss_store_sk", "ss_ticket_number", "ss_item_sk", "ss_sales_price",
        "ss_sold_date_sk", "ss_net_profit", "ss_customer_sk"])
    distinct = {(r["ss_store_sk"],): {"customers": r[
        "ss_customer_sk_count_distinct"]} for r in t.group_by(
        ["ss_store_sk"]).aggregate([("ss_customer_sk",
                                     "count_distinct")]).to_pylist()}
    t = t.take(pc.sort_indices(t, sort_keys=[
        ("ss_ticket_number", "ascending"), ("ss_item_sk", "ascending")]))
    store = t["ss_store_sk"].to_numpy()

    def pick(column: str, last: bool, skip_nulls: bool) -> dict:
        arr = t[column]
        valid = arr.is_valid().to_numpy(zero_copy_only=False)
        vals = arr.to_pylist()
        rows = np.nonzero(valid)[0] if skip_nulls else np.arange(len(vals))
        if last:
            rows = rows[::-1]
        _, at = np.unique(store[rows], return_index=True)
        return {int(store[rows[i]]): vals[rows[i]] for i in at}

    g = t.group_by(["ss_store_sk"]).aggregate([
        ("ss_sales_price", "min"), ("ss_sales_price", "max"),
        ("ss_sold_date_sk", "min"), ("ss_net_profit", "max")])
    picks = {"first_customer": pick("ss_customer_sk", False, False),
             "last_customer": pick("ss_customer_sk", True, True),
             "first_date": pick("ss_sold_date_sk", False, True),
             "last_date": pick("ss_sold_date_sk", True, False)}
    values = {}
    for r in g.to_pylist():
        s = r["ss_store_sk"]
        values[(s,)] = {"min_price": r["ss_sales_price_min"],
                        "max_price": r["ss_sales_price_max"],
                        "min_date": r["ss_sold_date_sk_min"],
                        "max_profit": r["ss_net_profit_max"],
                        **{k: v[s] for k, v in picks.items()}}
    return {"values": values, "distinct": distinct}


def agg_family_phase(torch, pa, pc, pq, star, kernels, TorchSession,
                     TTB) -> tuple:
    """min / max / first / last over store_sales after an ORDER BY (a
    range exchange and a sort of each partition under the group-by, so
    first and last follow the sort), and COUNT(DISTINCT) of the
    customers, each store's rows against pyarrow (the first / last
    exact, as the extremes), and K1's launches.  Emits the phase's
    line; returns its records and hash_columns calls."""
    session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES}, device="cuda")
    ref = reference_agg_family(pa, pc, pq, star)
    records, calls = {}, []
    for name in ("values", "distinct"):
        def family_df(name=name):
            return agg_family_dataframes(session, star["paths"][1])[name]

        planned = launches_planned(family_df)
        rec = run_query(torch, family_df, kernels,
                        lambda t, name=name: compare(t, ref[name], 1),
                        calls)
        check_launches(f"agg_family {name}", rec, planned)
        records[name] = {"plan": family_df().physical_plan().tree_string()
                         .splitlines(), "groups": len(ref[name]),
                         **planned, **rec}
    emit("agg_family", hash_columns_calls=sorted(
        {(n, signature(cols), seed, parts)
         for cols, n, seed, parts in calls}), **records)
    return records, calls


def concurrency_phase(torch, kernels, TorchSession, SERIAL,
                      queries: dict) -> dict:
    """Each query serially (``config.SERIAL``: one task thread, one
    decode thread, no stages) and pooled (the default keys) in
    alternating pairs after one warm-up of each: every result equal to
    the first serial one by ``pyarrow.Table.equals`` (floats included),
    every run's K1 launches equal, and no stage or pool thread alive
    after any run.  Then one profiled run of each side.  ``queries``:
    name -> (conf, a function of a session giving the DataFrame, the
    pairs to run).  Emits the phase's line."""
    from spark_rapids_tpu_torch.execs.base import live_pool_threads
    from spark_rapids_tpu_torch.parallel.pipeline import live_stage_threads

    out = {}
    for name, (conf, make, n_pairs) in queries.items():
        sessions = {"serial": TorchSession({**conf, **SERIAL},
                                           device="cuda"),
                    "pooled": TorchSession(conf, device="cuda")}

        def run(side):
            before = (kernels.hash_columns.launches,
                      kernels.hash_string.launches)
            t0 = time.perf_counter()
            table = make(sessions[side]).collect()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if live_stage_threads() or live_pool_threads():
                raise AssertionError(
                    f"{name} ({side}): {live_stage_threads()} stage and "
                    f"{live_pool_threads()} pool threads outlived collect()")
            return wall, table, (kernels.hash_columns.launches - before[0],
                                 kernels.hash_string.launches - before[1])

        _, want, want_launches = run("serial")
        run("pooled")
        walls: dict = {"serial": [], "pooled": []}
        won = 0
        for i in range(n_pairs):
            order = ("serial", "pooled") if i % 2 == 0 \
                else ("pooled", "serial")
            for side in order:
                wall, table, launches = run(side)
                walls[side].append(wall)
                if not table.equals(want):
                    raise AssertionError(
                        f"{name}: a {side} result differs from the first "
                        f"serial one")
                if launches != want_launches:
                    raise AssertionError(
                        f"{name}: {side} launched {launches}, serial "
                        f"{want_launches}")
            won += walls["pooled"][-1] < walls["serial"][-1]
        prof = {side: profiled_run(torch, lambda side=side: make(
            sessions[side])) for side in ("serial", "pooled")}
        counts = {side: prof[side].pop("kernel_counts") for side in prof}
        diff = {k: counts["pooled"].get(k, 0) - counts["serial"].get(k, 0)
                for k in set(counts["serial"]) | set(counts["pooled"])}
        diff = sorted(((k[:60], v) for k, v in diff.items() if v),
                      key=lambda kv: -abs(kv[1]))[:10]
        out[name] = {
            "rows": want.num_rows, "pairs": n_pairs,
            "launches_per_run": {"hash_columns": want_launches[0],
                                 "hash_string": want_launches[1]},
            "serial_wall_s": walls["serial"],
            "pooled_wall_s": walls["pooled"],
            "serial_median_s": statistics.median(walls["serial"]),
            "pooled_median_s": statistics.median(walls["pooled"]),
            "pooled_won": won,
            "serial_profiled": prof["serial"],
            "pooled_profiled": prof["pooled"],
            "kernel_count_pooled_minus_serial": diff}
    emit("concurrency", **out)
    return out


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
    from spark_rapids_tpu_torch.config import RF_ENABLED, SERIAL
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

    parts_s = {}
    t0 = time.perf_counter()
    exact = check_k1(torch, kernels, dev)
    parts_s["exact_hash_string"] = time.perf_counter() - t0
    exact_cols = check_hash_columns(torch, kernels, dev)
    parts_s["exact_hash_columns"] = time.perf_counter() - t0 - sum(
        parts_s.values())
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    large = [time_k1(torch, kernels, dev, TIMED_ROWS, w, gen, plain_iters=3)
             for w in TIMED_WIDTHS]
    large_cols = time_hash_columns(torch, kernels, dev, TIMED_ROWS, gen)
    parts_s["timed"] = time.perf_counter() - t0 - sum(parts_s.values())
    emit("kernels", hash_string={"exact": exact, "timed": large},
         hash_columns={"exact": exact_cols, "timed": large_cols},
         seconds=parts_s)

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
        planned67 = launches_planned(q67_df)
        q67_calls: list = []
        q67 = run_query(torch, q67_df, kernels,
                        lambda t: compare_q67(t, ref67, sums67), q67_calls)
        emit("q67", rows_in=sales.num_rows, groups=len(sums67),
             rows_out=q67["rows"], file_bytes=[os.path.getsize(p)
                                               for p in ss_paths],
             datagen_s=gen67_s, **planned67,
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
        dimension_tables(pq, star, tpcds)
        q67r, q67r_calls = q67_rollup_phase(torch, pa, pc, pq, star, kernels,
                                            TorchSession, tpcds, TTB)
        q5, q5_calls = q5_phase(torch, pa, pc, pq, star, kernels,
                                TorchSession, tpcds, TTB)
        q27_runs, q27_calls = q27_phase(torch, pa, pc, pq, star, kernels,
                                        TorchSession, tpcds, TTB)
        family, family_calls = agg_family_phase(torch, pa, pc, pq, star,
                                                kernels, TorchSession, TTB)
        dd_path, star_ss, item_path = star["paths"]
        sr_path, reason_path = star["q93_paths"]
        store_path = star["store_path"]
        li8 = {TTB: TASK_TARGET_BYTES}
        ds8 = {TTB: Q3DS_TASK_TARGET_BYTES}
        pairs = CONCURRENCY_PAIRS
        kernels.hash_columns.launches = 0
        kernels.hash_string.launches = 0
        concurrency_phase(torch, kernels, TorchSession, SERIAL, {
            "q6": (li8, lambda s: tpch.q6_dataframe(s, paths), pairs),
            "q1": (li8, lambda s: tpch.q1_dataframe(s, paths), pairs),
            "q3_rf_on": (li8, lambda s: tpch.q3_dataframe(s, li_paths,
                                                          orders_path),
                         pairs),
            "q67": ({TTB: Q67_TASK_TARGET_BYTES},
                    lambda s: tpcds.q67_dataframe(s, ss_paths), pairs),
            "q3ds": (ds8, lambda s: tpcds.q3_dataframe(s, dd_path, star_ss,
                                                       item_path), pairs),
            "q93": (ds8, lambda s: tpcds.q93_dataframe(s, star_ss, sr_path,
                                                       reason_path), pairs),
            "q67_rollup": (ds8, lambda s: tpcds.q67_rollup_dataframe(
                s, dd_path, star_ss, item_path, store_path), NEW_PAIRS),
            "q5": (ds8, lambda s: tpcds.q5_dataframe(
                s, dd_path, star_ss, sr_path, store_path), NEW_PAIRS)})
        conc_launches = {"hash_columns": kernels.hash_columns.launches,
                         "hash_string": kernels.hash_string.launches}
    want = {"hash_columns": q1["runs"] * len(paths), "hash_string": 0}
    if q1["launches"] != want:
        raise AssertionError(f"q1 launched {q1['launches']}, expected "
                             f"{want} (one hash_columns per map batch)")
    if q6["launches"] != {"hash_columns": 0, "hash_string": 0}:
        raise AssertionError(f"q6 launched {q6['launches']}")
    check_launches("q67", q67, planned67)

    worst, at_main = at_main_path(torch, kernels, {
        "q1": q1_calls, "q3": q3_calls, "q3_rf_on": q3_rf_calls,
        "q67": q67_calls, "q3ds": q3ds_calls, "q93": q93_calls,
        "star": star_calls, "q67_rollup": q67r_calls, "q5": q5_calls,
        "q27": q27_calls, "agg_family": family_calls})
    k1_main = k1_at_main_path(torch, kernels, q1_calls)
    emit("main", hash_columns=at_main, hash_string=k1_main)
    w64 = next(r for r in large if r["w"] == 64)
    runs = (q6, q1, q3, q3_rf, q67, q3ds, q3ds_off, q93, *star_runs.values(),
            q67r, q5, *q27_runs.values(), *family.values())
    summary = [{
        "name": "hash_columns", "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/hash_string.cu",
        "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:138",
        "launches": conc_launches["hash_columns"] + sum(
            q["launches"]["hash_columns"] for q in runs),
        "max_abs_err": max(r["max_abs_err"] for r in at_main + [large_cols]),
        "ms": worst["ms"], "plain_ms": worst["plain_ms"],
        "bound_ms": worst["bound_ms"], "bound_by": worst["bound_by"],
        "library_ms": None,
        "shape": "the largest of q1's, q3's (filter off and on), q67's, "
                 "q3ds's, q93's, q42/q52/q55's, q67_rollup's, q5's, q27's "
                 "and agg_family's calls; ms is the device's own time per "
                 "launch",
        "concurrency_launches": conc_launches["hash_columns"],
        "host_ms": worst["host_ms"], "main_path_shapes": at_main,
        "large_shape": large_cols,
    }, {
        "name": "hash_string", "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/hash_string.cu",
        "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:138",
        "launches": conc_launches["hash_string"] + sum(
            q["launches"]["hash_string"] for q in runs),
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
