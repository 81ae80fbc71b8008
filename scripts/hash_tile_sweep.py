#!/usr/bin/env python3
"""Tile-geometry sweep of the PyTorch port's murmur3 kernel (K1,
``spark_rapids_tpu_torch/csrc/hash_string.cu``) on one NVIDIA card.

    python3 scripts/hash_tile_sweep.py [--rows N]

For each string width W it times ``srt_hash_string`` over N rows (6 x
2^20 by default), by its device time in torch.profiler, at the geometry
``ops/kernels.py::tile_geometry`` picks, staged through shared memory
at each block size T (= rows per tile), and read straight from global
memory (pitch 0), and prints one JSON line per (W, T, pitch) with the
time and the share of the HBM bound.  Every variant's hashes must equal
the chosen geometry's, which chip_smoke.py holds against the plain
version.  Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

WIDTHS = (1, 2, 4, 8, 16, 24, 32, 40, 48, 56, 64, 128, 256)
THREADS = (32, 64, 128, 256)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=chip_smoke.TIMED_ROWS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hash_tile_sweep: needs an NVIDIA card", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch.ops import kernels

    print(chip_smoke.nvidia_smi(), flush=True)
    lib = kernels._hash_lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    n = args.rows
    for width in WIDTHS:
        chars, lengths = chip_smoke.string_inputs(torch, n, width, gen)
        seeds = chip_smoke.random_seeds(torch, n, gen)
        bound_ms, _ = chip_smoke.k1_bound_ms(torch, lengths, width)
        want = kernels.hash_string(chars, lengths, seeds)
        chosen = kernels.tile_geometry([(kernels.STRING_TAG, width)], n)
        pitch = kernels.pitch_words(width)
        variants = [(chosen.threads, chosen.pitches[0], "chosen")]
        variants += [(t, pitch, "staged") for t in THREADS
                     if 4 * t * pitch <= kernels.SMEM_PER_BLOCK]
        variants += [(t, 0, "direct") for t in (128, 256)]
        for threads, p, label in variants:
            out = torch.empty(n, dtype=torch.int32, device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def launch():
                err = lib.srt_hash_string(
                    chars.data_ptr(), lengths.data_ptr(), seeds.data_ptr(),
                    out.data_ptr(), n, width, threads, p, stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")

            ms = chip_smoke.device_and_host_ms(torch, launch,
                                               iters=20)["device_ms"]
            if not torch.equal(out, want):
                raise AssertionError(f"W={width} T={threads} pitch={p} "
                                     "differs")
            print(json.dumps({"w": width, "threads": threads, "pitch": p,
                              "variant": label, "ms": ms,
                              "bound_ms": bound_ms,
                              "share_of_bound": bound_ms / ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
