#!/usr/bin/env python3
"""Device time of the port's murmur3 string kernel against other builds
of it, on one NVIDIA card.

    python3 scripts/hash_kernel_compare.py [--source FILE.cu ...]
                                            [--rows N] [--widths 1,16,64]

Times ``srt_hash_string`` of ``spark_rapids_tpu_torch/csrc/hash_string.cu``
(through ``kernels.hash_string``) and of every ``--source`` file (another
version of the same kernel, built with the same nvcc flags, with the
one-column signature ``(chars, lengths, seeds, out, n, width, stream)``
or the current one), at N rows (6 x 2^20 by default) and each width, on
the same inputs.  Each build runs in a process of its own (two
libraries that link the CUDA runtime statically do not share one), in
turns: current, each source, each source in reverse, current.  A
kernel's time is its device time in torch.profiler over 20 launches,
over 20.  Every build's hashes must equal the current kernel's.  One
JSON line per (build, width); needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def build(kernels, source: str):
    """Build an nvcc library from ``source`` into the package's _build
    directory, keyed by content; returns launch(torch, chars, lengths,
    seeds, out)."""
    src = open(source, "rb").read()
    key = hashlib.sha256(src + " ".join(kernels.NVCC_FLAGS).encode())
    out = kernels.BUILD_DIR / f"compare-{key.hexdigest()[:16]}.so"
    if not out.exists():
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o",
                        str(out), source], check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).srt_hash_string
    fn.restype = ctypes.c_int
    params = re.search(rb"srt_hash_string\(([^)]*)\)", src).group(1)
    tiled = b"threads" in params
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([p, p, p, p, ctypes.c_int64, i, i, i, p] if tiled
                   else [p, p, p, p, ctypes.c_int64, i, p])

    def launch(torch, chars, lengths, seeds, out_t):
        n, width = chars.shape
        args = [chars.data_ptr(), lengths.data_ptr(), seeds.data_ptr(),
                out_t.data_ptr(), n, width]
        if tiled:
            geo = kernels.tile_geometry([(kernels.STRING_TAG, width)], n)
            args += [geo.threads, geo.pitches[0]]
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{source}: CUDA error {err}")

    return launch


def child(source: str, n: int, widths: list) -> None:
    """Time one build at every width; one JSON line each."""
    import torch

    from spark_rapids_tpu_torch.ops import kernels

    launch = None if source == "current" else build(kernels, source)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    for width in widths:
        chars, lengths = chip_smoke.string_inputs(torch, n, width, gen)
        seeds = chip_smoke.random_seeds(torch, n, gen)
        out = torch.empty(n, dtype=torch.int32, device=dev)
        if launch is None:
            def fn():
                out.copy_(kernels.hash_string(chars, lengths, seeds))
            timed = lambda: kernels.hash_string(  # noqa: E731
                chars, lengths, seeds)
        else:
            def fn():
                launch(torch, chars, lengths, seeds, out)
            timed = fn
        fn()
        torch.cuda.synchronize()
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
        t = chip_smoke.device_and_host_ms(torch, timed, iters=20)
        bound_ms, _ = chip_smoke.k1_bound_ms(torch, lengths, width)
        print(json.dumps({"w": width, "device_ms": t["device_ms"],
                          "bound_ms": bound_ms, "digest": digest}),
              flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--rows", type=int, default=chip_smoke.TIMED_ROWS)
    ap.add_argument("--widths", default="1,16,64,256")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hash_kernel_compare: needs an NVIDIA card", file=sys.stderr)
        return 2
    widths = [int(w) for w in args.widths.split(",")]
    if args.child:
        child(args.child, args.rows, widths)
        return 0
    print(chip_smoke.nvidia_smi(), flush=True)
    builds = ["current"] + args.source
    runs: dict = {}
    for name in builds + builds[:0:-1] + builds[:1]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", name,
             "--rows", str(args.rows), "--widths", args.widths],
            capture_output=True, text=True, check=True)
        for line in proc.stdout.splitlines():
            r = json.loads(line)
            runs.setdefault((name, r["w"]), []).append(r)
    for (name, width), rs in runs.items():
        want = runs[("current", width)][0]["digest"]
        if any(r["digest"] != want for r in rs):
            raise AssertionError(f"{name} hashes differ at W={width}")
        device = [r["device_ms"] for r in rs]
        print(json.dumps({"build": name, "w": width, "device_ms": device,
                          "bound_ms": rs[0]["bound_ms"],
                          "share_of_bound": rs[0]["bound_ms"] / min(device)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
