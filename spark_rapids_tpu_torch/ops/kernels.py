"""Hand-written Hopper kernels, their build, and their plain versions.

Counterpart of ``spark_rapids_tpu/ops/pallas_kernels.py``.  Each kernel
is CUDA C++ under ``csrc/``, compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface and bound with ``ctypes``.
The build runs at first use, from the sources in this package, into
``_build/`` keyed by a hash of the source and flags, so a checkout
builds its own kernels.

Every wrapper launches its kernel for a CUDA tensor and runs the
kernel's plain PyTorch version for a CPU tensor; there is no other
route, and a failed build or launch raises.  ``<wrapper>.launches``
counts kernel launches (and nothing else), so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import AnyColumn, StringColumn

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_BUILD_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "spark_rapids_tpu_torch need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by source and flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its keyed build exists; the
    compiler's output (register and spill counts) goes beside it as
    ``.log``.  Raises if ``nvcc`` is missing or fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library(name: str) -> ctypes.CDLL:
    with _BUILD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build_library(name)))
        return lib


def _hash_lib() -> ctypes.CDLL:
    lib = load_library("hash_string")
    lib.srt_hash_string.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.srt_hash_string.restype = ctypes.c_int
    lib.srt_hash_columns.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.srt_hash_columns.restype = ctypes.c_int
    return lib


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# --------------------------------------------------------------------- #
# K1: Spark murmur3 (csrc/hash_string.cu), tile geometry
# --------------------------------------------------------------------- #

#: column type tags of csrc/hash_string.cu
BOOL_TAG, INT32_TAG, INT64_TAG, FLOAT64_TAG, STRING_TAG = range(5)
#: shared memory one block may use on sm_90 (227 KB)
SMEM_PER_BLOCK = 232448
#: bytes of staged chars a tile aims at
TILE_BYTES = 16 << 10
WARP = 32
MAX_THREADS = 256
#: block size with nothing staged: 1-3 % faster than 256 at every width
#: up to 56 on an H100 (scripts/hash_tile_sweep.py)
DIRECT_THREADS = 128
#: strings at most this wide are read straight from global memory: on
#: an H100 that beat staging at every width up to 56 and lost to it at
#: 64, 128 and 256 (scripts/hash_tile_sweep.py; PERF.md)
NARROW_WIDTH = 56
#: columns per launch of srt_hash_columns; longer tuples chain
MAX_COLUMNS = 16


def pitch_words(width: int) -> int:
    """Shared-memory row pitch, in 32-bit words, of a staged string
    column of width W: room for W bytes after a shift of up to 3 (the
    row's address mod 4), rounded up to an odd count so that a warp's
    32 rows fall in 32 banks."""
    return (width + 6) // 4 | 1


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """One launch's tile: ``threads`` rows (= threads per block, a
    multiple of 32), each column's chars ``pitches`` (0 = read from
    global memory) and ``offsets`` in words of the block's shared
    memory, ``smem_words`` in all."""

    threads: int
    pitches: list
    offsets: list
    smem_words: int


def tile_geometry(columns, n: int) -> TileGeometry:
    """The tile of a launch over ``columns`` ((type tag, width) each) and
    ``n`` rows.  Strings wider than ``NARROW_WIDTH`` are staged; the
    widest of them are read straight from global memory instead until
    one warp's rows fit in ``SMEM_PER_BLOCK``; the tile then holds about
    ``TILE_BYTES`` of chars."""
    pitches = [pitch_words(w) if tag == STRING_TAG and w > NARROW_WIDTH
               else 0 for tag, w in columns]
    while 4 * WARP * sum(pitches) > SMEM_PER_BLOCK:
        pitches[max(range(len(pitches)), key=pitches.__getitem__)] = 0
    staged = sum(pitches)
    threads = TILE_BYTES // (4 * staged) if staged else DIRECT_THREADS
    threads = max(WARP, min(MAX_THREADS, threads, -(-n // WARP) * WARP))
    threads = threads // WARP * WARP
    widest = max((w for (tag, w), p in zip(columns, pitches) if p),
                 default=0)
    while threads > WARP and threads * widest * widest >= 1 << 32:
        threads -= WARP  # tile offsets must divide exactly by W
    offsets, off = [], 0
    for p in pitches:
        offsets.append(off)
        off += threads * p
    return TileGeometry(threads, pitches, offsets, off)


def hash_string_bytes_reference(chars: torch.Tensor, lengths: torch.Tensor,
                                seeds: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1, the same function as ``csrc/hash_string.cu``:
    ``chars (N, W)`` uint8, ``lengths (N,)`` int32, ``seeds (N,)`` int32
    holding uint32 bits -> ``(N,)`` int32 holding the uint32 hashes.
    An unrolled pass per 4-byte block and per tail byte, as the JAX
    package's jnp path (``exprs/hashing.py::hash_string_bytes``)."""
    from spark_rapids_tpu_torch.exprs.hashing import (
        MASK32,
        fmix,
        from_int32_bits,
        mix_h1,
        mix_k1,
        to_int32_bits,
    )

    n, width = chars.shape
    h1 = from_int32_bits(seeds)
    lens = lengths.long()
    aligned = lens - torch.remainder(lens, 4)
    c = chars.long()
    for j in range(0, width, 4):
        word = torch.zeros(n, dtype=torch.int64, device=chars.device)
        for off in range(4):
            if j + off < width:
                word = word | (c[:, j + off] << (8 * off))
        h1 = torch.where(j + 4 <= aligned, mix_h1(h1, mix_k1(word)), h1)
    for j in range(width):
        is_tail = (j >= aligned) & (j < lens)
        signed = chars[:, j].view(torch.int8).long() & MASK32
        h1 = torch.where(is_tail, mix_h1(h1, mix_k1(signed)), h1)
    return to_int32_bits(fmix(h1, lens & MASK32))


def _check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                  shape: tuple, device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise TypeError(f"{name} must be {shape} {dtype}, got {t.dtype} "
                        f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class HashString:
    """K1 on one string column.  On CUDA it launches ``srt_hash_string``
    on the current stream; on the CPU it runs
    ``hash_string_bytes_reference``.  Lengths are expected in [0, W];
    the kernel reads no byte past W whatever they hold.  ``launches``
    counts kernel launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, chars: torch.Tensor, lengths: torch.Tensor,
                 seeds: torch.Tensor) -> torch.Tensor:
        if chars.dtype != torch.uint8 or chars.dim() != 2:
            raise TypeError(f"chars must be (N, W) uint8, got {chars.dtype} "
                            f"{tuple(chars.shape)}")
        n, width = chars.shape
        _check_tensor("chars", chars, torch.uint8, (n, width), chars.device)
        _check_tensor("lengths", lengths, torch.int32, (n,), chars.device)
        _check_tensor("seeds", seeds, torch.int32, (n,), chars.device)
        if chars.device.type == "cpu":
            return hash_string_bytes_reference(chars, lengths, seeds)
        if chars.device.type != "cuda":
            raise ValueError(f"hash_string has no kernel for {chars.device}")
        out = torch.empty(n, dtype=torch.int32, device=chars.device)
        if n == 0:
            return out
        geo = tile_geometry([(STRING_TAG, width)], n)
        lib = _hash_lib()
        with torch.cuda.device(chars.device):
            stream = torch.cuda.current_stream(chars.device).cuda_stream
            err = lib.srt_hash_string(chars.data_ptr(), lengths.data_ptr(),
                                      seeds.data_ptr(), out.data_ptr(), n,
                                      width, geo.threads, geo.pitches[0],
                                      stream)
        _check_launch("hash_string", err)
        self.launches += 1
        return out


hash_string = HashString()


# --------------------------------------------------------------------- #
# K1 over a key tuple: the hash exchange's one launch per batch
# --------------------------------------------------------------------- #

DEFAULT_SEED = 42

#: SQL type -> (type tag, physical dtype) of a fixed-width column
_FIXED_TAGS = {
    T.BooleanType: (BOOL_TAG, torch.bool),
    T.IntegerType: (INT32_TAG, torch.int32),
    T.DateType: (INT32_TAG, torch.int32),
    T.LongType: (INT64_TAG, torch.int64),
    T.DoubleType: (FLOAT64_TAG, torch.float64),
}


class _ColDesc(ctypes.Structure):
    """``ColDesc`` of csrc/hash_string.cu."""

    _fields_ = [("type", ctypes.c_int32), ("width", ctypes.c_int32),
                ("pitch_words", ctypes.c_int32),
                ("smem_off", ctypes.c_int32), ("data", ctypes.c_void_p),
                ("validity", ctypes.c_void_p), ("lengths", ctypes.c_void_p)]


def _check_column(col: AnyColumn, n: int, device: torch.device) -> None:
    """Raise TypeError for a type the kernel lacks or a wrong dtype or
    shape, ValueError for another device or a non-contiguous tensor."""
    if isinstance(col, StringColumn):
        _check_tensor("chars", col.chars, torch.uint8, (n, None), device)
        _check_tensor("lengths", col.lengths, torch.int32, (n,), device)
    else:
        tag = _FIXED_TAGS.get(type(col.dtype))
        if tag is None:
            raise TypeError(f"murmur3 unsupported for {col.dtype}")
        _check_tensor(f"{col.dtype} data", col.data, tag[1], (n,), device)
    _check_tensor("validity", col.validity, torch.bool, (n,), device)


def _hash_column_reference(col: AnyColumn,
                           seed: torch.Tensor) -> torch.Tensor:
    """One column into the running seed (int64 in [0, 2^32)); NULL rows
    keep the seed."""
    from spark_rapids_tpu_torch.exprs.hashing import (
        _double_to_bits,
        from_int32_bits,
        hash_int32_block,
        hash_int64_blocks,
        to_int32_bits,
    )

    if isinstance(col, StringColumn):
        h = from_int32_bits(hash_string_bytes_reference(
            col.chars, col.lengths, to_int32_bits(seed)))
    elif isinstance(col.dtype, (T.BooleanType, T.IntegerType, T.DateType)):
        h = hash_int32_block(col.data.to(torch.int32), seed)
    elif isinstance(col.dtype, T.LongType):
        h = hash_int64_blocks(col.data, seed)
    elif isinstance(col.dtype, T.DoubleType):
        h = hash_int64_blocks(_double_to_bits(col.data), seed)
    else:
        raise TypeError(f"murmur3 unsupported for {col.dtype}")
    return torch.where(col.validity, h, seed)


def hash_columns_reference(cols: Sequence[AnyColumn], seeds: torch.Tensor,
                           num_partitions: int = 0) -> torch.Tensor:
    """Plain PyTorch version of ``srt_hash_columns``: the chained Spark
    hash of ``cols`` from per-row ``seeds`` (int32 holding uint32 bits)
    -> int32 hashes, or int64 ``pmod(hash, num_partitions)`` when
    ``num_partitions`` > 0."""
    from spark_rapids_tpu_torch.exprs.hashing import (
        from_int32_bits,
        to_int32_bits,
    )

    h = from_int32_bits(seeds)
    for c in cols:
        h = _hash_column_reference(c, h)
    h = to_int32_bits(h)
    if num_partitions > 0:
        return torch.remainder(h.long(), num_partitions)
    return h


class HashColumns:
    """K1 over a key tuple: Spark ``hash(cols...)`` from ``seed``, or
    ``pmod(hash, num_partitions)`` as int64 when ``num_partitions`` > 0.
    On CUDA it launches ``srt_hash_columns`` once per 16 columns, each
    launch seeded by the last one's hashes; on the CPU each such chunk
    runs ``hash_columns_reference``.  ``launches`` counts kernel
    launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, cols: Sequence[AnyColumn], num_rows: int,
                 device, seed: int = DEFAULT_SEED,
                 num_partitions: int = 0) -> torch.Tensor:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        for c in cols:
            _check_column(c, num_rows, device)
        if num_partitions < 0:
            raise ValueError(f"num_partitions {num_partitions} < 0")
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"hash_columns has no kernel for {device}")
        seed_bits = (seed & 0xFFFFFFFF) - ((seed & 0x80000000) << 1)
        seeds = None
        if device.type == "cpu" or seed != DEFAULT_SEED:
            seeds = torch.full((num_rows,), seed_bits, dtype=torch.int32,
                               device=device)
        chunks = [cols[i:i + MAX_COLUMNS]
                  for i in range(0, len(cols), MAX_COLUMNS)] or [[]]
        for i, chunk in enumerate(chunks):
            parts = num_partitions if i == len(chunks) - 1 else 0
            if device.type == "cpu":
                seeds = hash_columns_reference(chunk, seeds, parts)
            else:
                seeds = self._launch(chunk, seeds, num_rows, parts, device)
        return seeds

    def _launch(self, cols, seeds, n: int, num_partitions: int,
                device: torch.device) -> torch.Tensor:
        out = torch.empty(n, dtype=torch.int64 if num_partitions else
                          torch.int32, device=device)
        if n == 0:
            return out
        tags = [(STRING_TAG, c.width) if isinstance(c, StringColumn)
                else (_FIXED_TAGS[type(c.dtype)][0], 0) for c in cols]
        geo = tile_geometry(tags, n)
        descs = (_ColDesc * MAX_COLUMNS)()
        for d, c, (tag, width), pitch, off in zip(
                descs, cols, tags, geo.pitches, geo.offsets):
            d.type, d.width, d.pitch_words, d.smem_off = tag, width, pitch, off
            d.validity = c.validity.data_ptr()
            if isinstance(c, StringColumn):
                d.data, d.lengths = c.chars.data_ptr(), c.lengths.data_ptr()
            else:
                d.data = c.data.data_ptr()
        lib = _hash_lib()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.srt_hash_columns(
                descs, len(cols),
                None if seeds is None else seeds.data_ptr(), n,
                num_partitions, geo.threads, out.data_ptr(), stream)
        _check_launch("hash_columns", err)
        self.launches += 1
        return out


hash_columns = HashColumns()
