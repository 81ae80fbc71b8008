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
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

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


def _hash_string_lib() -> ctypes.CDLL:
    lib = load_library("hash_string")
    fn = lib.srt_hash_string
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


# --------------------------------------------------------------------- #
# K1: Spark murmur3 hashUnsafeBytes of strings (csrc/hash_string.cu)
# --------------------------------------------------------------------- #


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


def _check_hash_string_args(chars, lengths, seeds) -> None:
    if chars.dtype != torch.uint8 or chars.dim() != 2:
        raise TypeError(f"chars must be (N, W) uint8, got {chars.dtype} "
                        f"{tuple(chars.shape)}")
    n = chars.shape[0]
    for name, t in (("lengths", lengths), ("seeds", seeds)):
        if t.dtype != torch.int32 or tuple(t.shape) != (n,):
            raise TypeError(f"{name} must be ({n},) int32, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != chars.device:
            raise ValueError(f"{name} on {t.device}, chars on "
                             f"{chars.device}")
    if not (chars.is_contiguous() and lengths.is_contiguous()
            and seeds.is_contiguous()):
        raise ValueError("hash_string needs contiguous tensors")


class HashString:
    """K1 wrapper.  On CUDA it launches ``srt_hash_string`` on the
    current stream; on the CPU it runs ``hash_string_bytes_reference``.
    Lengths are expected in [0, W]; the kernel reads no byte past W
    whatever they hold.  ``launches`` counts kernel launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, chars: torch.Tensor, lengths: torch.Tensor,
                 seeds: torch.Tensor) -> torch.Tensor:
        _check_hash_string_args(chars, lengths, seeds)
        if chars.device.type == "cpu":
            return hash_string_bytes_reference(chars, lengths, seeds)
        if chars.device.type != "cuda":
            raise ValueError(f"hash_string has no kernel for {chars.device}")
        n, width = chars.shape
        out = torch.empty(n, dtype=torch.int32, device=chars.device)
        if n == 0:
            return out
        lib = _hash_string_lib()
        with torch.cuda.device(chars.device):
            stream = torch.cuda.current_stream(chars.device).cuda_stream
            err = lib.srt_hash_string(chars.data_ptr(), lengths.data_ptr(),
                                      seeds.data_ptr(), out.data_ptr(), n,
                                      width, stream)
        if err != 0:
            raise RuntimeError(
                f"hash_string kernel launch failed: CUDA error {err}")
        self.launches += 1
        return out


hash_string = HashString()
