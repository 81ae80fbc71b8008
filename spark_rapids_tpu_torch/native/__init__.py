"""The host codec: C++ for the Parquet decoder's byte work.

Counterpart of ``spark_rapids_tpu/native/__init__.py``, for the entry
points ``io/fastpar.py`` calls: ``snappy_raw_decompress`` and
``rle_unpack_u32`` (``hostcodec.cpp``, the port's own copy of the
decoder half of the JAX package's file, its bit-packed runs and
overlapping snappy copies read a word at a time), and
``parquet_page_headers``, ``decode_pages`` and ``byte_array_plain``,
which walk a chunk's page headers, decode its data pages (dictionary
codes, PLAIN fixed-width values, definition levels) and split a string
dictionary page, each in one call, where the JAX decoder works page by
page and value by value in Python; and ``gather_codes``, the upload's
gather of a dictionary-encoded fixed-width column
(``columnar/arrow.py``); and the wire encoder's host passes
(``columnar/transfer.py``, copies of the JAX file's): ``chars_fill``,
``minmax_i64`` / ``minmax_i32``, ``bias_encode8/16_i64/_i32`` and
``scaled_check_encode``.  The source is compiled with
``g++ -O3 -shared -fPIC -std=c++17`` at first use into
``spark_rapids_tpu_torch/_build/``, keyed by a hash of the source and
flags; the compiler writes a temporary name that ``os.replace`` moves
into place, so processes building at once never load a half-written
library.  It is loaded with ``ctypes``, whose calls release the GIL.

Unlike the JAX ``load()``, which returns None and lets its callers fall
back to numpy, a failed build or load raises ``HostCodecError``: a
missing compiler must not change the decode path unseen.  The plain
versions (``fastpar._rle_decode_numpy``, ``pyarrow.Codec("snappy")``,
``fastpar._parse_page_header``, and ``transfer.py``'s numpy forms of
the encoder's passes) stay for the tests to hold the C++ against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "hostcodec.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


class HostCodecError(RuntimeError):
    """The host codec failed to build or load."""


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"hostcodec-{key[:16]}.so"


def build() -> Path:
    """Compile the codec unless its keyed build exists; raises if
    ``g++`` is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise HostCodecError("g++ not found: the host codec of "
                             "spark_rapids_tpu_torch needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise HostCodecError(f"g++ failed for hostcodec.cpp:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The codec library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except OSError as e:
                raise HostCodecError(f"cannot load the host codec: {e}") \
                    from e
            c = ctypes
            lib.snappy_raw_decompress.argtypes = [c.c_void_p, c.c_int64,
                                                  c.c_void_p, c.c_int64]
            lib.snappy_raw_decompress.restype = c.c_int
            lib.rle_unpack_u32.argtypes = [c.c_void_p, c.c_int64, c.c_int,
                                           c.c_void_p, c.c_int64]
            lib.rle_unpack_u32.restype = c.c_int
            lib.parquet_page_headers.argtypes = [
                c.c_void_p, c.c_int64, c.c_int64, c.c_int64, c.c_void_p,
                c.c_int64]
            lib.parquet_page_headers.restype = c.c_int64
            lib.decode_pages.argtypes = [
                c.c_void_p, c.c_void_p, c.c_int64, c.c_int, c.c_int64,
                c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64,
                c.c_void_p, c.c_void_p]
            lib.decode_pages.restype = c.c_int64
            lib.byte_array_plain.argtypes = [c.c_void_p, c.c_int64,
                                             c.c_int64, c.c_void_p,
                                             c.c_void_p]
            lib.byte_array_plain.restype = c.c_int64
            lib.gather_codes.argtypes = [c.c_void_p, c.c_int64, c.c_int64,
                                         c.c_void_p, c.c_int64, c.c_void_p]
            lib.gather_codes.restype = c.c_int
            lib.chars_fill.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                       c.c_int64, c.c_int64, c.c_void_p]
            lib.chars_fill.restype = None
            for name in ("minmax_i64", "minmax_i32"):
                fn = getattr(lib, name)
                fn.argtypes = [c.c_void_p, c.c_int64, c.c_void_p,
                               c.c_void_p]
                fn.restype = None
            for name in ("bias_encode8_i64", "bias_encode16_i64",
                         "bias_encode8_i32", "bias_encode16_i32"):
                fn = getattr(lib, name)
                fn.argtypes = [c.c_void_p, c.c_int64, c.c_int64, c.c_void_p]
                fn.restype = None
            lib.scaled_check_encode.argtypes = [c.c_void_p, c.c_int64,
                                                c.c_void_p]
            lib.scaled_check_encode.restype = c.c_int
            _lib = lib
        return _lib
