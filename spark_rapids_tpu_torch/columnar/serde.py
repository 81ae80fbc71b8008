"""The disk tier's frame: a dict of host arrays <-> one byte string.

Counterpart of ``spark_rapids_tpu/columnar/serde.py``, byte for byte:
``TPUB`` | version 1 and a reserved zero (two little-endian uint16) |
the JSON header's length (uint32) | the header (``{"cols": [{"name",
"dtype", "shape", "nbytes"}, ...], "codec": ...}``) | the arrays' raw
bytes, concatenated in the header's order.  A frame either package
writes, the other reads.  Only the ``none`` codec is ported: the byte
codecs come with the wire codecs (ROADMAP item 9).
"""

from __future__ import annotations

import json
import struct

import numpy as np

from spark_rapids_tpu_torch.memory.device_manager import HostBufferPool

_MAGIC = b"TPUB"
_VERSION = 1
CODECS = ("none",)


def _check_codec(codec: str) -> None:
    if codec not in CODECS:
        raise NotImplementedError(
            f"spill codec {codec!r} is not ported to spark_rapids_tpu_torch "
            "(only 'none'; the byte codecs are ROADMAP item 9, the wire "
            "codecs)")


def serialize_arrays(arrays: dict, codec: str = "none") -> bytes:
    """Host arrays (name -> numpy array) -> one frame."""
    _check_codec(codec)
    header, items, total = [], [], 0
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        header.append({"name": name, "dtype": a.dtype.str,
                       "shape": list(a.shape), "nbytes": a.nbytes})
        items.append(a)
        total += a.nbytes
    # one recycled staging buffer, not a tobytes() copy per array
    pool = HostBufferPool.get()
    staging = pool.take(max(total, 1))
    flat = staging.numpy()
    off = 0
    for a in items:
        flat[off: off + a.nbytes] = a.view(np.uint8).reshape(-1)
        off += a.nbytes
    body = bytes(flat[:total])
    pool.give(staging)
    hjson = json.dumps({"cols": header, "codec": codec}).encode()
    return b"".join([_MAGIC, struct.pack("<HH", _VERSION, 0),
                     struct.pack("<I", len(hjson)), hjson, body])


def deserialize_arrays(data) -> dict:
    """One frame (bytes, or a bytearray for writable arrays) -> host
    arrays."""
    if bytes(data[:4]) != _MAGIC:
        raise ValueError("not a serialized batch (bad magic)")
    version, _ = struct.unpack("<HH", data[4:8])
    if version != _VERSION:
        raise ValueError(f"unsupported batch version {version}")
    (hlen,) = struct.unpack("<I", data[8:12])
    meta = json.loads(bytes(data[12:12 + hlen]).decode())
    _check_codec(meta["codec"])
    body = memoryview(data)[12 + hlen:]
    out, off = {}, 0
    for c in meta["cols"]:
        dt = np.dtype(c["dtype"])
        out[c["name"]] = np.frombuffer(
            body, dtype=dt, count=c["nbytes"] // dt.itemsize,
            offset=off).reshape(c["shape"])
        off += c["nbytes"]
    return out


def write_spill_file(path: str, arrays: dict, codec: str = "none") -> None:
    with open(path, "wb") as f:
        f.write(serialize_arrays(arrays, codec))


def read_spill_file(path: str) -> dict:
    """The frame at ``path``; its arrays are writable."""
    with open(path, "rb") as f:
        return deserialize_arrays(bytearray(f.read()))
