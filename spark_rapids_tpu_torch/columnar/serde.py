"""The spill tiers' frame: a dict of host arrays <-> one byte string.

Counterpart of ``spark_rapids_tpu/columnar/serde.py``, byte for byte:
``TPUB`` | version 1 and a reserved zero (two little-endian uint16) |
the JSON header's length (uint32) | the header (``{"cols": [{"name",
"dtype", "shape", "nbytes"}, ...], "codec": ...}``) | the arrays' raw
bytes, concatenated in the header's order, then compressed by the
codec.  The codec comes from the shared registry's byte codecs
(``columnar/compression/``: ``none``, ``zlib`` at level 1, as in the
JAX package), which also counts raw against stored bytes per codec; an
unknown name raises ``ValueError``, as the JAX registry does.  A frame
either package writes, the other reads.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from spark_rapids_tpu_torch.columnar import compression as WC
from spark_rapids_tpu_torch.memory.device_manager import HostBufferPool

_MAGIC = b"TPUB"
_VERSION = 1


def serialize_arrays(arrays: dict, codec: str = "none") -> bytes:
    """Host arrays (name -> numpy array) -> one frame."""
    bytes_codec = WC.get_bytes_codec(codec)
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
    body = bytes_codec.compress_bytes(body)
    WC.record_compress(codec, total, len(body))
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
    body = memoryview(data)[12 + hlen:]
    if meta["codec"] != "none":
        # a bytearray keeps the arrays writable, as the caller asked
        body = bytearray(WC.get_bytes_codec(meta["codec"])
                         .decompress_bytes(body))
    WC.record_decompress(meta["codec"])
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
