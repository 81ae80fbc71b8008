"""The codec registry: the shared codec surface of the wire upload and
the spill tiers.

Counterpart of ``spark_rapids_tpu/columnar/compression/registry.py``.
Two codec kinds share one registry and one per-codec stats surface:

- ARRAY codecs (bitpack, delta, rle): the host's ``encode_array`` packs
  a 1-D integer or bool wire component into smaller typed arrays and a
  meta tuple, while the scan's stage thread encodes the batch; the
  device's ``decode_array`` rebuilds the exact original from them in
  plain torch (shifts, masks, gathers, cumulative sums and
  ``searchsorted``) as the upload is decoded (``columnar/transfer.py``);
- BYTE codecs (none, zlib): host compression of the serde frame
  (``columnar/serde.py``) that the spill tiers hold and write.

Compression re-encodes losslessly: a codec round-trips bit for bit or
refuses (None), and the chooser also refuses a codec whose measured
ratio misses ``WIRE_MIN_RATIO``.

The conf keys are the JAX package's ``sql.wireCompression.enabled``
and ``.codecs`` (``config.py``).  Its ``.minRatio`` (1.3) and
``.blockRows`` (256) keys are the module constants ``WIRE_MIN_RATIO``
and ``WIRE_BLOCK_ROWS`` here: no path sets them, so the tests
monkeypatch them.  The stats are updated from the scan's stage
threads at once, under a lock.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np

from spark_rapids_tpu_torch import config as C

#: the least measured ratio (raw bytes / packed bytes) a codec must
#: reach on a component before it rides the wire compressed
WIRE_MIN_RATIO = 1.3
#: frame-of-reference / delta block in rows (a power of two >= 32, so
#: packed lanes fill uint32 words exactly)
WIRE_BLOCK_ROWS = 256
#: components smaller than this ship raw: a packed scalar or a tiny
#: dictionary would spend a decode gather to save nothing measurable
MIN_COMPRESS_BYTES = 1024


class Codec:
    """One registered codec.  Array codecs implement ``estimate`` /
    ``encode_array`` / ``decode_array``; byte codecs
    ``compress_bytes`` / ``decompress_bytes``.  ``decoder_program_key``
    names what undoes the encode: a device decode or a host routine."""

    name: str = ""
    decoder_program_key: str = ""
    supports_arrays: bool = False
    supports_bytes: bool = False

    def estimate(self, vals: np.ndarray,
                 block_rows: int) -> Optional[float]:
        """A sampled ratio estimate (host), or None when the codec
        cannot apply; the chooser checks the real ratio after
        ``encode_array``."""
        return None

    def encode_array(self, vals: np.ndarray, block_rows: int
                     ) -> Optional[tuple[list[np.ndarray], tuple]]:
        """vals (1-D int, uint or bool) -> (component arrays, meta), or
        None when the codec does not apply."""
        raise NotImplementedError(self.name)

    def decode_array(self, arrays: Sequence, meta: tuple,
                     out_dtype: np.dtype):
        """The device side: the uploaded component tensors and the meta
        -> the exact original 1-D tensor of ``out_dtype``."""
        raise NotImplementedError(self.name)

    def compress_bytes(self, body: bytes) -> bytes:
        raise NotImplementedError(self.name)

    def decompress_bytes(self, body: bytes) -> bytes:
        raise NotImplementedError(self.name)


_REG_LOCK = threading.Lock()
_REGISTRY: dict[str, Codec] = {}


def register_codec(codec: Codec) -> Codec:
    if not codec.name:
        raise ValueError("codec must declare a name")
    with _REG_LOCK:
        _REGISTRY[codec.name] = codec
    return codec


def unregister_codec(name: str) -> None:
    """Remove a codec (a test's fixture registered it)."""
    with _REG_LOCK:
        _REGISTRY.pop(name, None)


def get_codec(name: str) -> Codec:
    with _REG_LOCK:
        c = _REGISTRY.get(name)
    if c is None:
        raise ValueError(f"unknown codec {name!r}")
    return c


def get_bytes_codec(name: str) -> Codec:
    c = get_codec(name)
    if not c.supports_bytes:
        raise ValueError(
            f"codec {name!r} has no byte-stream form (array-only)")
    return c


def registry_items() -> list[tuple[str, Codec]]:
    with _REG_LOCK:
        return sorted(_REGISTRY.items())


# -- per-codec stats: one surface for the wire and the spill tiers ------ #

_STATS_LOCK = threading.Lock()
_STATS: dict[str, dict] = {}


def _stat_entry(name: str) -> dict:
    e = _STATS.get(name)
    if e is None:
        e = _STATS[name] = {"compress_calls": 0, "decompress_calls": 0,
                            "raw_bytes": 0, "wire_bytes": 0}
    return e


def record_compress(name: str, raw: int, wire: int) -> None:
    with _STATS_LOCK:
        e = _stat_entry(name)
        e["compress_calls"] += 1
        e["raw_bytes"] += int(raw)
        e["wire_bytes"] += int(wire)


def record_decompress(name: str, count: int = 1) -> None:
    with _STATS_LOCK:
        _stat_entry(name)["decompress_calls"] += int(count)


def stats() -> dict:
    """{codec: {compress_calls, decompress_calls, raw_bytes,
    wire_bytes, ratio}}, whichever tier drove the codec."""
    with _STATS_LOCK:
        out = {}
        for name, e in sorted(_STATS.items()):
            d = dict(e)
            d["ratio"] = round(e["raw_bytes"] / e["wire_bytes"], 3) \
                if e["wire_bytes"] else 0.0
            out[name] = d
        return out


def reset_stats() -> None:
    with _STATS_LOCK:
        _STATS.clear()


# -- the chooser --------------------------------------------------------- #


def wire_codec_config(conf: C.TorchConf) -> Optional[tuple]:
    """(codec names, min ratio, block rows) when ``conf`` turns wire
    compression on, else None: off, the wire is byte for byte the
    uncompressed one."""
    if not conf.get(C.WIRE_COMPRESSION):
        return None
    names = tuple(n.strip() for n in str(conf.get(C.WIRE_CODECS)).split(",")
                  if n.strip())
    return names, float(WIRE_MIN_RATIO), int(WIRE_BLOCK_ROWS)


def choose_and_encode(vals: np.ndarray, names: Sequence[str],
                      min_ratio: float, block_rows: int
                      ) -> Optional[tuple[str, list[np.ndarray], tuple]]:
    """The best-paying codec's encoding of one 1-D wire component, or
    None to ship it raw.  Sampled estimates rank the candidates; the
    winner's real ratio is checked against ``min_ratio`` before it is
    taken."""
    if vals.ndim != 1 or vals.dtype.kind not in "iub" \
            or vals.nbytes < MIN_COMPRESS_BYTES or len(vals) == 0:
        return None
    ranked = []
    for name in names:
        with _REG_LOCK:
            c = _REGISTRY.get(name)
        if c is None or not c.supports_arrays:
            continue
        est = c.estimate(vals, block_rows)
        if est is not None and est >= min_ratio:
            ranked.append((est, name, c))
    ranked.sort(key=lambda t: t[0], reverse=True)
    for _est, name, c in ranked:
        enc = c.encode_array(vals, block_rows)
        if enc is None:
            continue
        arrays, meta = enc
        wire = sum(int(a.nbytes) for a in arrays)
        if wire == 0 or vals.nbytes / wire < min_ratio:
            continue
        record_compress(name, vals.nbytes, wire)
        return name, arrays, meta
    return None
