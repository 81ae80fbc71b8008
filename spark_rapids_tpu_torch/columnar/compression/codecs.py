"""The built-in codecs.

Counterpart of ``spark_rapids_tpu/columnar/compression/codecs.py``.
The host packing is the JAX module's numpy, line for line, so a packed
component is byte for byte the JAX package's: k-bit lanes fold into
uint32 words by a reshape, a shift and an or-reduce.  The device
unpacking is plain torch on the batch's device: shifts and masks for
bitpack lanes, a per-block cumulative sum for delta, a cumulative sum
and ``searchsorted`` gather for RLE, and an index write that patches
the exception blocks (``_patch_exceptions``).

A component tensor holds the component's bytes in the signed torch
type of its width (``columnar/transfer.py::storage_dtype``: uint16 as
int16, uint32 as int32), since torch's unsigned types past uint8 lack
most operations; a decode widens such words with a mask.
"""

from __future__ import annotations

import zlib
from typing import Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.compression.registry import (
    Codec,
    register_codec,
)

#: packed lane widths: each uint32 word holds exactly 32 / k lanes.
#: k = 0 is the pure frame-of-reference form (constant blocks: only the
#: per-block references ride the wire)
_KBITS = (0, 1, 2, 4, 8, 16)

_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def storage_dtype(dt: np.dtype) -> torch.dtype:
    """The torch dtype a component of numpy dtype ``dt`` is held in:
    the same bytes; uint16 / uint32 / uint64 in the signed type of
    their width."""
    dt = np.dtype(dt)
    if dt == np.bool_:
        return torch.bool
    if dt == np.uint8:
        return torch.uint8
    if dt.kind == "u":
        return _SIGNED[dt.itemsize]
    return torch.from_numpy(np.empty(0, dt)).dtype


def widen(t: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """A component tensor of numpy dtype ``dt`` as int64 values
    (unsigned words zero-extended)."""
    out = t.to(torch.int64)
    dt = np.dtype(dt)
    if dt.kind == "u" and dt.itemsize in (2, 4):
        out = out & ((1 << (8 * dt.itemsize)) - 1)
    return out


def _pack_words(lanes: np.ndarray, k: int) -> np.ndarray:
    """k-bit lanes (uint32, values < 2**k, length a multiple of 32/k)
    -> packed uint32 words, little-endian lane order within a word."""
    vpw = 32 // k
    m = lanes.reshape(-1, vpw)
    shifts = (np.arange(vpw, dtype=np.uint32) * np.uint32(k))
    return np.bitwise_or.reduce(m << shifts, axis=1).astype(np.uint32)


def _unpack_words(words: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The inverse of ``_pack_words`` on the device: n k-bit lanes as
    int64 (``words`` holds the uint32 words as int32)."""
    vpw = 32 // k
    i = torch.arange(n, dtype=torch.int64, device=words.device)
    w = words[i // vpw].to(torch.int64) & 0xFFFFFFFF
    return (w >> ((i % vpw) * k)) & ((1 << k) - 1)


def _pad_to_blocks(v: np.ndarray, block: int) -> np.ndarray:
    """Pad to a whole number of blocks with the LAST value (keeps the
    tail block's range; the decode slices the pad back off)."""
    n = len(v)
    padded = -(-n // block) * block
    if padded == n:
        return v
    return np.concatenate([v, np.full(padded - n, v[-1], v.dtype)])


def _range_guard(v64: np.ndarray) -> bool:
    """True when (v - blockmin) cannot overflow int64.  A spread past
    2**62 is incompressible for these codecs anyway."""
    return int(v64.max()) - int(v64.min()) < (1 << 62)


def _sample_blocks(n: int, block: int, take: int = 16) -> np.ndarray:
    nb = max(1, n // block)
    return np.unique(np.linspace(0, nb - 1, min(nb, take)).astype(int))


def _choose_k(ranges: np.ndarray, block: int, itemsize: int,
              padded: int) -> tuple[int, int]:
    """(k, nexc) minimizing the packed cost.  Blocks whose range
    exceeds 2**k - 1 become exceptions shipped raw and patched on the
    device, so one outlier block cannot widen every lane."""
    best_cost = best_k = best_exc = None
    for k in _KBITS:
        lim = (1 << k) - 1
        nexc = int(np.count_nonzero(ranges > lim))
        cost = (padded * k) // 8 + nexc * block * itemsize \
            + len(ranges) * 8
        if best_cost is None or cost < best_cost:
            best_cost, best_k, best_exc = cost, k, nexc
    return best_k, best_exc


def _exception_comps(a_padded: np.ndarray, exc_blocks: np.ndarray,
                     block: int) -> tuple[list[np.ndarray], int]:
    """([block indices (int32), raw block values (wire dtype)], cap)
    of the exception blocks; the count rounds up to a power of two,
    padded with repeats of the last block (an idempotent rewrite), as
    the JAX package's compile cache wants it."""
    idx = np.flatnonzero(exc_blocks).astype(np.int32)
    cap = 1
    while cap < len(idx):
        cap <<= 1
    pad = cap - len(idx)
    if pad:
        idx = np.concatenate([idx, np.full(pad, idx[-1], np.int32)])
    vals = a_padded.reshape(-1, block)[idx].reshape(-1)
    return [idx, np.ascontiguousarray(vals)], cap


def _patch_exceptions(out: torch.Tensor, arrays: Sequence, nexc: int,
                      block: int) -> torch.Tensor:
    """Overwrite the exception blocks of the rebuilt (padded-length)
    tensor with their raw values."""
    if nexc == 0:
        return out
    exc_idx, exc_vals = arrays[-2], arrays[-1]
    rows = (exc_idx[:, None].to(torch.int64) * block
            + torch.arange(block, device=out.device)[None, :]).reshape(-1)
    out[rows] = exc_vals.to(out.dtype)
    return out


def _block_decode(arrays: Sequence, meta: tuple, out_dtype: np.dtype,
                  delta: bool) -> torch.Tensor:
    _, block, k, nexc, padded, n = meta
    refs = arrays[1] if k else arrays[0]
    if k == 0:
        i = torch.arange(padded, dtype=torch.int64, device=refs.device)
        out = refs[i // block]
    elif delta:
        z = _unpack_words(arrays[0], k, padded)
        d = (z >> 1) ^ -(z & 1)  # un-zigzag
        out = (torch.cumsum(d.reshape(-1, block), dim=1)
               + refs[:, None]).reshape(-1)
    else:
        i = torch.arange(padded, dtype=torch.int64, device=refs.device)
        out = refs[i // block] + _unpack_words(arrays[0], k, padded)
    out = _patch_exceptions(out.to(storage_dtype(out_dtype)), arrays, nexc,
                            block)
    return out[:n]


class BitpackCodec(Codec):
    """Block frame-of-reference + sub-byte bitpacking: per block the
    host subtracts the block minimum and packs the deltas as k-bit
    lanes into uint32 words; the device unpacks with shifts and masks
    and adds the block reference back.  For dictionary codes, dates,
    validity masks and clustered integer keys."""

    name = "bitpack"
    decoder_program_key = "device:wire.decode.bitpack"
    supports_arrays = True

    def estimate(self, vals: np.ndarray,
                 block_rows: int) -> Optional[float]:
        v = vals.astype(np.int64, copy=False)
        ranges = []
        for b in _sample_blocks(len(v), block_rows):
            blk = v[b * block_rows:(b + 1) * block_rows]
            if not _range_guard(blk):
                return None
            ranges.append(int(blk.max()) - int(blk.min()))
        k, nexc = _choose_k(np.asarray(ranges, np.int64), block_rows,
                            vals.dtype.itemsize,
                            len(ranges) * block_rows)
        exc_frac = nexc / max(len(ranges), 1)
        return vals.dtype.itemsize / (
            k / 8 + 8.0 / block_rows
            + exc_frac * vals.dtype.itemsize)

    def encode_array(self, vals: np.ndarray, block_rows: int
                     ) -> Optional[tuple[list[np.ndarray], tuple]]:
        n = len(vals)
        v64 = _pad_to_blocks(vals.astype(np.int64), block_rows)
        if not _range_guard(v64):
            return None
        a_padded = _pad_to_blocks(np.asarray(vals), block_rows) \
            if len(v64) != n else np.asarray(vals)
        blocks = v64.reshape(-1, block_rows)
        refs = blocks.min(axis=1)
        delta = blocks - refs[:, None]
        ranges = delta.max(axis=1)
        k, nexc = _choose_k(ranges, block_rows,
                            vals.dtype.itemsize, len(v64))
        exc_blocks = ranges > ((1 << k) - 1)
        comps: list[np.ndarray] = []
        if k > 0:
            lanes = np.where(exc_blocks[:, None], 0, delta)
            comps.append(_pack_words(
                lanes.reshape(-1).astype(np.uint32), k))
        comps.append(refs)
        exc_cap = 0
        if nexc:
            exc, exc_cap = _exception_comps(a_padded, exc_blocks,
                                            block_rows)
            comps += exc
        return comps, ("bitpack", block_rows, k, exc_cap, len(v64), n)

    def decode_array(self, arrays: Sequence, meta: tuple,
                     out_dtype: np.dtype) -> torch.Tensor:
        return _block_decode(arrays, meta, out_dtype, delta=False)


class DeltaCodec(Codec):
    """Delta + zigzag + bitpack for sorted or clustered columns: per
    block the host keeps the first value and packs the zigzagged
    successive differences; the device unpacks them and rebuilds the
    block with a cumulative sum."""

    name = "delta"
    decoder_program_key = "device:wire.decode.delta"
    supports_arrays = True

    @staticmethod
    def _zigzag_bits(d: np.ndarray) -> int:
        z = (d << 1) ^ (d >> 63)
        return int(z.max()).bit_length() if len(z) else 0

    def estimate(self, vals: np.ndarray,
                 block_rows: int) -> Optional[float]:
        v = vals.astype(np.int64, copy=False)
        ranges = []
        for b in _sample_blocks(len(v), block_rows, take=8):
            blk = v[b * block_rows:(b + 1) * block_rows]
            if len(blk) < 2:
                continue
            if not _range_guard(blk):
                return None
            ranges.append(self._zigzag_bits(np.diff(blk)))
        if not ranges:
            return None
        zr = np.asarray([(1 << b) - 1 for b in ranges], np.int64)
        k, nexc = _choose_k(zr, block_rows, vals.dtype.itemsize,
                            len(zr) * block_rows)
        exc_frac = nexc / len(zr)
        return vals.dtype.itemsize / (
            k / 8 + 8.0 / block_rows
            + exc_frac * vals.dtype.itemsize)

    def encode_array(self, vals: np.ndarray, block_rows: int
                     ) -> Optional[tuple[list[np.ndarray], tuple]]:
        n = len(vals)
        v64 = _pad_to_blocks(vals.astype(np.int64), block_rows)
        if not _range_guard(v64):
            return None
        a_padded = _pad_to_blocks(np.asarray(vals), block_rows) \
            if len(v64) != n else np.asarray(vals)
        blocks = v64.reshape(-1, block_rows)
        refs = np.ascontiguousarray(blocks[:, 0])
        d = np.diff(blocks, axis=1, prepend=blocks[:, :1])
        z = (d << 1) ^ (d >> 63)
        ranges = z.max(axis=1)
        k, nexc = _choose_k(ranges, block_rows,
                            vals.dtype.itemsize, len(v64))
        exc_blocks = ranges > ((1 << k) - 1)
        comps: list[np.ndarray] = []
        if k > 0:
            lanes = np.where(exc_blocks[:, None], 0, z)
            comps.append(_pack_words(
                lanes.reshape(-1).astype(np.uint32), k))
        comps.append(refs)
        exc_cap = 0
        if nexc:
            exc, exc_cap = _exception_comps(a_padded, exc_blocks,
                                            block_rows)
            comps += exc
        return comps, ("delta", block_rows, k, exc_cap, len(v64), n)

    def decode_array(self, arrays: Sequence, meta: tuple,
                     out_dtype: np.dtype) -> torch.Tensor:
        return _block_decode(arrays, meta, out_dtype, delta=True)


class RleCodec(Codec):
    """Run-length encoding, expanded on the device by a cumulative sum
    over the run lengths and a ``searchsorted`` gather: heavy-repeat
    columns (flags, clustered codes, zero char tails) collapse to
    (values, lengths) pairs.  The run capacity rounds up to a power of
    two, as in the JAX package."""

    name = "rle"
    decoder_program_key = "device:wire.decode.rle"
    supports_arrays = True

    def estimate(self, vals: np.ndarray,
                 block_rows: int) -> Optional[float]:
        n = len(vals)
        win = min(n, 2048)
        changes = 0
        sampled = 0
        for start in {0, max(0, n // 2 - win // 2), max(0, n - win)}:
            w = vals[start:start + win]
            if len(w) > 1:
                changes += int(np.count_nonzero(w[1:] != w[:-1]))
                sampled += len(w) - 1
        if sampled == 0:
            return None
        est_runs = max(1.0, (changes / sampled) * n + 3)
        return (n * vals.dtype.itemsize) \
            / (est_runs * (vals.dtype.itemsize + 4))

    def encode_array(self, vals: np.ndarray, block_rows: int
                     ) -> Optional[tuple[list[np.ndarray], tuple]]:
        n = len(vals)
        change = np.flatnonzero(vals[1:] != vals[:-1]) + 1
        starts = np.concatenate([np.zeros(1, np.int64), change])
        r = len(starts)
        cap = 8
        while cap < r:
            cap <<= 1
        values = np.empty(cap, vals.dtype)
        values[:r] = vals[starts]
        values[r:] = vals[-1]
        lens = np.zeros(cap, np.int32)
        lens[:r] = np.diff(np.concatenate(
            [starts, np.asarray([n], np.int64)])).astype(np.int32)
        return [values, lens], ("rle", cap, n)

    def decode_array(self, arrays: Sequence, meta: tuple,
                     out_dtype: np.dtype) -> torch.Tensor:
        values, lens = arrays
        _, _cap, n = meta
        ends = torch.cumsum(lens.to(torch.int64), dim=0)
        idx = torch.searchsorted(
            ends, torch.arange(n, dtype=torch.int64, device=ends.device),
            right=True)
        return values[idx].to(storage_dtype(out_dtype))


class NoneCodec(Codec):
    """Identity byte codec: frames as serialized."""

    name = "none"
    decoder_program_key = "host:identity"
    supports_bytes = True

    def compress_bytes(self, body: bytes) -> bytes:
        return body

    def decompress_bytes(self, body: bytes) -> bytes:
        return body


class ZlibCodec(Codec):
    """Host zlib (level 1) of the spill frames, as in the JAX
    package."""

    name = "zlib"
    decoder_program_key = "host:zlib.decompress"
    supports_bytes = True

    def compress_bytes(self, body: bytes) -> bytes:
        return zlib.compress(body, 1)

    def decompress_bytes(self, body: bytes) -> bytes:
        return zlib.decompress(body)


register_codec(BitpackCodec())
register_codec(DeltaCodec())
register_codec(RleCodec())
register_codec(NoneCodec())
register_codec(ZlibCodec())
