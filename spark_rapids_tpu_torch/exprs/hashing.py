"""Spark-compatible Murmur3 hashing.

Counterpart of ``spark_rapids_tpu/exprs/hashing.py``: Spark's Murmur3
x86_32 with Spark's quirks, bit for bit:

- int/date/boolean, tinyint and smallint (sign-extended) and float
  bits hash as one 4-byte block;
- long, timestamp (microseconds), decimal (unscaled) and double bits
  hash as two 4-byte blocks, low word first;
- a float or double folds -0.0 into 0.0 first, and every NaN hashes
  as Java's canonical NaN bits;
- strings hash their bytes (``hashUnsafeBytes``): aligned 4-byte
  little-endian blocks, then each tail byte on its own, sign-extended;
- a NULL leaves the running seed untouched; multi-column hashes chain
  (the hash of column i seeds column i+1); the default seed is 42.

uint32 arithmetic: torch has no general uint32 arithmetic, so the
fixed-width hashes here run in **int64 holding values in [0, 2^32)**,
masked with ``& 0xFFFFFFFF`` after every step.  Products are split into
16-bit halves of the constant so no intermediate exceeds 2^48 and no
int64 overflow happens.  These are the arithmetic of the plain
versions in ``ops/kernels.py``.  On a CUDA batch a key tuple is hashed
by the hand-written K1 kernel, one launch per batch
(``kernels.hash_columns``), whose 32-bit hash values travel as int32 bit
patterns.

``md5(string)`` (``Md5``, the JAX package's K7, a jnp program there,
not a Pallas kernel) is plain torch over the same int64 lanes masked to
32 bits: each row's bytes padded as MD5 pads them (0x80, zeros, the
64-bit little-endian bit length at the end of the row's last block),
read as little-endian words, every block of the widest row run for
every row (a row folds a block into its state only while the block is
one of its own), 64 rounds a block, and the digest's 16 bytes
written as 32 lowercase hex characters.  NULL in, NULL out.  In eager
torch that is about a dozen elementwise launches a round, some 800 a
64-byte block (``PERF.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import (
    AnyColumn,
    Column,
    StringColumn,
)
from spark_rapids_tpu_torch.exprs.base import EvalContext, Expression
from spark_rapids_tpu_torch.ops import kernels

MASK32 = 0xFFFFFFFF
C1 = 0xCC9E2D51
C2 = 0x1B873593
DEFAULT_SEED = 42


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return mul32(rotl32(mul32(k1, C1), 15), C2)


def mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = rotl32(h1 ^ k1, 13)
    return (mul32(h1, 5) + 0xE6546B64) & MASK32


def fmix(h1: torch.Tensor, length) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = mul32(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def hash_int32_block(word: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Murmur3 of one 4-byte value (Spark hashInt)."""
    return fmix(mix_h1(seed, mix_k1(word.long() & MASK32)), 4)


def hash_int64_blocks(value: torch.Tensor,
                      seed: torch.Tensor) -> torch.Tensor:
    """Murmur3 of an 8-byte value, low word first (Spark hashLong)."""
    v = value.long()
    h1 = mix_h1(seed, mix_k1(v & MASK32))
    h1 = mix_h1(h1, mix_k1((v >> 32) & MASK32))
    return fmix(h1, 8)


def _double_to_bits(x: torch.Tensor) -> torch.Tensor:
    """Java doubleToLongBits with -0.0 folded into 0.0 first, as Spark
    normalizes before hashing; every NaN is 0x7ff8000000000000."""
    x = torch.where(x == 0.0, torch.zeros_like(x), x)
    bits = x.contiguous().view(torch.int64)
    return torch.where(torch.isnan(x),
                       torch.full_like(bits, 0x7FF8000000000000), bits)


def _float_to_bits(x: torch.Tensor) -> torch.Tensor:
    """Java floatToIntBits with -0.0 folded into 0.0 first; every NaN is
    0x7fc00000."""
    x = torch.where(x == 0.0, torch.zeros_like(x), x)
    bits = x.contiguous().view(torch.int32)
    return torch.where(torch.isnan(x),
                       torch.full_like(bits, 0x7FC00000), bits)


def to_int32_bits(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return (u - ((u >> 31) << 32)).to(torch.int32)


def from_int32_bits(s: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return s.long() & MASK32


# --------------------------------------------------------------------- #
# Host (numpy) mirrors of the fixed-width block hashes: the runtime
# filter's probe (plan/runtime_filter.py) hashes freshly decoded scan
# columns on the host, and must agree bit for bit with the Bloom bits K1
# set on the device.  numpy uint32 arithmetic wraps as uint32 should.
# --------------------------------------------------------------------- #


def _np_mix(h1: np.ndarray, k1: np.ndarray) -> np.ndarray:
    k1 = k1 * np.uint32(C1)
    k1 = (k1 << np.uint32(15)) | (k1 >> np.uint32(17))
    k1 = k1 * np.uint32(C2)
    h1 = h1 ^ k1
    h1 = (h1 << np.uint32(13)) | (h1 >> np.uint32(19))
    return h1 * np.uint32(5) + np.uint32(0xE6546B64)


def _np_fmix(h1: np.ndarray, length: int) -> np.ndarray:
    h1 = h1 ^ np.uint32(length)
    h1 = h1 ^ (h1 >> np.uint32(16))
    h1 = h1 * np.uint32(0x85EBCA6B)
    h1 = h1 ^ (h1 >> np.uint32(13))
    h1 = h1 * np.uint32(0xC2B2AE35)
    return h1 ^ (h1 >> np.uint32(16))


def np_hash_int32_block(word, seed) -> np.ndarray:
    """uint32[n] Murmur3 of 4-byte values (Spark hashInt), in numpy."""
    k1 = np.asarray(word).astype(np.int32).view(np.uint32)
    h1 = np.full(k1.shape, seed & MASK32, np.uint32)
    return _np_fmix(_np_mix(h1, k1), 4)


def np_hash_int64_blocks(value, seed) -> np.ndarray:
    """uint32[n] Murmur3 of 8-byte values, low word first (Spark
    hashLong), in numpy."""
    v = np.asarray(value).astype(np.int64).view(np.uint64)
    h1 = np.full(v.shape, seed & MASK32, np.uint32)
    h1 = _np_mix(h1, (v & np.uint64(MASK32)).astype(np.uint32))
    h1 = _np_mix(h1, (v >> np.uint64(32)).astype(np.uint32))
    return _np_fmix(h1, 8)


def hash_string_bytes(chars: torch.Tensor, lengths: torch.Tensor,
                      seed: torch.Tensor) -> torch.Tensor:
    """Spark hashUnsafeBytes over a fixed-width ``(N, W)`` uint8 byte
    matrix with per-row seeds (int64 in [0, 2^32)); returns int64 hashes
    in [0, 2^32).  This is K1: on a CUDA tensor it launches the Hopper
    kernel, on a CPU tensor it runs the kernel's plain version."""
    seeds = to_int32_bits(seed.expand(chars.shape[0]))
    out = kernels.hash_string(chars.contiguous(),
                              lengths.to(torch.int32).contiguous(),
                              seeds.contiguous())
    return from_int32_bits(out)


def hash_columns(cols: Sequence[AnyColumn], num_rows: int,
                 device: torch.device,
                 seed: int = DEFAULT_SEED) -> torch.Tensor:
    """Chained multi-column Spark hash -> int32 (Spark ``hash(...)``)."""
    return kernels.hash_columns(cols, num_rows, device, seed)


class Murmur3Hash(Expression):
    """SQL hash(exprs...): a non-null INT."""

    def __init__(self, *exprs: Expression, seed: int = DEFAULT_SEED):
        self.exprs = tuple(exprs)
        self.seed = seed

    @property
    def children(self) -> tuple[Expression, ...]:
        return self.exprs

    def with_children(self, children) -> "Murmur3Hash":
        return Murmur3Hash(*children, seed=self.seed)

    @property
    def dtype(self) -> T.DataType:
        return T.INT

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: EvalContext) -> Column:
        cols = [e.eval(ctx) for e in self.exprs]
        b = ctx.batch
        h = hash_columns(cols, b.num_rows, b.device, self.seed)
        return Column(h, torch.ones_like(h, dtype=torch.bool), T.INT)


def partition_ids(cols: Sequence[AnyColumn], num_rows: int,
                  device: torch.device, num_partitions: int) -> torch.Tensor:
    """Spark hash partitioning: pmod(hash(keys), n) -> int64 in [0, n)."""
    return kernels.hash_columns(cols, num_rows, device,
                                num_partitions=num_partitions)


# --------------------------------------------------------------------- #
# MD5
# --------------------------------------------------------------------- #

_MD5_K = tuple(int(abs(np.sin(i + 1)) * (1 << 32)) & MASK32
               for i in range(64))
_MD5_S = (7, 12, 17, 22) * 4 + (5, 9, 14, 20) * 4 \
    + (4, 11, 16, 23) * 4 + (6, 10, 15, 21) * 4
_MD5_G = tuple(i if i < 16 else (5 * i + 1) % 16 if i < 32
               else (3 * i + 5) % 16 if i < 48 else (7 * i) % 16
               for i in range(64))
_MD5_INIT = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)
_HEX = b"0123456789abcdef"


def md5_string_bytes(chars: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Each row's MD5 over its first ``lengths`` bytes of ``chars``:
    (N, 32) uint8 lowercase hex."""
    n, w = chars.shape
    dev = chars.device
    blocks = (w + 9 + 63) // 64
    length = lengths.to(torch.int64)
    msg = torch.nn.functional.pad(chars, (0, blocks * 64 - w)) \
        .to(torch.int64)
    cols = torch.arange(blocks * 64, device=dev)[None, :]
    msg = torch.where(cols < length[:, None], msg, 0)
    msg = torch.where(cols == length[:, None], 0x80, msg)
    row_blocks = (length + 9 + 63) // 64
    at = (row_blocks * 64 - 8)[:, None]
    bitlen = (length * 8)[:, None]
    for k in range(8):
        msg = torch.where(cols == at + k, (bitlen >> (8 * k)) & 0xFF, msg)
    b = msg.view(n, blocks, 16, 4)
    words = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) \
        | (b[..., 3] << 24)
    k_t = torch.tensor(_MD5_K, dtype=torch.int64, device=dev)
    g_t = torch.tensor(_MD5_G, dtype=torch.int64, device=dev)
    state = [torch.full((n,), v, dtype=torch.int64, device=dev)
             for v in _MD5_INIT]
    for blk in range(blocks):
        mk = words[:, blk, :][:, g_t] + k_t  # each round's word + K
        a, bb, c, d = state
        for i in range(64):
            if i < 16:
                f = d ^ (bb & (c ^ d))
            elif i < 32:
                f = c ^ (d & (bb ^ c))
            elif i < 48:
                f = bb ^ c ^ d
            else:
                f = c ^ (bb | (d ^ MASK32))
            t = (a + f + mk[:, i]) & MASK32
            s_ = _MD5_S[i]
            a, d, c = d, c, bb
            bb = (bb + (((t << s_) & MASK32) | (t >> (32 - s_)))) & MASK32
        active = blk < row_blocks
        state = [torch.where(active, (s0 + v) & MASK32, s0)
                 for s0, v in zip(state, (a, bb, c, d))]
    digest = torch.stack(state, dim=1)  # (N, 4) little-endian words
    dbytes = torch.stack([(digest >> (8 * k)) & 0xFF for k in range(4)],
                         dim=2).reshape(n, 16)
    lut = torch.tensor(list(_HEX), dtype=torch.uint8, device=dev)
    return torch.stack([lut[dbytes >> 4], lut[dbytes & 0xF]],
                       dim=2).reshape(n, 32)


@dataclasses.dataclass(repr=False)
class Md5(Expression):
    """md5(string): the lowercase hex digest of the UTF-8 bytes."""

    child: Expression

    @property
    def dtype(self) -> T.DataType:
        return T.STRING

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = self.child.eval(ctx)
        if not isinstance(c, StringColumn):
            raise TypeError(f"md5 needs a STRING input, got {c.dtype}")
        valid = c.validity
        hexed = md5_string_bytes(c.chars, c.lengths)
        return StringColumn(hexed * valid[:, None].to(torch.uint8),
                            torch.where(valid, 32, 0).to(torch.int32),
                            valid)
