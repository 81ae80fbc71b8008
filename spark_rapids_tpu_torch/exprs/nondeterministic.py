"""Partition-context and nondeterministic expressions.

Counterpart of ``spark_rapids_tpu/exprs/nondeterministic.py``.  The
expressions carrying the ``PartitionAware`` marker read the
``EvalContext``'s ``partition_index`` and ``row_offset`` (the rows of
the partition the exec evaluated before this batch): the Project,
Filter, Expand and Generate execs pass them (``execs/basic.py``); every
other position keeps them 0, and the planner runs a plan with such an
expression there on the CPU engine, as the JAX planner does.

- ``spark_partition_id()``: the partition, an INT;
- ``monotonically_increasing_id()``: ``(partition << 33) + row_offset
  + position``, a LONG;
- ``rand(seed)``: a DOUBLE in [0, 1) that depends only on (seed,
  partition, the row's index in its partition), equal bit for bit to
  the JAX package's ``_rand_uniform``, which draws it with
  ``jax.random``'s threefry.  ``rand_uniform`` is that recipe in
  plain integer arithmetic on 64-bit lanes masked to 32 bits, so one
  function serves torch tensors (the device) and numpy arrays (the CPU
  engine, which uses no torch):

  - the key of ``seed`` is ``(seed >> 32, seed & 0xFFFFFFFF)``;
  - ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
  - a row's key is ``fold_in(fold_in(fold_in(key, partition),
    index >> 32), index & 0xFFFFFFFF)``;
  - its bits are ``hi << 32 | lo`` of ``threefry2x32(row key, (0, 0))``
    and the value is ``bits >> 12 | 0x3FF0000000000000`` as a float64,
    minus 1.0;
  - ``threefry2x32`` is the standard 20 rounds, rotations (13, 15, 26,
    6) / (17, 29, 16, 24), key parity ``0x1BD11BDA``.

  The folds that do not depend on the row (the seed's and the
  partition's, and the index's high word when the batch does not cross
  a multiple of 2^32) run on the host, in Python integers;

- ``input_file_name()``, ``input_file_block_start()`` and
  ``input_file_block_length()``: the planner rewrites them, over a
  chain of Project and Filter nodes down to a Parquet scan, into
  hidden per-file columns that scan appends (``plan/planner.py``,
  ``io/scan.py``); anywhere else ``check_supported`` raises and the CPU
  engine gives Spark's no-file defaults ('' and -1).
"""

from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import AnyColumn, Column
from spark_rapids_tpu_torch.exprs.base import EvalContext, Expression


class PartitionAware:
    """Marker: eval() reads ctx.partition_index / ctx.row_offset."""


def tree_is_partition_aware(e: Expression) -> bool:
    if isinstance(e, PartitionAware):
        return True
    return any(tree_is_partition_aware(c) for c in e.children)


@dataclasses.dataclass(repr=False)
class SparkPartitionID(Expression, PartitionAware):
    """spark_partition_id()."""

    @property
    def dtype(self) -> T.DataType:
        return T.INT

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: EvalContext) -> AnyColumn:
        n, dev = ctx.batch.num_rows, ctx.batch.device
        return Column(torch.full((n,), ctx.partition_index,
                                 dtype=torch.int32, device=dev),
                      torch.ones(n, dtype=torch.bool, device=dev), T.INT)


@dataclasses.dataclass(repr=False)
class MonotonicallyIncreasingID(Expression, PartitionAware):
    """monotonically_increasing_id(): the partition in the upper 31
    bits, the row's index in its partition in the lower 33."""

    @property
    def dtype(self) -> T.DataType:
        return T.LONG

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: EvalContext) -> AnyColumn:
        n, dev = ctx.batch.num_rows, ctx.batch.device
        first = (ctx.partition_index << 33) + ctx.row_offset
        return Column(torch.arange(first, first + n, dtype=torch.int64,
                                   device=dev),
                      torch.ones(n, dtype=torch.bool, device=dev), T.LONG)


_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds over 32-bit words held in 64-bit
    lanes (Python ints, numpy int64 arrays or torch int64 tensors, in
    any mix): the two output words, each in [0, 2^32)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _fold_in(key, data):
    return threefry2x32(key[0], key[1], 0, data)


def seed_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` as two words."""
    seed &= (1 << 64) - 1
    return seed >> 32, seed & _M32


def rand_bits(seed: int, partition: int, index, index_hi=None):
    """The 64 random bits of each row, as (hi, lo) words: ``index`` is
    the row's index in its partition (an int64 array or tensor), or its
    low word when ``index_hi``, the high word every row shares, is
    given."""
    key = _fold_in(seed_key(seed), partition & _M32)
    if index_hi is not None:
        key = _fold_in(key, index_hi)
        lo = index
    else:
        key = _fold_in(key, index >> 32)
        lo = index & _M32
    k0, k1 = _fold_in(key, lo)
    return threefry2x32(k0, k1, 0, 0)


def uniform_bits(hi, lo):
    """The float64 bit pattern of ``bits >> 12 | 1.0's exponent``, as
    int64: its value minus 1.0 is the uniform draw."""
    return (hi << 20) | (lo >> 12) | 0x3FF0000000000000


def rand_uniform(seed: int, partition: int, index):
    """The JAX package's ``_rand_uniform(seed, partition, index)`` over
    an int64 numpy array of row indices (the CPU engine's form)."""
    import numpy as np

    bits = uniform_bits(*rand_bits(seed, partition,
                                   np.asarray(index, np.int64)))
    return np.asarray(bits, np.int64).view(np.float64) - 1.0


@dataclasses.dataclass(repr=False)
class Rand(Expression, PartitionAware):
    """rand(seed): deterministic per (seed, partition, the row's index
    in its partition), whatever the batch boundaries."""

    seed: int = 0

    @property
    def dtype(self) -> T.DataType:
        return T.DOUBLE

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: EvalContext) -> AnyColumn:
        n, dev = ctx.batch.num_rows, ctx.batch.device
        first, last = ctx.row_offset, ctx.row_offset + max(n - 1, 0)
        if first >> 32 == last >> 32:  # one high word: folded on the host
            lo = torch.arange(first & _M32, (first & _M32) + n,
                              dtype=torch.int64, device=dev)
            hi, lo = rand_bits(self.seed, ctx.partition_index, lo,
                               index_hi=first >> 32)
        else:
            idx = torch.arange(first, first + n, dtype=torch.int64,
                               device=dev)
            hi, lo = rand_bits(self.seed, ctx.partition_index, idx)
        vals = uniform_bits(hi, lo).view(torch.float64) - 1.0
        return Column(vals, torch.ones(n, dtype=torch.bool, device=dev),
                      T.DOUBLE)


@dataclasses.dataclass(repr=False)
class InputFileName(Expression):
    """input_file_name(): the path of the file the row was read from.
    The planner rewrites it into the hidden column ``HIDDEN`` the scan
    appends; anywhere else it runs on the CPU engine, as ``DEFAULT``."""

    #: Spark's value when no file context exists
    DEFAULT = ""
    HIDDEN = "__input_file_name"

    @property
    def dtype(self) -> T.DataType:
        return T.STRING

    @property
    def nullable(self) -> bool:
        return False

    @property
    def name(self) -> str:
        return "input_file_name()"

    def check_supported(self) -> None:
        raise TypeError(
            "input_file_name() is only supported directly above a file "
            "scan (project/filter chain) — CPU fallback")

    def eval(self, ctx: EvalContext):
        raise AssertionError("rewritten by the planner before eval")


@dataclasses.dataclass(repr=False)
class InputFileBlockStart(InputFileName):
    """input_file_block_start(): a file is read as one split, so 0."""

    DEFAULT = -1
    HIDDEN = "__input_file_block_start"

    @property
    def dtype(self) -> T.DataType:
        return T.LONG

    @property
    def name(self) -> str:
        return "input_file_block_start()"


@dataclasses.dataclass(repr=False)
class InputFileBlockLength(InputFileName):
    """input_file_block_length(): the split is the whole file, so its
    size in bytes."""

    DEFAULT = -1
    HIDDEN = "__input_file_block_length"

    @property
    def dtype(self) -> T.DataType:
        return T.LONG

    @property
    def name(self) -> str:
        return "input_file_block_length()"


#: the hidden columns a scan appends for the input-file expressions
INPUT_FILE_EXPRS = (InputFileName, InputFileBlockStart, InputFileBlockLength)
INPUT_FILE_FIELDS = tuple(T.Field(c.HIDDEN, T.STRING if c is InputFileName
                                  else T.LONG, False)
                          for c in INPUT_FILE_EXPRS)
