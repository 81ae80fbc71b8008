"""Total-order sort keys and batch sorting.

Counterpart of ``spark_rapids_tpu/ops/sort.py``.  Every SQL sort key
maps to int64 key tensors whose ascending lexicographic order is the
SQL order; a stable lexicographic sort of those keys (one stable
``torch.sort`` per key, least significant first) gives the permutation.
Group-by, the join's dense key ranks and ORDER BY all sort here.

Key transforms:
- integers, dates, booleans, timestamps and decimals (int64
  microseconds and unscaled values): the value (descending: bitwise
  NOT, which reverses the order without overflow); a value of 32 bits
  or fewer shares one key with its NULL flag;
- floats and doubles (a float widened exactly): the IEEE bits as a
  signed integer in the float's total order, with every NaN the
  canonical NaN (above +inf, as Spark sorts it) and -0.0 strictly below
  0.0.  ``grouping=True`` folds -0.0 into
  0.0 instead, so that equal keys are exactly equal grouping values;
- strings: big-endian 7-byte chunks of the zero-padded byte matrix (7
  keeps every chunk non-negative, so the signed sort is the unsigned
  byte order), then the length, which orders "a" before "a\\0";
- NULLs: a leading flag key places them first or last; the value keys
  of a NULL row are zero, so NULLs tie and fall through to the next
  SQL key.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import AnyColumn, StringColumn

#: string bytes per int64 key
STRING_CHUNK = 7
CANONICAL_NAN_BITS = 0x7FF8000000000000


@dataclasses.dataclass(frozen=True)
class SortOrder:
    """One sort key: column ordinal, direction, NULL placement (Spark's
    default: ascending, NULLs first)."""

    ordinal: int
    descending: bool = False
    nulls_last: bool = False


def double_order_bits(x: torch.Tensor, grouping: bool = False
                      ) -> torch.Tensor:
    """float64 (or float32, widened exactly) -> int64 whose signed order
    is the float's total order, every NaN canonical; ``grouping`` folds
    -0.0 into 0.0."""
    x = x.to(torch.float64)
    if grouping:
        x = torch.where(x == 0, torch.zeros_like(x), x)
    bits = x.contiguous().view(torch.int64)
    bits = torch.where(torch.isnan(x),
                       torch.full_like(bits, CANONICAL_NAN_BITS), bits)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFFFFFFFFFF, bits)


def _string_chunk_keys(col: StringColumn) -> list[torch.Tensor]:
    n, width = col.chars.shape
    n_chunks = -(-width // STRING_CHUNK)
    c = col.chars.long() * col.validity[:, None].long()
    c = torch.nn.functional.pad(c, (0, n_chunks * STRING_CHUNK - width))
    shifts = torch.arange(8 * (STRING_CHUNK - 1), -1, -8, device=c.device)
    words = (c.view(n, n_chunks, STRING_CHUNK) << shifts).sum(-1)
    return list(words.unbind(1))


def column_sort_keys(col: AnyColumn, descending: bool = False,
                     nulls_last: bool = False,
                     grouping: bool = False) -> list[torch.Tensor]:
    """int64 keys of one SQL sort key, most significant first.  Equal
    keys <=> equal SQL grouping values (NULL == NULL, NaN == NaN; -0.0
    == 0.0 only with ``grouping``)."""
    valid = col.validity
    flag = (~valid if nulls_last else valid).long()  # 0 sorts first
    if isinstance(col, StringColumn):
        vals = _string_chunk_keys(col)
        vals.append(torch.where(valid, col.lengths.long(), 0))
        if descending:
            vals = [~v for v in vals]
        return [flag] + vals
    data = col.data
    if data.is_floating_point():
        k = double_order_bits(data, grouping)
    else:
        k = data.long()
    k = torch.where(valid, k, 0)
    if descending:
        k = ~k
    if data.element_size() <= 4 and not data.is_floating_point():
        # a 32-bit value and its flag share one key: one sort pass less
        return [(flag << 32) | (k + (1 << 31))]
    return [flag, k]


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation that sorts rows by ``keys`` (first most
    significant): stable sorts from the least significant key up."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def group_starts(keys: Sequence[torch.Tensor],
                 perm: torch.Tensor) -> torch.Tensor:
    """Per sorted position, True where the row's keys differ from the
    row before it (and at the first row): the starts of equal-key
    runs."""
    starts = torch.zeros(perm.shape[0], dtype=torch.bool, device=perm.device)
    starts[:1] = True
    for k in keys:
        ks = k[perm]
        starts[1:] |= ks[1:] != ks[:-1]
    return starts


def sort_permutation(batch: ColumnarBatch,
                     orders: Sequence[SortOrder]) -> torch.Tensor:
    """Stable permutation realising the SQL ORDER BY ``orders``."""
    keys = [k for o in orders
            for k in column_sort_keys(batch.columns[o.ordinal],
                                      o.descending, o.nulls_last)]
    return lexsort(keys)


def sort_batch(batch: ColumnarBatch,
               orders: Sequence[SortOrder]) -> ColumnarBatch:
    return batch.gather(sort_permutation(batch, orders))
