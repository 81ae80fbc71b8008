"""Range partitioning: sample -> bounds -> each row's bucket.

Counterpart of ``spark_rapids_tpu/ops/range_partition.py``, as the
range exchange of a multi-partition ORDER BY uses it.  Rows compare
with the bounds through the total-order int64 keys of ``ops/sort.py``
(``column_sort_keys``: NULL placement flag, then the value keys), so a
"bound < row" test is a short lexicographic compare and a row's bucket
is the number of bounds below it.  The bounds come from sorting the
pooled sample once and taking evenly spaced rows.
"""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import StringColumn
from spark_rapids_tpu_torch.ops.sort import (
    SortOrder,
    column_sort_keys,
    sort_batch,
)


def row_lex_keys(batch: ColumnarBatch,
                 orders: Sequence[SortOrder]) -> list[torch.Tensor]:
    """int64 keys, most significant first, whose ascending
    lexicographic order is the SQL ORDER BY ``orders``."""
    return [k for o in orders
            for k in column_sort_keys(batch.columns[o.ordinal],
                                      o.descending, o.nulls_last)]


def _lex_less(a_keys: Sequence[torch.Tensor],
              b_keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Elementwise ``a < b`` over parallel most-significant-first keys."""
    lt = torch.zeros(torch.broadcast_shapes(a_keys[0].shape,
                                            b_keys[0].shape),
                     dtype=torch.bool, device=b_keys[0].device)
    decided = torch.zeros_like(lt)
    for a, b in zip(a_keys, b_keys):
        lt = lt | (~decided & (a < b))
        decided = decided | (a != b)
    return lt


def choose_bounds(samples: ColumnarBatch, orders: Sequence[SortOrder],
                  n_parts: int) -> ColumnarBatch:
    """Sort the pooled sample and take ``n_parts - 1`` evenly spaced rows
    as range bounds (fewer rows: none when the sample is empty)."""
    if n_parts < 1:
        raise ValueError(f"{n_parts} range partitions")
    s = sort_batch(samples, orders)
    n_live, n_bounds = s.num_rows, n_parts - 1
    if n_live == 0 or n_bounds == 0:
        return s.slice_prefix(0)
    ranks = ((torch.arange(1, n_bounds + 1) * n_live) // n_parts).clamp(
        max=n_live - 1)
    return s.gather(ranks.to(s.device))


def _same_width(a: ColumnarBatch, b: ColumnarBatch,
                orders: Sequence[SortOrder]
                ) -> tuple[ColumnarBatch, ColumnarBatch]:
    """The key columns of both batches with each string key widened to
    the wider of the two, so that both give the same number of keys."""
    ac, bc = list(a.columns), list(b.columns)
    for o in orders:
        x, y = ac[o.ordinal], bc[o.ordinal]
        if isinstance(x, StringColumn):
            w = max(x.width, y.width)
            ac[o.ordinal], bc[o.ordinal] = x.with_width(w), y.with_width(w)
    return a.with_columns(ac, a.schema), b.with_columns(bc, b.schema)


def bucket_ids(batch: ColumnarBatch, bounds: ColumnarBatch,
               orders: Sequence[SortOrder]) -> torch.Tensor:
    """Per row, its partition id in [0, bounds.num_rows]: the number of
    bounds strictly less than the row, so a row equal to a bound goes
    to the bound's left bucket."""
    pid = torch.zeros(batch.num_rows, dtype=torch.int64, device=batch.device)
    if bounds.num_rows == 0:
        return pid
    batch, bounds = _same_width(batch, bounds, orders)
    row_keys = row_lex_keys(batch, orders)
    bound_keys = row_lex_keys(bounds, orders)
    for i in range(bounds.num_rows):
        pid += _lex_less([bk[i] for bk in bound_keys], row_keys).long()
    return pid
