"""collect_list / collect_set over one batch.

Counterpart of ``spark_rapids_tpu/ops/collect.py``.  The JAX package
sorts the rows by (keys, every collected value), counts each group's
kept elements, syncs the widest count to size a dense ``(groups,
max_len)`` result and scatters into it.  The result here is Arrow's
layout (``columnar/column.py``), so no width is needed: for each
collected value the rows are sorted by (keys, that value) through
``ops/sort.py``, NULL values are dropped (a set also drops each value
equal to the one before it in its group), the kept values compacted in
that order are the flat child, and the offsets are the cumulated count
of kept values per group.  One sizing sync (the group count) per value.

Semantics, as the JAX package's: NULLs are skipped; a group whose
values are all NULL gets an empty array, never NULL; a grand collect
over no rows is one empty array.  The elements come in ascending order
(-0.0 before 0.0, NaN last), so the port's arrays equal the JAX
device's element for element where it collects one value.  A set's
equality is grouping equality: NaN equals NaN and -0.0 equals 0.0, and
the set keeps the first (so -0.0 where both occur).  The JAX package
sorts by all the collected values at once, so its later arrays follow
the earlier values' order, and its sets after the first keep repeated
values that are not adjacent there (``ROADMAP.md`` section 3); each
value sorts on its own here.

Group keys sort in their total order and group by grouping equality, as
the JAX collect does: -0.0 and 0.0 keys, adjacent in the sort, make one
group whose key is its first row's.
"""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column, ListColumn
from spark_rapids_tpu_torch.ops.sort import (
    column_sort_keys,
    group_starts,
    lexsort,
)


def _collect_one(vcol: Column, kind: str, key_order: list,
                 key_groups: list, n: int):
    """(sorting permutation, group starts in sorted order, the array
    column) of one collected value."""
    dev = vcol.validity.device
    perm = lexsort(key_order + column_sort_keys(vcol))
    if key_groups:
        starts = group_starts(key_groups, perm)
    else:
        starts = torch.zeros(n, dtype=torch.bool, device=dev)
        starts[:1] = True
    vs = vcol.gather(perm)
    kept = vs.validity
    if kind == "set":
        same = ~group_starts(column_sort_keys(vs, grouping=True),
                             torch.arange(n, device=dev))
        kept = kept & (starts | ~same)
    gid = torch.cumsum(starts.to(torch.int64), 0) - 1
    n_groups = int(gid[-1]) + 1 if n else 0
    counts = torch.zeros(max(n_groups, 1 if not key_groups else 0),
                         dtype=torch.int64, device=dev)
    counts.index_add_(0, gid, kept.to(torch.int64))
    offsets = torch.zeros(len(counts) + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    at = torch.nonzero(kept).squeeze(1)
    child = Column(vs.data[at], vs.validity[at], vs.dtype)
    lists = ListColumn(offsets, child,
                       torch.ones(len(counts), dtype=torch.bool, device=dev),
                       T.ListType(vs.dtype))
    return perm, starts, lists


def collect(batch: ColumnarBatch, n_keys: int, kinds: Sequence[str],
            schema: T.Schema) -> ColumnarBatch:
    """``batch`` holds the group keys, then one value column per entry
    of ``kinds`` ("list" or "set"); the result is one row per group (a
    grand collect: always one row), the keys, then an array per value.
    Groups come in key order."""
    n = batch.num_rows
    keys = batch.columns[:n_keys]
    key_order = [k for c in keys for k in column_sort_keys(c)]
    key_groups = [k for c in keys for k in column_sort_keys(c, grouping=True)]
    out_keys: list = []
    lists = []
    for vi, kind in enumerate(kinds):
        perm, starts, lc = _collect_one(batch.columns[n_keys + vi], kind,
                                        key_order, key_groups, n)
        if vi == 0:
            first = perm[starts]
            out_keys = [c.gather(first) for c in keys]
        lists.append(lc)
    return ColumnarBatch(out_keys + lists, len(lists[0]), schema,
                         batch.device)
