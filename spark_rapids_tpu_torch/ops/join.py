"""Equi-join core.

Counterpart of ``spark_rapids_tpu/ops/join.py``, with its design:

1. **Dense key ranks instead of a hash table**: the build side's and
   the stream side's key columns are concatenated and sorted together
   by the shared grouping sort (``ops/sort.py``); equal SQL keys (any
   column mix, strings included) get one dense group id, so key
   equality is integer equality: no collisions, no probing.
2. **Counts, an exclusive scan, then expansion**: a stream row has
   ``counts[gid]`` build matches; the exclusive scan of those counts is
   each stream row's first output slot, and any window
   ``[offset, offset + out_cap)`` of output pairs is filled by a
   ``searchsorted`` over the scan, so the exec bounds every output
   chunk.

Key equality is grouping equality: NULL keys never match (they are
left out of the counts and surface only through the outer-join paths),
NaN matches NaN and -0.0 matches 0.0.  Port batches hold their live
rows, so there are no dead-row flags and no capacity padding.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    concat_batches,
    null_batch,
)
from spark_rapids_tpu_torch.columnar.column import AnyColumn, Column
from spark_rapids_tpu_torch.ops.sort import (
    column_sort_keys,
    group_starts,
    lexsort,
)


def key_type(a: T.DataType, b: T.DataType) -> T.DataType:
    """The type two join keys compare in (Spark's implicit widening);
    TypeError when they do not compare."""
    ct = T.common_type(a, b)
    if ct is None:
        raise TypeError(f"join keys of types {a} and {b} do not compare")
    return ct


def _widen(col: AnyColumn, dtype: T.DataType) -> AnyColumn:
    if col.dtype == dtype:
        return col
    return Column(col.data.to(T.to_torch_dtype(dtype)), col.validity, dtype)


def _concat_key_cols(build: Sequence[AnyColumn],
                     stream: Sequence[AnyColumn]) -> list[AnyColumn]:
    """Each key column of the build side above its stream counterpart,
    both in their common type (strings widen to the wider side)."""
    types = [key_type(b.dtype, s.dtype) for b, s in zip(build, stream)]
    schema = T.Schema([T.Field(f"k{i}", t) for i, t in enumerate(types)])

    def batch(cols):
        cols = [_widen(c, t) for c, t in zip(cols, types)]
        return ColumnarBatch(cols, len(cols[0]), schema,
                             cols[0].validity.device)

    return concat_batches([batch(build), batch(stream)]).columns


def compute_gids(build_keys: Sequence[AnyColumn],
                 stream_keys: Sequence[AnyColumn]):
    """Dense rank over the union of both sides' keys.

    Returns (gid_b, gid_s, null_b, null_s, n_combined): int64 group ids
    in [0, n_combined) with equal ids for equal keys, and per-row flags
    of a NULL in any key column."""
    n_b = len(build_keys[0])
    combined = _concat_key_cols(build_keys, stream_keys)
    n_c = len(combined[0])
    keys = [k for c in combined for k in column_sort_keys(c, grouping=True)]
    perm = lexsort(keys)
    gid_sorted = torch.cumsum(group_starts(keys, perm).long(), 0) - 1
    gid = torch.empty_like(gid_sorted)
    gid[perm] = gid_sorted
    null = torch.zeros(n_c, dtype=torch.bool, device=gid.device)
    for c in combined:
        null |= ~c.validity
    return gid[:n_b], gid[n_b:], null[:n_b], null[n_b:], n_c


@dataclasses.dataclass
class JoinState:
    """What sizing and expansion share for one stream batch."""

    gid_s: torch.Tensor
    cnt_s: torch.Tensor  # output pairs per stream row (outer rows >= 1)
    matched_s: torch.Tensor
    cum_excl: torch.Tensor
    start_by_gid: torch.Tensor
    build_rows_sorted: torch.Tensor
    matched_b: torch.Tensor  # per build row (for full outer)

    @property
    def total(self) -> torch.Tensor:
        """Output pairs in all (a device scalar)."""
        return self.cnt_s.sum()


def _segment_counts(seg: torch.Tensor, n: int) -> torch.Tensor:
    """Rows per segment id in [0, n), without the host sync that
    ``torch.bincount`` makes on CUDA to size its output."""
    return torch.zeros(n, dtype=torch.int64, device=seg.device).index_add_(
        0, seg, torch.ones_like(seg))


def join_state(build_key_cols: Sequence[AnyColumn],
               stream_key_cols: Sequence[AnyColumn],
               join_type: str) -> JoinState:
    """``join_type`` "left_outer" or "full_outer" gives every unmatched
    stream row one output slot; any other type counts matches only."""
    gid_b, gid_s, null_b, null_s, n_c = compute_gids(build_key_cols,
                                                     stream_key_cols)
    joinable_b, joinable_s = ~null_b, ~null_s
    # segment n_c collects the NULL-keyed rows, and is dropped
    seg_b = torch.where(joinable_b, gid_b, n_c)
    counts = _segment_counts(seg_b, n_c + 1)[:n_c]
    starts = torch.cumsum(counts, 0) - counts
    # build rows in gid order, stably: the row at starts[g] + j is the
    # j-th build row with gid g
    build_sort = torch.sort(seg_b, stable=True).indices
    cnt = torch.where(joinable_s, counts[gid_s], 0)
    matched_s = cnt > 0
    if join_type in ("left_outer", "full_outer"):
        cnt = torch.where(matched_s, cnt, 1)
    cum = torch.cumsum(cnt, 0) - cnt
    stream_counts = _segment_counts(torch.where(joinable_s, gid_s, n_c),
                                    n_c + 1)
    matched_b = joinable_b & (stream_counts[gid_b] > 0)
    return JoinState(gid_s=gid_s, cnt_s=cnt, matched_s=matched_s,
                     cum_excl=cum, start_by_gid=starts,
                     build_rows_sorted=build_sort, matched_b=matched_b)


def expand_pairs(state: JoinState, out_cap: int, offset: int = 0):
    """(stream_idx, build_idx, pair_live, build_matched) for the output
    pairs [offset, offset + out_cap): the exec's chunk window.  Pairs
    past the total have ``pair_live`` False; an unmatched outer row's
    pair has ``build_matched`` False."""
    dev = state.cum_excl.device
    i = torch.arange(offset, offset + out_cap, device=dev)
    n_s = state.cum_excl.shape[0]
    s = torch.searchsorted(state.cum_excl, i, right=True) - 1
    s = s.clamp(0, max(n_s - 1, 0))
    pair_live = i < state.total
    if n_s == 0:
        zero = torch.zeros(out_cap, dtype=torch.int64, device=dev)
        return zero, zero, pair_live, pair_live
    j = i - state.cum_excl[s]
    matched = state.matched_s[s]
    n_b = state.build_rows_sorted.shape[0]
    if n_b == 0:
        return s, torch.zeros_like(s), pair_live, matched
    pos = (state.start_by_gid[state.gid_s[s]] + j).clamp(0, n_b - 1)
    return s, state.build_rows_sorted[pos], pair_live, matched


def gather_joined(build: ColumnarBatch, stream: ColumnarBatch,
                  s_idx: torch.Tensor, b_idx: torch.Tensor,
                  pair_live: torch.Tensor, matched: torch.Tensor,
                  out_schema: T.Schema,
                  stream_first: bool = True) -> ColumnarBatch:
    """The joined rows of one window: stream columns ++ build columns
    (or the reverse), NULL where a pair has no build row."""
    n = int(s_idx.shape[0])
    scols = [c.gather(s_idx, pair_live) for c in stream.columns]
    if build.num_rows == 0:
        bcols = null_batch(build.schema, n, build.device).columns
    else:
        bcols = [c.gather(b_idx, pair_live & matched)
                 for c in build.columns]
    cols = scols + bcols if stream_first else bcols + scols
    return ColumnarBatch(cols, n, out_schema, stream.device)
