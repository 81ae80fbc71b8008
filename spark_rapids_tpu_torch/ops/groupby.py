"""Group-by aggregation.

Counterpart of ``spark_rapids_tpu/ops/groupby.py``.  Two paths, as
there:

- the sort path (``groupby_aggregate``): the key columns' grouping
  keys sorted by ``ops/sort.py``'s lexicographic sort, segment starts
  where adjacent keys differ, and segment reductions with
  ``index_add_``;
- the coded path (``_coded_groupby``): when every key column carries a
  dictionary sidecar and the combined domain is small, each row's
  combined code IS its group id and no sort runs.

Aggregations are (update, merge) op pairs as Spark's aggregate modes
use them.  The slice ports the ops its aggregates need (``GROUPBY_OPS``).
Output batches hold one row per group.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_batch
from spark_rapids_tpu_torch.columnar.column import (
    AnyColumn,
    Column,
    StringColumn,
)
from spark_rapids_tpu_torch.ops.sort import (
    column_sort_keys,
    group_starts,
    lexsort,
)


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One aggregation over a value ordinal; ``op`` in {sum, count,
    count_star}.  avg is planned as sum + count and finalized by the
    exec."""

    op: str
    ordinal: int  # ignored for count_star
    out_dtype: Optional[T.DataType] = None


#: the aggregate ops a group-by evaluates; min and max are not ported
GROUPBY_OPS = ("sum", "count", "count_star")


def _sum_dtype(dt: T.DataType) -> T.DataType:
    return T.DOUBLE if isinstance(dt, T.DoubleType) else T.LONG


def agg_output_dtype(spec: AggSpec, value_dtype: Optional[T.DataType]
                     ) -> T.DataType:
    if spec.out_dtype is not None:
        return spec.out_dtype
    if spec.op in ("count", "count_star"):
        return T.LONG
    if spec.op == "sum":
        assert value_dtype is not None
        return _sum_dtype(value_dtype)
    raise NotImplementedError(f"aggregate op {spec.op} is not ported yet")


#: widest combined (dictionary + NULL) key domain the coded path takes
MAX_CODED_DOMAIN = 1 << 17


def _coded_key_domains(key_cols: Sequence[AnyColumn]) -> Optional[list[int]]:
    """Per-key dictionary sizes when every key column carries a
    dictionary sidecar and the combined domain is small, else None."""
    ks: list[int] = []
    total = 1
    for kc in key_cols:
        if kc.codes is None:
            return None
        if isinstance(kc, StringColumn):
            k = int(kc.dict_chars.shape[0])
        else:
            if isinstance(kc.dtype, T.DoubleType):
                # a Parquet dictionary may hold -0.0 and 0.0 (or two NaN
                # payloads) as distinct entries; raw codes would split
                # groups SQL merges, so float keys take the sort path
                return None
            k = int(kc.dict_values.shape[0])
        ks.append(k)
        total *= k + 1  # +1: the NULL group rides past the dictionary
        if total > MAX_CODED_DOMAIN:
            return None
    return ks


def _eval_agg(spec: AggSpec, batch: ColumnarBatch, gid: torch.Tensor,
              n_groups: int) -> Column:
    """One aggregation as segment sums: ``gid[row]`` in [0, n_groups)."""
    dev = batch.device
    all_valid = torch.ones(n_groups, dtype=torch.bool, device=dev)
    if spec.op == "count_star":
        counts = torch.zeros(n_groups, dtype=torch.int64, device=dev)
        counts.index_add_(0, gid, torch.ones_like(gid))
        return Column(counts, all_valid, T.LONG)
    vcol = batch.columns[spec.ordinal]
    valid = vcol.validity
    nvalid = torch.zeros(n_groups, dtype=torch.int64, device=dev)
    nvalid.index_add_(0, gid, valid.long())
    if spec.op == "count":
        return Column(nvalid, all_valid, T.LONG)
    if spec.op != "sum":
        raise NotImplementedError(f"aggregate op {spec.op} is not ported yet")
    assert isinstance(vcol, Column), f"sum over {vcol.dtype}"
    out_dtype = agg_output_dtype(spec, vcol.dtype)
    phys = T.to_torch_dtype(out_dtype)
    vals = torch.where(valid, vcol.data.to(phys),
                       torch.zeros((), dtype=phys, device=dev))
    sums = torch.zeros(n_groups, dtype=phys, device=dev)
    sums.index_add_(0, gid, vals)
    return Column(sums, nvalid > 0, out_dtype)


def _coded_groupby(batch: ColumnarBatch, key_ordinals: Sequence[int],
                   ks: list[int], aggs: Sequence[AggSpec],
                   out_schema: T.Schema) -> ColumnarBatch:
    """Sort-free group-by over dictionary codes: the combined code is a
    dense segment id; occupied segments become the groups, in code
    order."""
    dev = batch.device
    key_cols = [batch.columns[o] for o in key_ordinals]
    n_seg = 1
    seg = torch.zeros(batch.num_rows, dtype=torch.int64, device=dev)
    for kc, k in zip(key_cols, ks):
        pid = torch.where(kc.validity, kc.codes.long().clamp(0, k - 1), k)
        seg = seg * (k + 1) + pid
        n_seg *= k + 1
    occupancy = torch.zeros(n_seg, dtype=torch.int64, device=dev)
    occupancy.index_add_(0, seg, torch.ones_like(seg))
    occupied = torch.nonzero(occupancy).squeeze(1)  # segment ids, ascending
    n_groups = int(occupied.shape[0])
    remap = torch.zeros(n_seg, dtype=torch.int64, device=dev)
    remap[occupied] = torch.arange(n_groups, device=dev)
    gid = remap[seg]

    # decode each group's segment id back into per-key dictionary ids
    key_ids: list[torch.Tensor] = []
    sid = occupied
    for k in reversed(ks):
        key_ids.append(sid % (k + 1))
        sid = sid // (k + 1)
    key_ids.reverse()
    out: list[AnyColumn] = []
    for kc, k, kid in zip(key_cols, ks, key_ids):
        valid = kid < k
        safe = kid.clamp(max=k - 1)
        if isinstance(kc, StringColumn):
            chars = kc.dict_chars[safe] * valid[:, None].to(torch.uint8)
            lengths = torch.where(valid, kc.dict_lens[safe], 0).to(
                torch.int32)
            out.append(StringColumn(chars, lengths, valid))
        else:
            out.append(Column(kc.dict_values[safe], valid, kc.dtype))
    out += [_eval_agg(spec, batch, gid, n_groups) for spec in aggs]
    return ColumnarBatch(out, n_groups, out_schema, dev)


def groupby_aggregate(batch: ColumnarBatch, key_ordinals: Sequence[int],
                      aggs: Sequence[AggSpec], out_schema: T.Schema,
                      live_mask: Optional[torch.Tensor] = None
                      ) -> ColumnarBatch:
    """One-batch group-by.  Output columns = keys ++ aggs, one row per
    group.  ``live_mask`` further restricts the rows (a WHERE folded
    into the aggregate)."""
    if live_mask is not None:
        batch = batch.compact(live_mask)
    if batch.num_rows == 0:
        return empty_batch(out_schema, batch.device)
    key_cols = [batch.columns[o] for o in key_ordinals]
    ks = _coded_key_domains(key_cols)
    if ks is not None:
        return _coded_groupby(batch, key_ordinals, ks, aggs, out_schema)
    keys = [k for kc in key_cols
            for k in column_sort_keys(kc, grouping=True)]
    perm = lexsort(keys)
    differs = group_starts(keys, perm)
    seg = torch.cumsum(differs.long(), 0) - 1
    starts = perm[torch.nonzero(differs).squeeze(1)]
    n_groups = int(starts.shape[0])
    gid = torch.empty_like(seg)
    gid[perm] = seg
    out: list[AnyColumn] = [kc.gather(starts) for kc in key_cols]
    out = [dataclasses.replace(c, codes=None) for c in out]
    out += [_eval_agg(spec, batch, gid, n_groups) for spec in aggs]
    return ColumnarBatch(out, n_groups, out_schema, batch.device)


def reduce_aggregate(batch: ColumnarBatch, aggs: Sequence[AggSpec],
                     out_schema: T.Schema,
                     live_mask: Optional[torch.Tensor] = None
                     ) -> ColumnarBatch:
    """Grand aggregate (no keys): exactly one output row."""
    if live_mask is not None:
        batch = batch.compact(live_mask)
    gid = torch.zeros(batch.num_rows, dtype=torch.int64, device=batch.device)
    cols = [_eval_agg(spec, batch, gid, 1) for spec in aggs]
    return ColumnarBatch(cols, 1, out_schema, batch.device)
