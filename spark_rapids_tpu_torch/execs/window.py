"""Window exec: every window column of one (partition_by, order_by)
group over one sort of its input.

Counterpart of ``TpuWindowExec`` in ``spark_rapids_tpu/execs/window.py``.
A batch is sorted once by (partition keys, order keys) through
``ops/sort.py``; partition starts and peer starts come from adjacent
grouping keys, and each window column from the segmented primitives of
``ops/window.py``.  Output rows come in that sorted order (SQL leaves a
window's output order unspecified, as Spark does).

With ``partitioned`` set, the planner has put a hash exchange on the
partition keys (or found the child already distributed so): each
reduce partition holds whole window partitions and is windowed alone,
and an empty reduce partition yields nothing.  Otherwise every child
partition is drained into one batch.

Peer and partition equality is SQL grouping equality, which
``column_sort_keys(grouping=True)`` with ``group_starts`` gives: NULL
equals NULL, NaN equals NaN, and -0.0 equals 0.0 (IEEE ``==``, as the
JAX package's ``_keys_equal_adjacent``); the sort itself keeps -0.0
just below 0.0, so the two are adjacent.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    concat_batches,
)
from spark_rapids_tpu_torch.columnar.column import AnyColumn, Column
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.execs.sort import describe_keys
from spark_rapids_tpu_torch.exprs.aggregates import (
    Average,
    Count,
    CountStar,
    Sum,
)
from spark_rapids_tpu_torch.exprs.base import EvalContext
from spark_rapids_tpu_torch.exprs.window import (
    DenseRank,
    Lead,
    Rank,
    RowNumber,
    WindowAgg,
    WindowExpression,
)
from spark_rapids_tpu_torch.ops import window as W
from spark_rapids_tpu_torch.ops.groupby import _sum_dtype
from spark_rapids_tpu_torch.ops.sort import (
    SortOrder,
    column_sort_keys,
    group_starts,
    sort_permutation,
)


class TpuWindowExec(TpuExec):
    def __init__(self, window_exprs: Sequence[tuple[WindowExpression, str]],
                 child: TpuExec, partitioned: bool = False):
        super().__init__(child)
        if not window_exprs:
            raise ValueError("a window exec needs window expressions")
        self.named = [(we.bind(child.schema), name)
                      for we, name in window_exprs]
        spec0 = self.named[0][0].spec
        for we, _ in self.named:
            if (we.spec.partition_by, we.spec.order_by) != \
                    (spec0.partition_by, spec0.order_by):
                raise ValueError("one TpuWindowExec computes one "
                                 "(partition_by, order_by) group")
            we.check_supported()
        self.spec = spec0
        #: the child is distributed on the partition keys: each of its
        #: partitions is windowed alone
        self.partitioned = partitioned
        self._schema = T.Schema(
            list(child.schema.fields)
            + [T.Field(name, we.dtype, we.nullable)
               for we, name in self.named])

    @property
    def schema(self) -> T.Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return self.children[0].num_partitions if self.partitioned else 1

    def node_desc(self) -> str:
        fns = ", ".join(f"{we.fn.describe()}->{n}" for we, n in self.named)
        parts = ", ".join(e.name for e in self.spec.partition_by)
        tag = " [per-partition]" if self.partitioned else ""
        return (f"TpuWindowExec [{fns}] partition by [{parts}] order by "
                f"[{describe_keys(self.spec.order_by)}]{tag}")

    def _window_batch(self, batch: ColumnarBatch) -> ColumnarBatch:
        spec = self.spec
        ctx = EvalContext.for_batch(batch)
        pkeys = [e.eval(ctx) for e in spec.partition_by]
        okeys = [k.expr.eval(ctx) for k in spec.order_by]
        key_schema = T.Schema(
            [T.Field(f"__pk{i}", e.dtype)
             for i, e in enumerate(spec.partition_by)]
            + [T.Field(f"__ok{i}", k.expr.dtype)
               for i, k in enumerate(spec.order_by)])
        keys = ColumnarBatch(pkeys + okeys, batch.num_rows, key_schema,
                             batch.device)
        orders = [SortOrder(i) for i in range(len(pkeys))] + [
            SortOrder(len(pkeys) + i, k.descending, k.nulls_last)
            for i, k in enumerate(spec.order_by)]
        perm = sort_permutation(keys, orders)

        def starts(cols):
            return group_starts([k for c in cols
                                 for k in column_sort_keys(c, grouping=True)],
                                perm)

        is_start = starts(pkeys)
        peer_start = is_start | starts(okeys)
        start_idx, end_idx = W.segment_positions(is_start)
        _, peer_end = W.segment_positions(peer_start)

        sbatch = batch.gather(perm)
        sctx = EvalContext.for_batch(sbatch)
        sokeys = [c.gather(perm) for c in okeys]
        out: list[AnyColumn] = list(sbatch.columns)
        for we, _ in self.named:
            out.append(self._eval_window_fn(
                we, sctx, is_start, peer_start, start_idx, end_idx,
                peer_end, sokeys))
        return ColumnarBatch(out, sbatch.num_rows, self._schema,
                             batch.device)

    def _eval_window_fn(self, we: WindowExpression, sctx: EvalContext,
                        is_start, peer_start, start_idx, end_idx, peer_end,
                        sokeys) -> AnyColumn:
        fn = we.fn
        n = start_idx.shape[0]
        idx = torch.arange(n, device=start_idx.device)
        all_valid = torch.ones(n, dtype=torch.bool, device=idx.device)
        if isinstance(fn, RowNumber):
            return Column(idx - start_idx + 1, all_valid, T.LONG)
        if isinstance(fn, DenseRank):
            d = torch.cumsum(peer_start.long(), 0)
            return Column(d - d[start_idx] + 1, all_valid, T.LONG)
        if isinstance(fn, Rank):
            first_peer = torch.cummax(torch.where(peer_start, idx, 0),
                                      0).values
            return Column(first_peer - start_idx + 1, all_valid, T.LONG)
        if isinstance(fn, Lead):  # Lag subclasses Lead
            col = fn.child.eval(sctx)
            g, ok = W.gather_in_segment(col, fn.shift, start_idx, end_idx)
            if fn.default is None:
                return g
            dflt = fn.default.eval(sctx)
            data = torch.where(ok, g.data, dflt.data.to(g.data.dtype))
            return Column(data, torch.where(ok, g.validity, dflt.validity),
                          col.dtype)
        return self._eval_window_agg(fn, we, sctx, is_start, start_idx,
                                     end_idx, peer_start, peer_end, sokeys)

    def _eval_window_agg(self, fn: WindowAgg, we: WindowExpression, sctx,
                         is_start, start_idx, end_idx, peer_start, peer_end,
                         sokeys) -> Column:
        frame = we.spec.resolved_frame()
        if frame.mode == "rows":
            lo, hi = W.frame_bounds(start_idx, end_idx, frame.start,
                                    frame.end)
        elif frame.start is None and frame.end in (None, 0):
            # unbounded preceding .. the current peer group or the end
            lo = start_idx
            hi = end_idx if frame.end is None else peer_end
        else:  # a bounded value range over the one order key
            k = we.spec.order_by[0]
            lo, hi = W.range_frame_bounds(
                sokeys[0], k.descending, not k.nulls_last, frame.start,
                frame.end, start_idx, end_idx, peer_start, peer_end)
        agg = fn.agg
        all_valid = torch.ones_like(is_start)
        if isinstance(agg, CountStar):
            return Column((hi - lo + 1).clamp(min=0), all_valid, T.LONG)
        vcol = agg.inputs()[0].eval(sctx)
        if isinstance(agg, Count):
            _, n = W.windowed_sum_count(vcol, lo, hi, T.LONG)
            return Column(n, all_valid, T.LONG)
        if isinstance(agg, Sum):
            out_dtype = _sum_dtype(vcol.dtype)
            s, n = W.windowed_sum_count(vcol, lo, hi, out_dtype)
            return Column(s, n > 0, out_dtype)
        if isinstance(agg, Average):
            s, n = W.windowed_sum_count(vcol, lo, hi, T.DOUBLE)
            return Column(s / n.clamp(min=1).double(), n > 0, T.DOUBLE)
        out, nonempty = W.windowed_minmax(vcol, agg.op, is_start, lo, hi,
                                          anchored_start=frame.start is None)
        return Column(out, nonempty, vcol.dtype)

    def _window_source(self, source: Iterable[ColumnarBatch]
                       ) -> Iterator[ColumnarBatch]:
        parts = [b for b in source if b.num_rows]
        if parts:
            yield self._window_batch(concat_batches(parts))

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        if self.partitioned:
            yield from self._window_source(
                self.children[0].execute_partition(p))
        elif p == 0:
            yield from self._window_source(self.children[0].execute())
