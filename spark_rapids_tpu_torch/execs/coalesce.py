"""Batch coalescing within a partition.

Counterpart of ``TpuCoalesceBatchesExec`` in
``spark_rapids_tpu/execs/coalesce.py`` (GpuCoalesceBatches in the
reference): consecutive batches of a partition are concatenated until
their rows reach ``sql.coalesce.targetRows`` or their device bytes
``sql.coalesce.targetBytes``, so the operator above runs over few large
batches instead of many small ones.  Each output made of several
batches keeps their row counts as ``coalesce_seams``; the OOM ladder's
``bisect_batch`` cuts at the seam nearest the middle, so a split walks
back down the producer's own batches.  Rows keep their order.

The planner puts one under every hash aggregate, hash join and sort
when ``sql.coalesce.enabled`` is on (off by default: every plan is
unchanged).  ``TpuCoalescePartitionsExec`` (the JAX module's other exec)
lives in ``execs/exchange.py``.
"""

from __future__ import annotations

from typing import Iterator

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    concat_batches,
)
from spark_rapids_tpu_torch.execs.base import Metrics, TpuExec
from spark_rapids_tpu_torch.memory.store import batch_device_bytes


class TpuCoalesceBatchesExec(TpuExec):
    def __init__(self, child: TpuExec,
                 target_rows: int = C.DEFAULTS[C.COALESCE_TARGET_ROWS],
                 target_bytes: int = C.DEFAULTS[C.COALESCE_TARGET_BYTES]):
        super().__init__(child)
        self.target_rows = target_rows
        self.target_bytes = target_bytes
        self.metrics = Metrics("numInputRows", "numInputBatches",
                               "numConcats")

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    @property
    def output_partitioning(self):
        return self.children[0].output_partitioning

    def node_desc(self) -> str:
        return (f"TpuCoalesceBatchesExec rows={self.target_rows} "
                f"bytes={self.target_bytes}")

    def _flush(self, buf: list[ColumnarBatch]) -> ColumnarBatch:
        if len(buf) == 1:
            return buf[0]
        out = concat_batches(buf)
        out.coalesce_seams = tuple(b.num_rows for b in buf)
        self.metrics.add("numConcats", 1)
        return out

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        buf: list[ColumnarBatch] = []
        rows = nbytes = 0
        for batch in self.children[0].execute_partition(p):
            self.metrics.add("numInputBatches", 1)
            self.metrics.add("numInputRows", batch.num_rows)
            buf.append(batch)
            rows += batch.num_rows
            nbytes += batch_device_bytes(batch)
            if rows >= self.target_rows or nbytes >= self.target_bytes:
                yield self._flush(buf)
                buf, rows, nbytes = [], 0, 0
        if buf:
            yield self._flush(buf)


def plan_coalesce(root: TpuExec, conf: C.TorchConf) -> list[str]:
    """With ``sql.coalesce.enabled``, put a TpuCoalesceBatchesExec under
    every hash aggregate, hash join and sort of the plan (the JAX
    planner's ``_plan_coalesce``); the insertion points, as
    ``"<node> <- coalesce(<child>)"``."""
    if not conf.get(C.COALESCE_ENABLED):
        return []
    from spark_rapids_tpu_torch.execs.aggregate import TpuHashAggregateExec
    from spark_rapids_tpu_torch.execs.fallback import CpuFallbackExec
    from spark_rapids_tpu_torch.execs.join import _HashJoinBase
    from spark_rapids_tpu_torch.execs.sort import _SortMixin

    lines = []
    for node in list(root.walk()):
        if not isinstance(node, (TpuHashAggregateExec, _HashJoinBase,
                                 _SortMixin)):
            continue
        for i, c in enumerate(list(node.children)):
            if isinstance(c, (TpuCoalesceBatchesExec, CpuFallbackExec)):
                continue
            node.children[i] = TpuCoalesceBatchesExec(
                c, conf.get(C.COALESCE_TARGET_ROWS),
                conf.get(C.COALESCE_TARGET_BYTES))
            lines.append(f"{node.name} <- coalesce({c.name})")
    return lines

