"""Output partitioners.

Counterpart of ``spark_rapids_tpu/ops/partition.py``: a partitioner
gives per-row partition ids, and ``split_batch`` groups the rows by id
with one stable sort and slices out one batch per destination.  Hash
partitioning is murmur3-pmod, so a row lands on the partition Spark's
CPU would send it to.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exprs.base import (
    EvalContext,
    Expression,
    bind_references,
)
from spark_rapids_tpu_torch.exprs.hashing import partition_ids


@dataclasses.dataclass
class HashPartitioning:
    exprs: Sequence[Expression]
    num_partitions: int

    def bind(self, schema: T.Schema) -> "HashPartitioning":
        return HashPartitioning(
            [bind_references(e, schema) for e in self.exprs],
            self.num_partitions)

    def partition_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        ctx = EvalContext.for_batch(batch)
        cols = [e.eval(ctx) for e in self.exprs]
        return partition_ids(cols, batch.num_rows, batch.device,
                             self.num_partitions)

    def describe(self) -> str:
        return (f"hashpartitioning({', '.join(e.name for e in self.exprs)},"
                f" {self.num_partitions})")


def split_batch(batch: ColumnarBatch, pids: torch.Tensor,
                n_parts: int) -> list[ColumnarBatch]:
    """Group rows by partition id (stable) and slice one batch per
    partition; one sizing sync for the per-partition counts."""
    if n_parts == 1:
        return [batch]
    order = torch.sort(pids, stable=True).indices
    grouped = batch.gather(order)
    counts = torch.bincount(pids, minlength=n_parts).tolist()
    out, off = [], 0
    for cnt in counts:
        out.append(grouped.slice(off, off + cnt))
        off += cnt
    return out
