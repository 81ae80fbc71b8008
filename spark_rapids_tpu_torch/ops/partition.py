"""Output partitioners.

Counterpart of ``spark_rapids_tpu/ops/partition.py``: a partitioner
gives per-row partition ids, and ``split_batch`` groups the rows by id
with one stable sort and slices out one batch per destination.  Hash
partitioning is murmur3-pmod, so a row lands on the partition Spark's
CPU would send it to.  Range partitioning sends a row to the bucket of
sampled bounds its sort keys fall in, so partition order is sort order.
Round-robin partitioning deals rows out in turn from a start partition,
and single partitioning sends every row to partition 0: neither hashes,
so neither launches K1.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exprs.base import (
    EvalContext,
    Expression,
    bind_references,
)
from spark_rapids_tpu_torch.exprs.hashing import partition_ids
from spark_rapids_tpu_torch.ops.range_partition import bucket_ids
from spark_rapids_tpu_torch.ops.sort import SortOrder


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


@dataclasses.dataclass
class RangePartitioning:
    """Range partitioning for a multi-partition ORDER BY.  The bounds
    are sampled by the exchange's two-pass map stage; a row's id is its
    bucket among them (``ops/range_partition.py``)."""

    keys: Sequence  # of execs.sort.SortKey
    num_partitions: int

    def bind(self, schema: T.Schema) -> "RangePartitioning":
        return RangePartitioning(
            [dataclasses.replace(k, expr=bind_references(k.expr, schema))
             for k in self.keys], self.num_partitions)

    def key_batch(self, batch: ColumnarBatch) -> ColumnarBatch:
        """The sort keys evaluated into a batch of their own: samples
        and bounds live in this layout."""
        ctx = EvalContext.for_batch(batch)
        schema = T.Schema([T.Field(f"__rk{i}", k.expr.dtype)
                           for i, k in enumerate(self.keys)])
        return ColumnarBatch([k.expr.eval(ctx) for k in self.keys],
                             batch.num_rows, schema, batch.device)

    def key_orders(self) -> list[SortOrder]:
        return [SortOrder(i, k.descending, k.nulls_last)
                for i, k in enumerate(self.keys)]

    def partition_ids_with_bounds(self, batch: ColumnarBatch,
                                  bounds: ColumnarBatch) -> torch.Tensor:
        """``bounds``: a key-layout batch of at most num_partitions - 1
        rows."""
        return bucket_ids(self.key_batch(batch), bounds, self.key_orders())

    def describe(self) -> str:
        ks = ", ".join(f"{k.expr.name}{' DESC' if k.descending else ''}"
                       for k in self.keys)
        return f"rangepartitioning({ks}, {self.num_partitions})"


@dataclasses.dataclass
class RoundRobinPartitioning:
    """Row ``i`` of a batch goes to ``(i + start) % num_partitions``; the
    exchange gives each map task its own start."""

    num_partitions: int
    start: int = 0

    def bind(self, schema: T.Schema) -> "RoundRobinPartitioning":
        return self

    def partition_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        idx = torch.arange(batch.num_rows, dtype=torch.int64,
                           device=batch.device)
        return (idx + self.start) % self.num_partitions

    def describe(self) -> str:
        return f"roundrobin({self.num_partitions})"


@dataclasses.dataclass
class SinglePartitioning:
    """Every row to partition 0."""

    num_partitions: int = 1

    def bind(self, schema: T.Schema) -> "SinglePartitioning":
        return self

    def partition_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        return torch.zeros(batch.num_rows, dtype=torch.int64,
                           device=batch.device)

    def describe(self) -> str:
        return "single"


def split_batch_dispatch(batch: ColumnarBatch, pids: torch.Tensor,
                         n_parts: int) -> tuple[ColumnarBatch, torch.Tensor]:
    """Device half of ``split_batch``, no sync: the rows grouped by
    partition id (stable) and the per-partition counts, on the device.
    The sizing readback is the caller's, so a pipelined map loop can
    dispatch batch k+1 while batch k's counts are read."""
    order = torch.sort(pids, stable=True).indices
    return batch.gather(order), id_counts(pids, n_parts)


def id_counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Rows per id in [0, n), on the device and without a sync
    (``torch.bincount`` reads the ids' extremes back to size its
    output)."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device) \
        .scatter_add_(0, ids.long(), torch.ones_like(ids, dtype=torch.int64))


def split_batch_finish(grouped: ColumnarBatch, counts) -> list[ColumnarBatch]:
    """Slice one batch per partition once the counts are on the host
    (any host array-like, as ``device_read`` returns)."""
    out, off = [], 0
    for cnt in np.asarray(counts).tolist():
        out.append(grouped.slice(off, off + cnt))
        off += cnt
    return out


def split_batch(batch: ColumnarBatch, pids: torch.Tensor,
                n_parts: int) -> list[ColumnarBatch]:
    """Group rows by partition id (stable) and slice one batch per
    partition; one sizing readback (``exchange.split``) for the
    per-partition counts."""
    if n_parts == 1:
        return [batch]
    from spark_rapids_tpu_torch.parallel.pipeline import device_read

    grouped, counts = split_batch_dispatch(batch, pids, n_parts)
    return split_batch_finish(grouped,
                              device_read(counts, tag="exchange.split"))
