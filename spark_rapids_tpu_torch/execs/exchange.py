"""Shuffle exchange and partition coalescing.

``TpuShuffleExchangeExec`` is the counterpart of the exec of the same
name in ``spark_rapids_tpu/execs/exchange.py``: the map stage gives
every child batch its partition ids, splits it, and commits the slices
to the session's shuffle manager; each reduce partition then reads its
blocks.  Map tasks run one after another.

- Hash partitioning: each map batch's key tuple is hashed to partition
  ids (murmur3-pmod) by one K1 launch.
- Range partitioning: bounds must exist before any batch is split, and
  they come from a sample of the whole input, so the map stage makes
  two passes.  Pass 1 drains every map task, parks its batches and
  samples ``samplesPerBatch`` rows (with replacement) from each; the
  bounds come from the pooled sample; pass 2 splits the parked batches
  by their rows' buckets.  The sample positions come from a
  ``numpy.random.Generator`` seeded with ``RANGE_SAMPLE_SEED``, as in
  the JAX package; the sorted output does not depend on them.  No K1
  launch.

``TpuCoalescePartitionsExec`` (``execs/coalesce.py`` there) pulls every
child partition into one, the "exchange" of a grand aggregate.
"""

from __future__ import annotations

from typing import Iterator, Union

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    concat_batches,
)
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.ops.partition import (
    HashPartitioning,
    RangePartitioning,
    split_batch,
)
from spark_rapids_tpu_torch.ops.range_partition import choose_bounds
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager

#: seed of the range exchange's sample positions (the JAX package's)
RANGE_SAMPLE_SEED = 0x52414E47


class TpuShuffleExchangeExec(TpuExec):
    def __init__(self, partitioning: Union[HashPartitioning,
                                           RangePartitioning],
                 child: TpuExec, manager: ShuffleManager,
                 samples_per_batch: int = 128):
        """``samples_per_batch``: rows a range exchange samples from each
        map batch (``spark.rapids.tpu.sql.sort.samplesPerBatch``)."""
        super().__init__(child)
        self.partitioning = partitioning.bind(child.schema)
        self.manager = manager
        self.samples_per_batch = samples_per_batch
        self._shuffle_id = None

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    @property
    def num_partitions(self) -> int:
        return self.partitioning.num_partitions

    @property
    def output_partitioning(self) -> Union[HashPartitioning,
                                           RangePartitioning]:
        return self.partitioning

    def node_desc(self) -> str:
        return f"TpuShuffleExchangeExec {self.partitioning.describe()}"

    def _blocks(self, batch: ColumnarBatch, pids: torch.Tensor
                ) -> list[tuple[int, ColumnarBatch]]:
        """The batch split by partition id: its non-empty blocks."""
        return [(rid, sub) for rid, sub in enumerate(
            split_batch(batch, pids, self.num_partitions)) if sub.num_rows]

    def _map_task(self, shuffle_id: int, child_part: int) -> None:
        blocks: list[tuple[int, ColumnarBatch]] = []
        for batch in self.children[0].execute_partition(child_part):
            if batch.num_rows:
                blocks += self._blocks(
                    batch, self.partitioning.partition_ids(batch))
        self.manager.commit_task(shuffle_id, blocks)

    def _range_map_stage(self, shuffle_id: int) -> None:
        part = self.partitioning
        rng = np.random.default_rng(RANGE_SAMPLE_SEED)
        parked: list[ColumnarBatch] = []
        samples: list[ColumnarBatch] = []
        for p in range(self.children[0].num_partitions):
            for batch in self.children[0].execute_partition(p):
                if batch.num_rows == 0:
                    continue
                pos = rng.integers(0, batch.num_rows, self.samples_per_batch)
                samples.append(part.key_batch(batch).gather(
                    torch.from_numpy(pos).to(batch.device)))
                parked.append(batch)
        if not parked:
            return
        bounds = choose_bounds(concat_batches(samples), part.key_orders(),
                               self.num_partitions)
        for batch in parked:
            self.manager.commit_task(shuffle_id, self._blocks(
                batch, part.partition_ids_with_bounds(batch, bounds)))

    def _ensure_map_stage(self) -> int:
        if self._shuffle_id is None:
            sid = self.manager.new_shuffle_id()
            if isinstance(self.partitioning, RangePartitioning):
                self._range_map_stage(sid)
            else:
                for p in range(self.children[0].num_partitions):
                    self._map_task(sid, p)
            self._shuffle_id = sid
        return self._shuffle_id

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        yield from self.manager.read(self._ensure_map_stage(), p)

    def close(self) -> None:
        """Drop this exchange's blocks."""
        if self._shuffle_id is not None:
            self.manager.unregister(self._shuffle_id)
            self._shuffle_id = None


class TpuCoalescePartitionsExec(TpuExec):
    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    @property
    def num_partitions(self) -> int:
        return 1

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        yield from self.children[0].execute()
