"""Shuffle exchange and partition coalescing.

``TpuShuffleExchangeExec`` is the counterpart of the exec of the same
name in ``spark_rapids_tpu/execs/exchange.py``: the map stage hashes
every child batch to partition ids (murmur3-pmod, K1 for string keys),
splits it, and commits the slices to the session's shuffle manager;
each reduce partition then reads its blocks.  Map tasks run one after
another.

``TpuCoalescePartitionsExec`` (``execs/coalesce.py`` there) pulls every
child partition into one, the "exchange" of a grand aggregate.
"""

from __future__ import annotations

from typing import Iterator

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.ops.partition import HashPartitioning, split_batch
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager


class TpuShuffleExchangeExec(TpuExec):
    def __init__(self, partitioning: HashPartitioning, child: TpuExec,
                 manager: ShuffleManager):
        super().__init__(child)
        self.partitioning = partitioning.bind(child.schema)
        self.manager = manager
        self._shuffle_id = None

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    @property
    def num_partitions(self) -> int:
        return self.partitioning.num_partitions

    @property
    def output_partitioning(self) -> HashPartitioning:
        return self.partitioning

    def node_desc(self) -> str:
        return f"TpuShuffleExchangeExec {self.partitioning.describe()}"

    def _map_task(self, shuffle_id: int, child_part: int) -> None:
        n = self.num_partitions
        blocks: list[tuple[int, ColumnarBatch]] = []
        for batch in self.children[0].execute_partition(child_part):
            if batch.num_rows == 0:
                continue
            pids = self.partitioning.partition_ids(batch)
            for rid, sub in enumerate(split_batch(batch, pids, n)):
                if sub.num_rows:
                    blocks.append((rid, sub))
        self.manager.commit_task(shuffle_id, blocks)

    def _ensure_map_stage(self) -> int:
        if self._shuffle_id is None:
            sid = self.manager.new_shuffle_id()
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
