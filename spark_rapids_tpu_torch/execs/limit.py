"""Limit execs.

Counterparts of ``spark_rapids_tpu/execs/limit.py``: batches pass until
the limit is met, and the batch that meets it is cut to a prefix (a
view, no copy).  A limit that is met closes its source at once, so the
stages and pools below it stop and are joined.

- ``TpuLocalLimitExec``: at most n rows per partition;
- ``TpuGlobalLimitExec``: at most n rows in all, one output partition;
- ``TpuCollectLimitExec``: a local limit on every child partition, then
  the global one.
"""

from __future__ import annotations

from typing import Iterable, Iterator

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.execs.base import TpuExec


def _limited(source: Iterable[ColumnarBatch],
             n: int) -> Iterator[ColumnarBatch]:
    remaining = n
    it = iter(source)
    try:
        if remaining <= 0:
            return
        for b in it:
            if b.num_rows > remaining:
                b = b.slice_prefix(remaining)
            remaining -= b.num_rows
            yield b
            if remaining <= 0:
                return
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def _local_limits(child: TpuExec, n: int) -> Iterator[ColumnarBatch]:
    for q in range(child.num_partitions):
        yield from _limited(child.execute_partition(q), n)


class TpuLocalLimitExec(TpuExec):
    def __init__(self, n: int, child: TpuExec):
        super().__init__(child)
        if n < 0:
            raise ValueError(f"limit of {n} rows")
        self.n = n

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    def node_desc(self) -> str:
        return f"{self.name} n={self.n}"

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        yield from _limited(self.children[0].execute_partition(p), self.n)


class TpuGlobalLimitExec(TpuLocalLimitExec):
    @property
    def num_partitions(self) -> int:
        return 1

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        if p == 0:
            yield from _limited(self.children[0].execute(), self.n)


class TpuCollectLimitExec(TpuGlobalLimitExec):
    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        if p != 0:
            return
        yield from _limited(_local_limits(self.children[0], self.n), self.n)
