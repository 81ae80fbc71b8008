"""Physical operator contract.

Counterpart of ``spark_rapids_tpu/execs/base.py``'s ``TpuExec``: an
exec has a schema, a number of output partitions, and yields device
batches per partition.  Execution is plain and sequential: no fusion,
speculation, pipelining, buffer donation or retry ladder in this slice.
"""

from __future__ import annotations

from typing import Iterator

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch


class TpuExec:
    def __init__(self, *children: "TpuExec"):
        self.children: list[TpuExec] = list(children)

    @property
    def schema(self) -> T.Schema:
        raise NotImplementedError

    @property
    def num_partitions(self) -> int:
        return self.children[0].num_partitions

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        raise NotImplementedError

    def execute(self) -> Iterator[ColumnarBatch]:
        for p in range(self.num_partitions):
            yield from self.execute_partition(p)

    @property
    def name(self) -> str:
        return type(self).__name__

    def node_desc(self) -> str:
        return self.name

    def tree_string(self, depth: int = 0) -> str:
        lines = ["  " * depth + self.node_desc()]
        lines += [c.tree_string(depth + 1) for c in self.children]
        return "\n".join(lines)

    def walk(self) -> Iterator["TpuExec"]:
        yield self
        for c in self.children:
            yield from c.walk()
