"""Physical operator contract.

Counterpart of ``spark_rapids_tpu/execs/base.py``'s ``TpuExec``: an
exec has a schema, a number of output partitions, and yields device
batches per partition.  Execution is plain and sequential: no fusion,
speculation, pipelining, buffer donation or retry ladder in this slice.
"""

from __future__ import annotations

from typing import Iterator

import torch

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

    @property
    def output_partitioning(self):
        """The hash distribution this exec's output satisfies (a
        ``HashPartitioning`` bound to its schema), or None: the planner
        skips an exchange a child already satisfies."""
        return None

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        raise NotImplementedError

    def execute(self) -> Iterator[ColumnarBatch]:
        for p in range(self.num_partitions):
            yield from self.execute_partition(p)

    def leaf_device(self) -> torch.device:
        """The device of the scan under this exec's first child chain:
        where an exec with no input batch makes its output."""
        node = self
        while node.children:
            node = node.children[0]
        return node.device

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
