"""Projection, filter, range and union execs.

Counterparts of ``TpuProjectExec``, ``TpuFilterExec``, ``TpuRangeExec``
and ``TpuUnionExec`` in ``spark_rapids_tpu/execs/basic.py``.  A filter
compacts its batches: a row whose condition is NULL or false is
dropped.  A range makes one batch of up to ``batch_rows`` ids per
partition on its device.  A union's partitions are its members', one
member after another, so an exchange above it numbers its map tasks in
that order; its batches are re-tagged with the union's schema (the
first member's names).
"""

from __future__ import annotations

from typing import Iterator, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.exprs.base import (
    EvalContext,
    Expression,
    bind_references,
    output_field,
)


class TpuProjectExec(TpuExec):
    def __init__(self, exprs: Sequence[Expression], child: TpuExec):
        super().__init__(child)
        self.exprs = [bind_references(e, child.schema) for e in exprs]
        self._schema = T.Schema([output_field(e, i)
                                 for i, e in enumerate(self.exprs)])

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def node_desc(self) -> str:
        return f"TpuProjectExec [{', '.join(e.name for e in self.exprs)}]"

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        for b in self.children[0].execute_partition(p):
            ctx = EvalContext.for_batch(b)
            yield b.with_columns([e.eval(ctx) for e in self.exprs],
                                 self._schema)


class TpuFilterExec(TpuExec):
    def __init__(self, condition: Expression, child: TpuExec):
        super().__init__(child)
        self.condition = bind_references(condition, child.schema)

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    def node_desc(self) -> str:
        return f"TpuFilterExec [{self.condition!r}]"

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        for b in self.children[0].execute_partition(p):
            pred = self.condition.eval(EvalContext.for_batch(b))
            out = b.compact(pred.data.bool() & pred.validity)
            if out.num_rows:
                yield out


class TpuRangeExec(TpuExec):
    def __init__(self, start: int, end: int, step: int,
                 device: torch.device, batch_rows: int):
        super().__init__()
        self.start, self.end, self.step = start, end, step
        self.device = torch.device(device)
        self.batch_rows = batch_rows
        self.total = max(0, -(-(end - start) // step))
        self._schema = T.Schema([T.Field("id", T.LONG, False)])

    @property
    def schema(self) -> T.Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return max(1, -(-self.total // self.batch_rows))

    def node_desc(self) -> str:
        return f"TpuRangeExec ({self.start}, {self.end}, step={self.step})"

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        first = p * self.batch_rows
        n = min(self.batch_rows, self.total - first)
        if n <= 0:
            return
        ids = self.start + self.step * torch.arange(
            first, first + n, dtype=torch.int64, device=self.device)
        valid = torch.ones(n, dtype=torch.bool, device=self.device)
        yield ColumnarBatch([Column(ids, valid, T.LONG)], n, self._schema,
                            self.device)


class TpuUnionExec(TpuExec):
    def __init__(self, schema: T.Schema, *children: TpuExec):
        super().__init__(*children)
        self._schema = schema

    @property
    def schema(self) -> T.Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return sum(c.num_partitions for c in self.children)

    def node_desc(self) -> str:
        return f"TpuUnionExec [{', '.join(self._schema.names)}]"

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        for child in self.children:
            if p < child.num_partitions:
                for b in child.execute_partition(p):
                    yield ColumnarBatch(b.columns, b.num_rows, self._schema,
                                        b.device)
                return
            p -= child.num_partitions
