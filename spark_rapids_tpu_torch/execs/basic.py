"""Projection and filter execs.

Counterparts of ``TpuProjectExec`` and ``TpuFilterExec`` in
``spark_rapids_tpu/execs/basic.py``.  A filter compacts its batches: a
row whose condition is NULL or false is dropped.
"""

from __future__ import annotations

from typing import Iterator, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
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
