"""Expand exec: every input row once per projection list.

Counterpart of ``spark_rapids_tpu/execs/expand.py``.  Each input batch
evaluates every projection over its rows, and the results concatenate
projection after projection, as the JAX exec's gather lays them out:
one output batch of ``num_rows x projections`` rows per input batch, so
the rows multiply and the batches do not, and no more than one input
batch's sets exist at once.

A NULL slot (a grouping set that drops a key) is a typed NULL column:
zeroed chars of the column's width, length 0 and invalid for a string,
zeroed data and invalid for a fixed-width type.  The output columns
carry no dictionary sidecar: a column's codes would come from one
projection and its NULL slots from another, and the coded group-by
would group them wrongly.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, null_column
from spark_rapids_tpu_torch.columnar.column import (
    AnyColumn,
    Column,
    StringColumn,
)
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.exprs.base import (
    EvalContext,
    Expression,
    bind_references,
)


def _stack_strings(parts: list[AnyColumn], n: int) -> StringColumn:
    w = max(p.width for p in parts if isinstance(p, StringColumn))
    dev = parts[0].validity.device
    parts = [p.with_width(w) if isinstance(p, StringColumn)
             else null_column(T.STRING, n, dev, w) for p in parts]
    return StringColumn(torch.cat([p.chars for p in parts]),
                        torch.cat([p.lengths for p in parts]),
                        torch.cat([p.validity for p in parts]))


def _stack_fixed(parts: list[AnyColumn], dtype: T.DataType) -> Column:
    phys = T.to_torch_dtype(dtype)
    return Column(torch.cat([p.data.to(phys) for p in parts]),
                  torch.cat([p.validity for p in parts]), dtype)


class TpuExpandExec(TpuExec):
    def __init__(self, projections: Sequence[Sequence[Expression]],
                 schema: T.Schema, child: TpuExec):
        """``schema``: the output columns, one per expression of each
        projection."""
        super().__init__(child)
        self.projections = [[bind_references(e, child.schema) for e in p]
                            for p in projections]
        self._schema = schema

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def node_desc(self) -> str:
        return (f"TpuExpandExec [{len(self.projections)} projections] "
                f"[{', '.join(self._schema.names)}]")

    def expand(self, batch: ColumnarBatch) -> ColumnarBatch:
        ctx = EvalContext.for_batch(batch)
        evaluated = [[e.eval(ctx) for e in p] for p in self.projections]
        cols: list[AnyColumn] = []
        for ci, f in enumerate(self._schema.fields):
            parts = [ev[ci] for ev in evaluated]
            if isinstance(f.dtype, T.StringType):
                cols.append(_stack_strings(parts, batch.num_rows))
            else:
                cols.append(_stack_fixed(parts, f.dtype))
        return ColumnarBatch(cols, batch.num_rows * len(self.projections),
                             self._schema, batch.device)

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        for batch in self.children[0].execute_partition(p):
            yield self.expand(batch)
