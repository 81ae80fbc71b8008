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

The projections see the partition and the rows of it before the batch,
and run under an ANSI capture when ``ansi`` is on, as a projection
does (``execs/basic.py``).
"""

from __future__ import annotations

from typing import Iterator, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    concat_columns,
    null_column,
)
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
    evaluate,
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
                 schema: T.Schema, child: TpuExec, ansi: bool = False):
        """``schema``: the output columns, one per expression of each
        projection."""
        super().__init__(child)
        self.ansi = ansi
        self.projections = [[bind_references(e, child.schema) for e in p]
                            for p in projections]
        self._schema = schema

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def node_desc(self) -> str:
        return (f"TpuExpandExec [{len(self.projections)} projections] "
                f"[{', '.join(self._schema.names)}]")

    def expand(self, batch: ColumnarBatch, partition: int = 0,
               offset: int = 0) -> ColumnarBatch:
        ctx = EvalContext.for_batch(batch, partition, offset)
        flat = evaluate([e for p in self.projections for e in p], ctx,
                        self.ansi)
        k = len(self._schema)
        evaluated = [flat[i:i + k] for i in range(0, len(flat), k)]
        cols: list[AnyColumn] = []
        for ci, f in enumerate(self._schema.fields):
            parts = [ev[ci] for ev in evaluated]
            if isinstance(f.dtype, T.StringType):
                cols.append(_stack_strings(parts, batch.num_rows))
            elif isinstance(f.dtype, T.NESTED_TYPES):
                # a payload column, the same in every projection
                cols.append(concat_columns(parts, f.dtype))
            else:
                cols.append(_stack_fixed(parts, f.dtype))
        return ColumnarBatch(cols, batch.num_rows * len(self.projections),
                             self._schema, batch.device)

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        offset = 0
        for batch in self.children[0].execute_partition(p):
            out = self.expand(batch, p, offset)
            offset += batch.num_rows
            yield out
