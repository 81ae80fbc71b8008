"""Generate exec: explode / posexplode and their ``_outer`` forms.

Counterpart of ``TpuGenerateExec`` in ``spark_rapids_tpu/execs/
generate.py``.  The JAX exec flattens a dense ``(rows, max_len)``
element matrix and compacts it; an array here is Arrow's offsets and
flat child (``columnar/column.py``), so each input row is repeated
once per element (``repeat_interleave`` of the row ids: one sizing
sync a batch), the child's columns are gathered by those ids and the
element column by ``offsets[row] + position``.  Rows come in parent
order, then element order.  With ``outer`` an empty or NULL array
still gives one row, whose element is NULL, and whose ``pos`` is NULL
too.  A NULL array's elements (Arrow lets a NULL row span some) are
not generated.  The output is the child's columns the plan reads above
(the planner's ``keep``: the array itself, read by the generator only,
is not repeated a row per element, as Spark's Generate drops its
unrequired child columns), then ``pos`` (posexplode), then the element.
The generator's array expression sees the partition and the rows of it
before the batch, under an ANSI capture when ``ansi`` is on, as a
projection does (``execs/basic.py``).
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, null_column
from spark_rapids_tpu_torch.columnar.column import Column, ListColumn
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.exprs.base import (
    EvalContext,
    bind_references,
    evaluate,
)


class TpuGenerateExec(TpuExec):
    def __init__(self, generator, out_name: str, child: TpuExec,
                 keep: Optional[Sequence[str]] = None, ansi: bool = False):
        """``generator``: an ``Explode`` over the child's columns by
        name; ``keep``: the child's columns to repeat (None: all)."""
        super().__init__(child)
        self.ansi = ansi
        self.generator = generator.with_children(
            [bind_references(generator.child, child.schema)])
        cs = child.schema
        self._kept = [i for i, f in enumerate(cs.fields)
                      if keep is None or f.name in keep]
        fields = [cs.fields[i] for i in self._kept]
        if self.generator.pos:
            fields.append(T.Field("pos", T.INT, self.generator.outer))
        fields.append(T.Field(out_name, self.generator.dtype, True))
        self._schema = T.Schema(fields)

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def node_desc(self) -> str:
        return f"TpuGenerateExec [{self.generator.name}]"

    def _generate(self, batch: ColumnarBatch, partition: int = 0,
                  offset: int = 0) -> ColumnarBatch:
        gen = self.generator
        (lc,) = evaluate([gen.child], EvalContext.for_batch(
            batch, partition, offset), self.ansi)
        assert isinstance(lc, ListColumn), type(lc).__name__
        dev = batch.device
        lens = lc.lengths().to(torch.int64)
        rep = torch.where(lens == 0, 1, lens) if gen.outer else lens
        ends = torch.cumsum(rep, 0)
        total = int(ends[-1]) if batch.num_rows else 0
        parent = torch.repeat_interleave(
            torch.arange(batch.num_rows, device=dev), rep, output_size=total)
        pos = torch.arange(total, device=dev) - (ends - rep)[parent]
        real = pos < lens[parent]
        cols = [batch.columns[i].gather(parent) for i in self._kept]
        if gen.pos:
            cols.append(Column(torch.where(real, pos, 0).to(torch.int32),
                               real, T.INT))
        if len(lc.child) == 0:
            cols.append(null_column(gen.dtype, total, dev))
        else:
            src = torch.where(real, lc.offsets[:-1].to(torch.int64)[parent]
                              + pos, 0)
            cols.append(lc.child.gather(src, real))
        return ColumnarBatch(cols, total, self._schema, dev)

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        offset = 0
        for batch in self.children[0].execute_partition(p):
            out = self._generate(batch, p, offset)
            offset += batch.num_rows
            yield out
