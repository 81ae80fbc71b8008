"""Batch source, projection, filter, range and union execs.

Counterparts of ``TpuBatchSourceExec``, ``TpuProjectExec``,
``TpuFilterExec``, ``TpuRangeExec`` and ``TpuUnionExec`` in
``spark_rapids_tpu/execs/basic.py``.  A batch source is a leaf over
batches already on the device (one partition), which tests put under
an exec to feed it exactly the batches they made.  A filter
compacts its batches: a row whose condition is NULL or false is
dropped.  A range makes one batch of up to ``batch_rows`` ids per
partition on its device.  A union's partitions are its members', one
member after another, so an exchange above it numbers its map tasks in
that order; its batches are re-tagged with the union's schema (the
first member's names).

A projection and a filter evaluate their expressions with the partition
they run (``execute_partition``'s ``p``) and the rows of it they
evaluated before the batch (``EvalContext``; the partition-aware
expressions of ``exprs/nondeterministic.py`` read them).  The JAX
package fuses such execs and counts the rows entering the chain; these
count their own input, which is the same when nothing above a Filter or
a row-multiplying exec (Expand, Generate) reads them, and Spark's
numbering otherwise.  With ``ansi`` (the session's
``spark.rapids.tpu.sql.ansi.enabled``) each batch's expressions run
under one capture, polled once (``exprs/base.py::evaluate``).
"""

from __future__ import annotations

from typing import Iterator, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.execs.jit_cache import exprs_key
from spark_rapids_tpu_torch.exprs.base import (
    EvalContext,
    Expression,
    bind_references,
    evaluate,
    output_field,
)


class TpuBatchSourceExec(TpuExec):
    """A leaf over ready batches of one schema: one partition, the
    batches in order, on ``device`` (the first batch's when None)."""

    def __init__(self, batches: Sequence[ColumnarBatch], schema: T.Schema,
                 device=None):
        super().__init__()
        self._batches = list(batches)
        self._schema = schema
        if device is None:
            device = self._batches[0].device if self._batches else "cpu"
        self.device = torch.device(device)

    @property
    def schema(self) -> T.Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return 1

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        yield from self._batches


class TpuProjectExec(TpuExec):
    def __init__(self, exprs: Sequence[Expression], child: TpuExec,
                 ansi: bool = False):
        super().__init__(child)
        self.ansi = ansi
        self.exprs = [bind_references(e, child.schema) for e in exprs]
        self._schema = T.Schema([output_field(e, i)
                                 for i, e in enumerate(self.exprs)])

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def node_desc(self) -> str:
        return f"TpuProjectExec [{', '.join(e.name for e in self.exprs)}]"

    def _project(self, b: ColumnarBatch, ctx: EvalContext) -> ColumnarBatch:
        return b.with_columns(evaluate(self.exprs, ctx, self.ansi),
                              self._schema)

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        offset = 0
        run = self.program("project", lambda: (
            exprs_key(self.exprs), repr(self._schema), self.ansi),
            self._project)
        for b in self.children[0].execute_partition(p):
            ctx = EvalContext.for_batch(b, p, offset)
            offset += b.num_rows
            with self.timer() as t:
                out = t.observe(run(b, ctx))
            yield out


class TpuFilterExec(TpuExec):
    def __init__(self, condition: Expression, child: TpuExec,
                 ansi: bool = False):
        super().__init__(child)
        self.ansi = ansi
        self.condition = bind_references(condition, child.schema)

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    def node_desc(self) -> str:
        return f"TpuFilterExec [{self.condition!r}]"

    def _filter(self, b: ColumnarBatch, ctx: EvalContext) -> ColumnarBatch:
        (pred,) = evaluate([self.condition], ctx, self.ansi)
        return b.compact(pred.data.bool() & pred.validity)

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        offset = 0
        run = self.program("filter", lambda: (
            exprs_key([self.condition]), self.ansi), self._filter)
        for b in self.children[0].execute_partition(p):
            ctx = EvalContext.for_batch(b, p, offset)
            offset += b.num_rows
            with self.timer() as t:
                out = t.observe(run(b, ctx))
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
