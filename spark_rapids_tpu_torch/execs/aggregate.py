"""Hash-aggregate exec.

Counterpart of ``TpuHashAggregateExec`` in
``spark_rapids_tpu/execs/aggregate.py``, with its three modes:

- ``partial``: keys ++ partial columns out, per input partition (feeds
  an exchange);
- ``final``: partial layout in, merged and finalized out, per
  partition (the exchange made partitions key-disjoint);
- ``complete``: the whole aggregation in one partition.

Each input batch runs the update aggregation; the partials of a
partition are concatenated and merged once at its end (they hold one
row per group, so they stay small next to the input).  Partials keep
their batches' order, and a final aggregate reads its exchange's blocks
in map-task order, so first / last pick the same row on every run,
pooled or serial.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    concat_batches,
    empty_batch,
)
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.exprs.aggregates import NamedAgg
from spark_rapids_tpu_torch.exprs.base import (
    BoundReference,
    EvalContext,
    Expression,
    bind_references,
    output_field,
)
from spark_rapids_tpu_torch.ops.groupby import (
    FIRST_LAST,
    GROUPBY_OPS,
    AggSpec,
    groupby_aggregate,
    reduce_aggregate,
)


#: the ops that return one of the group's values
VALUE_OPS = {"min", "max", *FIRST_LAST}


class TpuHashAggregateExec(TpuExec):
    def __init__(self, groups: Sequence[Expression], aggs: Sequence[NamedAgg],
                 child: TpuExec, mode: str = "complete",
                 input_schema: Optional[T.Schema] = None):
        """``input_schema``: for mode="final" only, the pre-aggregation
        schema the aggregate inputs refer to."""
        super().__init__(child)
        if mode not in ("partial", "final", "complete"):
            raise ValueError(f"unknown aggregate mode {mode!r}")
        self.mode = mode
        child_schema = child.schema
        bind_schema = input_schema if mode == "final" else child_schema
        if bind_schema is None:
            raise ValueError("final mode requires input_schema")
        self.aggs = [NamedAgg(na.fn.bind(bind_schema), na.out_name)
                     for na in aggs]
        for na in self.aggs:
            ops = set(na.fn.update_ops())
            if not ops <= set(GROUPBY_OPS):
                raise NotImplementedError(
                    f"{na.fn.name} is not ported as a group-by aggregate")
            if ops & VALUE_OPS and isinstance(na.fn.child.dtype,
                                              T.StringType):
                # the JAX planner runs these over strings on its CPU
                # engine; the port has none
                raise NotImplementedError(
                    f"{na.fn.name} over a string is not ported")
        self.n_keys = len(groups)
        if mode == "final":
            self.partial_schema = child_schema
            self.groups = [BoundReference(i, f.dtype, f.nullable, f.name)
                           for i, f in enumerate(
                               child_schema.fields[: self.n_keys])]
        else:
            self.groups = [bind_references(g, child_schema) for g in groups]
            key_fields = [output_field(g, i)
                          for i, g in enumerate(self.groups)]
            self.input_exprs = list(self.groups)
            partial_fields: list[T.Field] = []
            for na in self.aggs:
                self.input_exprs.extend(na.fn.inputs())
                for pi, pdt in enumerate(na.fn.partial_dtypes()):
                    partial_fields.append(
                        T.Field(f"{na.out_name}__p{pi}", pdt, True))
            self.update_input_schema = T.Schema(
                key_fields + [T.Field(f"__in{i}", e.dtype, e.nullable)
                              for i, e in enumerate(
                                  self.input_exprs[self.n_keys:])])
            self.partial_schema = T.Schema(key_fields + partial_fields)

        # merge ops over the partial layout
        self.merge_specs: list[AggSpec] = []
        po = self.n_keys
        for na in self.aggs:
            for op, pdt in zip(na.fn.merge_ops(), na.fn.partial_dtypes()):
                self.merge_specs.append(AggSpec(op, po, out_dtype=pdt))
                po += 1

        key_fields = list(self.partial_schema.fields[: self.n_keys])
        if mode == "partial":
            self._schema = self.partial_schema
        else:
            self._schema = T.Schema(
                key_fields + [na.output_field() for na in self.aggs])

        # finalize projection over the partial layout
        self.final_exprs: list[Expression] = [
            BoundReference(i, f.dtype, f.nullable, f.name)
            for i, f in enumerate(key_fields)]
        po = self.n_keys
        for na in self.aggs:
            refs = []
            for _ in na.fn.partial_dtypes():
                pf = self.partial_schema.fields[po]
                refs.append(BoundReference(po, pf.dtype, pf.nullable,
                                           pf.name))
                po += 1
            self.final_exprs.append(na.fn.finalize_expr(refs))

    @property
    def schema(self) -> T.Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        if self.mode == "complete":
            return 1
        return self.children[0].num_partitions

    @property
    def output_partitioning(self):
        """A final aggregate keeps the feeding exchange's distribution
        when that hashes group-key ordinals: the keys keep their
        positions and types through the merge."""
        part = self.children[0].output_partitioning
        if self.mode != "final" or part is None or not all(
                isinstance(e, BoundReference) and e.ordinal < self.n_keys
                for e in part.exprs):
            return None
        return part

    def node_desc(self) -> str:
        keys = ", ".join(e.name for e in self.groups)
        outs = ", ".join(f"{na.fn.name}->{na.out_name}" for na in self.aggs)
        return f"TpuHashAggregateExec[{self.mode}] keys=[{keys}] [{outs}]"

    def _update_specs(self) -> list[AggSpec]:
        specs = []
        io = self.n_keys
        for na in self.aggs:
            n_in = len(na.fn.inputs())
            for op, pdt in zip(na.fn.update_ops(), na.fn.partial_dtypes()):
                specs.append(AggSpec(op, io if n_in else 0, out_dtype=pdt))
            io += n_in
        return specs

    def _update_batch(self, batch: ColumnarBatch) -> ColumnarBatch:
        ctx = EvalContext.for_batch(batch)
        cols = [e.eval(ctx) for e in self.input_exprs]
        # Spark normalizes float grouping keys: -0.0 groups AS 0.0 and
        # every NaN as the one canonical NaN, so the emitted key is
        # canonical too
        for i in range(self.n_keys):
            c = cols[i]
            if isinstance(c.dtype, T.DoubleType):
                d = torch.where(c.data == 0, torch.zeros_like(c.data),
                                c.data)
                d = torch.where(torch.isnan(d),
                                torch.full_like(d, float("nan")), d)
                cols[i] = type(c)(d, c.validity, c.dtype)
        proj = batch.with_columns(cols, self.update_input_schema)
        specs = self._update_specs()
        if self.n_keys == 0:
            return reduce_aggregate(proj, specs, self.partial_schema)
        return groupby_aggregate(proj, list(range(self.n_keys)), specs,
                                 self.partial_schema)

    def _merge(self, partial: ColumnarBatch) -> ColumnarBatch:
        if self.n_keys == 0:
            return reduce_aggregate(partial, self.merge_specs,
                                    self.partial_schema)
        return groupby_aggregate(partial, list(range(self.n_keys)),
                                 self.merge_specs, self.partial_schema)

    def _finalize(self, partial: ColumnarBatch) -> ColumnarBatch:
        ctx = EvalContext.for_batch(partial)
        return partial.with_columns([e.eval(ctx) for e in self.final_exprs],
                                    self._schema)

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        if self.mode == "complete":
            source = self.children[0].execute()
            emit_empty_default = True
        else:
            source = self.children[0].execute_partition(p)
            emit_empty_default = p == 0
        pending: list[ColumnarBatch] = []
        for batch in source:
            pending.append(batch if self.mode == "final"
                           else self._update_batch(batch))
        if not pending:
            if self.n_keys > 0 or not emit_empty_default:
                return  # grouped aggregate of empty input: no rows
            # grand aggregate of empty input: one default row
            src_schema = (self.partial_schema if self.mode == "final"
                          else self.children[0].schema)
            eb = empty_batch(src_schema, self.leaf_device())
            pending.append(eb if self.mode == "final"
                           else self._update_batch(eb))
        out = concat_batches(pending)
        if len(pending) > 1 or self.mode == "final":
            out = self._merge(out)
        if self.mode != "partial":
            out = self._finalize(out)
        yield out
