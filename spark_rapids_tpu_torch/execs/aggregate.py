"""Hash-aggregate exec.

Counterpart of ``TpuHashAggregateExec`` in
``spark_rapids_tpu/execs/aggregate.py``, with its three modes:

- ``partial``: keys ++ partial columns out, per input partition (feeds
  an exchange);
- ``final``: partial layout in, merged and finalized out, per
  partition (the exchange made partitions key-disjoint);
- ``complete``: the whole aggregation in one partition.

The update loop is pipelined (``parallel/pipeline.py::pipelined``,
tag ``agg.update``): batch k+1's update is dispatched before batch k's
partial is parked, and each input batch is a unit of the OOM ladder
(``execs/retry.guarded_pipeline``).  A partial waits in the buffer
store at ``AGGREGATE_PARTIAL`` priority; once the waiting partials
hold ``goal_rows`` rows (``sql.batchSizeRows``) they are merged into
one, and at the partition's end the rest are concatenated, merged and
finalized, each step a restartable closure under ``run_with_oom_retry``
that drops the partials it merged only once the result is parked (the
JAX exec's ``merge_and_park``).  Partials keep their batches' order,
and a final aggregate reads its exchange's blocks in map-task order, so
first / last pick the same row on every run, pooled or serial.

Speculative sizing (``parallel/speculation.py``, tag ``agg.size``; on
by default, for a grouped partial or complete aggregate): the update
runs in its sync-free form
(``ops/groupby.py::groupby_aggregate_at_capacity``), a partial at the
batch's rows with its group count on the device.  Past the predictor's
warm-up the dispatch half starts the asynchronous read of that count
(``device_read_async``); the retire half, one batch behind, resolves
it (free once its copy has landed; a read that still had to wait is
counted as late), copies the partial's groups out (a cut by
``slice_prefix`` would be a view that keeps the capacity's storage
alive, while the store counts only the rows it sees) and parks them.
A warm-up partial reads its count blocking.  So the waiting partials
hold their groups alone, and the merge points, with them the order a
floating sum adds in, are those of a run with speculation off, pooled
or serial, spilled or not.  The predictor's
observation and the hit or overflow (``specHits`` / ``specOverflows``:
whether the estimate covered the count, which feeds the kill switch)
are recorded once the retire has parked the partial, so an attempt
that fails observes nothing and no count is observed twice.

The JAX exec also keeps small partials unsized and concatenates them
with a traced count on the device (``_DEFER_SYNC_CAP``), so that XLA
compiles one program for any count.  The port needs no such path: in
steady state its retire reads no count that has not arrived, and
PyTorch compiles nothing.
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
from spark_rapids_tpu_torch.execs.base import Metrics, TaskRuntime, TpuExec
from spark_rapids_tpu_torch.execs.jit_cache import exprs_key
from spark_rapids_tpu_torch.execs.retry import (
    guarded_pipeline,
    run_with_oom_retry,
)
from spark_rapids_tpu_torch.exprs.aggregates import NamedAgg
from spark_rapids_tpu_torch.exprs.base import (
    BoundReference,
    EvalContext,
    Expression,
    bind_references,
    output_field,
)
from spark_rapids_tpu_torch.memory.store import (
    SpillableBatch,
    SpillPriorities,
)
from spark_rapids_tpu_torch.ops.groupby import (
    FIRST_LAST,
    GROUPBY_OPS,
    AggSpec,
    groupby_aggregate,
    groupby_aggregate_at_capacity,
    reduce_aggregate,
)
from spark_rapids_tpu_torch.parallel import speculation as SP
from spark_rapids_tpu_torch.parallel.pipeline import (
    device_read_async,
    device_read_int,
    pipelined,
)
from spark_rapids_tpu_torch.trace import ledger as _ledger


#: the ops that return one of the group's values
VALUE_OPS = {"min", "max", *FIRST_LAST}


class TpuHashAggregateExec(TpuExec):
    def __init__(self, groups: Sequence[Expression], aggs: Sequence[NamedAgg],
                 child: TpuExec, mode: str = "complete",
                 input_schema: Optional[T.Schema] = None,
                 runtime: Optional[TaskRuntime] = None,
                 goal_rows: int = 1 << 20):
        """``input_schema``: for mode="final" only, the pre-aggregation
        schema the aggregate inputs refer to; ``goal_rows``: waiting
        partials merge once they hold this many rows."""
        super().__init__(child)
        self.runtime = runtime or TaskRuntime.serial()
        self.goal_rows = goal_rows
        #: speculated partials, by whether the estimate covered them
        self.metrics = Metrics("numMerges", "specHits", "specOverflows")
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
                # the planner tags these and runs them on the CPU
                # engine, as the JAX planner does
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

    def _update_input(self, batch: ColumnarBatch) -> ColumnarBatch:
        """The update's input: keys (float keys normalized) ++ the
        aggregates' inputs."""
        ctx = EvalContext.for_batch(batch)
        cols = [e.eval(ctx) for e in self.input_exprs]
        # Spark normalizes float grouping keys: -0.0 groups AS 0.0 and
        # every NaN as the one canonical NaN, so the emitted key is
        # canonical too
        for i in range(self.n_keys):
            c = cols[i]
            if isinstance(c.dtype, T.FractionalType):
                d = torch.where(c.data == 0, torch.zeros_like(c.data),
                                c.data)
                d = torch.where(torch.isnan(d),
                                torch.full_like(d, float("nan")), d)
                cols[i] = type(c)(d, c.validity, c.dtype)
        return batch.with_columns(cols, self.update_input_schema)

    def _update_batch(self, batch: ColumnarBatch) -> ColumnarBatch:
        proj = self._update_input(batch)
        specs = self._update_specs()
        if self.n_keys == 0:
            return reduce_aggregate(proj, specs, self.partial_schema)
        return groupby_aggregate(proj, list(range(self.n_keys)), specs,
                                 self.partial_schema)

    def _update_at_capacity(self, batch: ColumnarBatch):
        """The grouped update with no sync: (the partial at capacity,
        its device group count)."""
        return groupby_aggregate_at_capacity(
            self._update_input(batch), list(range(self.n_keys)),
            self._update_specs(), self.partial_schema)

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

    def _update_key(self) -> tuple:
        return (exprs_key(self.input_exprs), self.n_keys,
                repr(self.update_input_schema), repr(self._update_specs()),
                repr(self.partial_schema))

    def _programs(self):
        """(update, merge, finalize) through the program cache, keyed by
        what each reads of the exec."""
        return (
            None if self.mode == "final" else self.program(
                "agg.update", self._update_key, self._update_batch),
            self.program("agg.merge", lambda: (
                self.n_keys, repr(self.merge_specs),
                repr(self.partial_schema)), self._merge),
            self.program("agg.final", lambda: (
                exprs_key(self.final_exprs), repr(self._schema)),
                self._finalize))

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        if self.mode == "complete":
            source = self.children[0].execute()
            emit_empty_default = True
        else:
            source = self.children[0].execute_partition(p)
            emit_empty_default = p == 0
        store, policy = self.runtime.store, self.runtime.retry
        spec = self.runtime.speculation
        pending: list[SpillableBatch] = []
        rows = 0
        update_batch, merge, finalize = self._programs()
        pred = None
        if self.mode != "final" and self.n_keys > 0 and spec.enabled \
                and SP.tag_enabled("agg.size"):
            key = ("agg.update",) + self._update_key()
            pred = SP.predictor(key + ("sizing",))
            cap_key = key + ("capacity",)
            update_cap = self.program(cap_key[0], lambda: cap_key[1:],
                                      self._update_at_capacity)

        def park(part: ColumnarBatch) -> None:
            nonlocal rows
            pending.append(store.register(part,
                                          SpillPriorities.AGGREGATE_PARTIAL))
            rows += part.num_rows

        def drain() -> ColumnarBatch:
            """The waiting partials as one batch; they stay registered
            (a failure leaves them evictable)."""
            got: list[SpillableBatch] = []
            try:
                batches = []
                for h in pending:
                    batches.append(h.get())
                    got.append(h)
                return concat_batches(batches)
            finally:
                for h in got:
                    h.unpin()

        def commit(out: Optional[ColumnarBatch]) -> None:
            """Replace the waiting partials by ``out`` (None: by
            nothing).  ``out`` is parked first: if that fails, the
            partials are still there for the ladder's re-run."""
            nonlocal rows
            merged = [] if out is None else [run_with_oom_retry(
                lambda: store.register(out, SpillPriorities.AGGREGATE_PARTIAL),
                "agg.park", policy=policy)]
            for h in pending:
                h.close()
            pending[:] = merged
            rows = 0 if out is None else out.num_rows

        def dispatch(batch: ColumnarBatch):
            """One batch's update (device work; no sync past the
            predictor's warm-up): (partial, None), or (partial at
            capacity, (count, estimate or None))."""
            if self.mode == "final":
                return batch, None
            with self.timer() as t:
                if pred is None:
                    return t.observe(update_batch(batch)), None
                est = pred.predict(spec, cap_ceiling=batch.num_rows)
                _ledger.defer_occupancy()
                part, count = t.observe(update_cap(batch))
            if est is None:
                return part, (count, None)
            return part, (device_read_async(count, tag="agg.size"), est)

        def retire(entry):
            """Cut a speculated partial to its groups and park it,
            merging once the waiting ones reach ``goal_rows``; on
            failure, roll back what this batch parked."""
            nonlocal rows
            part, sized = entry
            n0, r0 = len(pending), rows
            try:
                with self.timer():
                    if sized is not None:
                        fut, est = sized
                        cap = part.num_rows
                        n = (device_read_int(fut, tag="agg.size")
                             if est is None else int(fut.result()))
                        # a copy of the groups, not a view: the store
                        # counts what a parked partial holds
                        part = part.slice_prefix(n) if n == cap else \
                            part.gather(torch.arange(n, device=part.device))
                    park(part)
                    if len(pending) > 1 and rows >= self.goal_rows:
                        commit(run_with_oom_retry(
                            lambda: merge(drain()), "agg.merge",
                            policy=policy))
                        self.metrics.add("numMerges", 1)
            except BaseException:
                for h in pending[n0:]:
                    h.close()
                del pending[n0:]
                rows = r0
                raise
            if sized is not None:
                pred.observe(n)
                _ledger.note_program_occupancy(cap_key, n, cap)
                if est is None:
                    SP.record_sync("agg.size")
                elif n <= est:
                    self.metrics.add("specHits", 1)
                    SP.record_hit("agg.size", est, n, spec)
                else:
                    self.metrics.add("specOverflows", 1)
                    SP.record_overflow("agg.size", est, n, spec)
            return ()

        try:
            dispatch_guarded, retire_guarded = guarded_pipeline(
                dispatch, retire, "agg.update", policy)
            for _ in pipelined(source, dispatch_guarded, retire_guarded,
                               self.runtime.lookahead, tag="agg.update"):
                pass
            if not pending:
                if self.n_keys > 0 or not emit_empty_default:
                    return  # grouped aggregate of empty input: no rows
                # grand aggregate of empty input: one default row
                src_schema = (self.partial_schema if self.mode == "final"
                              else self.children[0].schema)
                eb = empty_batch(src_schema, self.leaf_device())
                park(eb if self.mode == "final" else update_batch(eb))
            single = len(pending) == 1

            def finish() -> ColumnarBatch:
                out = drain()
                if not single or self.mode == "final":
                    out = merge(out)
                if self.mode != "partial":
                    out = finalize(out)
                return out

            with self.timer() as t:
                out = t.observe(run_with_oom_retry(finish, "agg.drain",
                                                   policy=policy))
            commit(None)
        finally:
            for h in pending:
                h.close()
        yield out
