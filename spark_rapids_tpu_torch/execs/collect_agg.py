"""The collect_list / collect_set exec.

Counterpart of ``TpuCollectAggExec`` in ``spark_rapids_tpu/execs/
collect_agg.py``: an aggregate whose every function is a collect runs
here, on ``ops/collect.py``, never in the hash aggregate (a mix of
collects and other aggregates runs on the CPU engine, as the JAX
planner sends it).  Each input batch is projected to the keys and the
collected values and waits in the buffer store (``COALESCE_PENDING``);
the partition's batches are then concatenated and collected in one
restartable step under the OOM ladder.

With ``partitioned`` set, the planner has put a hash exchange on the
group keys under it (or found the child distributed so): its reduce
partitions are key-disjoint, each is collected alone and an empty one
yields nothing, so the union of the partitions' rows is the answer
with no merge of arrays across partitions.  Otherwise every child
partition is drained into one collect, and a grand collect over no
rows still yields its one empty array.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    concat_batches,
    empty_batch,
)
from spark_rapids_tpu_torch.execs.base import TaskRuntime, TpuExec
from spark_rapids_tpu_torch.execs.retry import run_with_oom_retry
from spark_rapids_tpu_torch.exprs.aggregates import NamedAgg
from spark_rapids_tpu_torch.exprs.base import (
    EvalContext,
    Expression,
    bind_references,
    output_field,
)
from spark_rapids_tpu_torch.memory.store import SpillPriorities
from spark_rapids_tpu_torch.ops.collect import collect


class TpuCollectAggExec(TpuExec):
    def __init__(self, groups: Sequence[Expression], aggs: Sequence[NamedAgg],
                 child: TpuExec, partitioned: bool = False,
                 runtime: Optional[TaskRuntime] = None):
        super().__init__(child)
        self.runtime = runtime or TaskRuntime.serial()
        cs = child.schema
        self.groups = [bind_references(g, cs) for g in groups]
        self.aggs = [NamedAgg(na.fn.bind(cs), na.out_name) for na in aggs]
        self.kinds = [na.fn.collect_kind for na in self.aggs]
        #: the child is hash-distributed on the group keys
        self.partitioned = partitioned
        keys = [output_field(g, i) for i, g in enumerate(self.groups)]
        self._schema = T.Schema(keys + [na.output_field()
                                        for na in self.aggs])
        self._input_schema = T.Schema(keys + [
            T.Field(f"__v{i}", na.fn.child.dtype, True)
            for i, na in enumerate(self.aggs)])

    @property
    def schema(self) -> T.Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return self.children[0].num_partitions if self.partitioned else 1

    def node_desc(self) -> str:
        ks = ", ".join(g.name for g in self.groups)
        vs = ", ".join(f"{na.fn.name}({na.fn.child.name})->{na.out_name}"
                       for na in self.aggs)
        tag = " [per-partition]" if self.partitioned else ""
        return f"TpuCollectAggExec keys=[{ks}] [{vs}]{tag}"

    def _project(self, batch: ColumnarBatch) -> ColumnarBatch:
        ctx = EvalContext.for_batch(batch)
        return batch.with_columns(
            [g.eval(ctx) for g in self.groups]
            + [na.fn.child.eval(ctx) for na in self.aggs],
            self._input_schema)

    def _collect(self, source: Iterable[ColumnarBatch],
                 emit_empty: bool) -> Iterator[ColumnarBatch]:
        store, policy = self.runtime.store, self.runtime.retry
        handles = []
        try:
            for b in source:
                if b.num_rows:
                    handles.append(store.register(
                        self._project(b), SpillPriorities.COALESCE_PENDING))
            if not handles and (self.groups or not emit_empty):
                return

            def run() -> ColumnarBatch:
                if not handles:
                    big = empty_batch(self._input_schema, self.leaf_device())
                else:
                    got = []
                    try:
                        for h in handles:
                            got.append(h.get())
                        big = concat_batches(got)
                    finally:
                        for h in handles[:len(got)]:
                            h.unpin()
                return collect(big, len(self.groups), self.kinds,
                               self._schema)

            out = run_with_oom_retry(run, "collect", policy=policy)
        finally:
            for h in handles:
                h.close()
        yield out

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        if self.partitioned:
            yield from self._collect(self.children[0].execute_partition(p),
                                     emit_empty=False)
        elif p == 0:
            yield from self._collect(self.children[0].execute(),
                                     emit_empty=True)
