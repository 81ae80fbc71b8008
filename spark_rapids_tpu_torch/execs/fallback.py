"""The CPU fallback exec: a logical node run on the CPU engine.

Counterpart of ``CpuFallbackExec`` in ``spark_rapids_tpu/plan/
planner.py``.  The planner lowers a node its tags keep off the GPU to
this exec (``plan/planner.py``); the node runs on
``cpu/engine.execute_cpu`` with transitions at both edges:

- device -> host: each child exec's batches become Arrow through
  ``columnar/arrow.py::batches_to_arrow``; a child that is itself a
  CPU node hands its table over with no round trip (adjacent CPU nodes
  fuse into one CPU table);
- host -> device: the engine's table uploads through
  ``io/scan.py::ArrowSourceExec``, in batches of ``batch_rows``.

A Filter, Project or Generate over a device child streams: each child batch
crosses to the host, runs, and crosses back, partition by partition, so
the exec keeps its child's partitions.  Any other node drains its
children, runs once, and makes one partition.  ``metrics`` counts the
rows and batches each way (``toHostRows``, ``toHostBatches``,
``toDeviceRows``, ``toDeviceBatches``) and the engine's time
(``cpuTime``, ns).  With ``ansi`` (the session's
``spark.rapids.tpu.sql.ansi.enabled``) the engine raises ``AnsiError``
where the JAX CPU engine does.
"""

from __future__ import annotations

import copy
import time
from typing import Iterable, Iterator, Sequence

import pyarrow as pa
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import batches_to_arrow
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.cpu.engine import arrow_schema, execute_cpu
from spark_rapids_tpu_torch.execs.base import Metrics, TaskRuntime, TpuExec
from spark_rapids_tpu_torch.io.scan import ArrowSourceExec
from spark_rapids_tpu_torch.plan import logical as L

TRANSITION_METRICS = ("toHostRows", "toHostBatches", "toDeviceRows",
                      "toDeviceBatches", "cpuTime")


class CpuFallbackExec(TpuExec):
    #: logical nodes evaluated row by row: their boundary streams
    STREAMABLE = (L.Filter, L.Project, L.Generate)

    def __init__(self, plan: L.LogicalPlan, reasons: Iterable[str],
                 children: Sequence[TpuExec], device: torch.device,
                 batch_rows: int, runtime: TaskRuntime, ansi: bool = False):
        super().__init__(*children)
        self.plan = plan
        self.ansi = ansi
        self.reasons = sorted(reasons)
        self.device = torch.device(device)
        self.batch_rows = batch_rows
        self.runtime = runtime
        self.metrics = Metrics(*TRANSITION_METRICS)

    @property
    def schema(self) -> T.Schema:
        return self.plan.schema

    @property
    def streaming(self) -> bool:
        return isinstance(self.plan, self.STREAMABLE) and not isinstance(
            self.children[0], CpuFallbackExec)

    @property
    def num_partitions(self) -> int:
        return self.children[0].num_partitions if self.streaming else 1

    def node_desc(self) -> str:
        return f"CpuFallbackExec [{self.plan.node_desc()}]"

    def _to_host(self, batches: Iterable[ColumnarBatch],
                 child: L.LogicalPlan) -> pa.Table:
        """Device batches as one Arrow table of ``child``'s schema."""
        n_batches = 0

        def counted():
            nonlocal n_batches
            for b in batches:
                n_batches += 1
                yield b

        t = batches_to_arrow(counted(), child.schema)
        self.metrics.add("toHostRows", t.num_rows)
        self.metrics.add("toHostBatches", n_batches)
        return pa.Table.from_arrays(t.columns,
                                    schema=arrow_schema(child.schema))

    def _run(self, children: list[pa.Table]) -> pa.Table:
        plan = copy.copy(self.plan)
        plan.children = [L.InMemoryRelation(t) for t in children]
        t0 = time.perf_counter_ns()
        out = execute_cpu(plan, ansi=self.ansi)
        self.metrics.add("cpuTime", time.perf_counter_ns() - t0)
        return out

    def cpu_table(self) -> pa.Table:
        """The node's whole output on the host."""
        tables = []
        for exec_, child in zip(self.children, self.plan.children):
            if isinstance(exec_, CpuFallbackExec):
                tables.append(exec_.cpu_table())
            else:
                tables.append(self._to_host(exec_.execute(), child))
        return self._run(tables)

    def _to_device(self, table: pa.Table) -> Iterator[ColumnarBatch]:
        src = ArrowSourceExec(table, self.schema, self.device,
                              self.batch_rows, runtime=self.runtime)
        for b in src.execute():
            self.metrics.add("toDeviceRows", b.num_rows)
            self.metrics.add("toDeviceBatches", 1)
            yield b

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        if not self.streaming:
            yield from self._to_device(self.cpu_table())
            return
        child = self.plan.children[0]
        for b in self.children[0].execute_partition(p):
            yield from self._to_device(self._run([self._to_host([b],
                                                                child)]))
