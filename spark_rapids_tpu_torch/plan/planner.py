"""Logical -> physical lowering.

Counterpart of ``spark_rapids_tpu/plan/planner.py`` for Scan, Filter,
Project and Aggregate.  Scan columns are pruned to what the plan above
reads.  An aggregate over several input partitions lowers as
``_plan_aggregate`` does there: partial aggregate -> hash exchange on
the group keys -> final aggregate (a grand aggregate coalesces its
partials instead of hashing them); a single partition aggregates
completely.  A node this port cannot lower raises NotImplementedError:
there is no CPU fallback engine.
"""

from __future__ import annotations

from typing import Optional

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.execs.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.execs.basic import TpuFilterExec, TpuProjectExec
from spark_rapids_tpu_torch.execs.exchange import (
    TpuCoalescePartitionsExec,
    TpuShuffleExchangeExec,
)
from spark_rapids_tpu_torch.exprs.base import BoundReference
from spark_rapids_tpu_torch.io.scan import ParquetScanExec
from spark_rapids_tpu_torch.ops.partition import HashPartitioning
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager


class Planner:
    """Lowers logical plans for one session: its conf, device and
    shuffle manager."""

    def __init__(self, conf: C.TorchConf, device: torch.device,
                 manager: ShuffleManager):
        self.conf = conf
        self.device = device
        self.manager = manager

    def plan(self, plan: L.LogicalPlan) -> TpuExec:
        return self._lower(plan, None)

    def _lower(self, p: L.LogicalPlan, required: Optional[set]) -> TpuExec:
        """``required``: column names the parent reads (None = all)."""
        if isinstance(p, L.Scan):
            cols = None
            if required is not None:
                cols = [f.name for f in p.schema.fields if f.name in required]
                # a COUNT(*)-only plan still needs one column's row counts
                cols = cols or [p.schema.fields[0].name]
            return ParquetScanExec(p.paths, p.schema, self.device,
                                   self.conf.get(C.TASK_TARGET_BYTES),
                                   self.conf.get(C.BATCH_ROWS), cols)
        if isinstance(p, L.Filter):
            need = None if required is None \
                else required | p.condition.references()
            return TpuFilterExec(p.condition,
                                 self._lower(p.children[0], need))
        if isinstance(p, L.Project):
            need = set().union(*(e.references() for e in p.exprs))
            return TpuProjectExec(p.exprs, self._lower(p.children[0], need))
        if isinstance(p, L.Aggregate):
            need = set().union(*(e.references() for e in p.groups),
                               *(e.references() for na in p.aggs
                                 for e in na.fn.inputs()))
            return self._plan_aggregate(p, self._lower(p.children[0], need))
        raise NotImplementedError(
            f"{type(p).__name__} is not lowered by spark_rapids_tpu_torch")

    def _plan_aggregate(self, p: L.Aggregate, child: TpuExec) -> TpuExec:
        if child.num_partitions <= 1:
            return TpuHashAggregateExec(p.groups, p.aggs, child)
        partial = TpuHashAggregateExec(p.groups, p.aggs, child,
                                       mode="partial")
        if p.groups:
            keys = [BoundReference(i, f.dtype, f.nullable, f.name)
                    for i, f in enumerate(
                        partial.schema.fields[: len(p.groups)])]
            n = self.conf.get(C.SHUFFLE_PARTITIONS)
            source: TpuExec = TpuShuffleExchangeExec(
                HashPartitioning(keys, n), partial, self.manager)
        else:
            source = TpuCoalescePartitionsExec(partial)
        return TpuHashAggregateExec(p.groups, p.aggs, source, mode="final",
                                    input_schema=child.schema)
