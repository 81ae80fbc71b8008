"""The cost-based demotion, and row estimates of lowered physical plans.

Counterpart of ``spark_rapids_tpu/plan/cost.py`` (the reference's
optional CBO, CostBasedOptimizer.scala).  ``optimize_costs`` runs on the
tagged logical tree (``plan/planner.py::PlanMeta``), after ``tag()`` and
before lowering, with ``spark.rapids.tpu.sql.optimizer.enabled`` on (off
by default):

- an island is a largest subtree of nodes the tags left on the device;
- its device cost is ``tpuRowCost`` times the rows each of its nodes
  processes (its inputs' estimates; a leaf's own), plus
  ``transferRowCost`` times the rows that cross into it (a source leaf's
  output, a CPU child's output) and out of it (its root's output);
- its CPU cost is ``cpuRowCost`` times the same processed rows.

An island whose device cost passes its CPU cost has every node tagged
``DEMOTION_REASON``, so the planner lowers the region as CPU fallbacks
that fuse into one CPU table, with no round trip through the card.  Rows
are the logical plan's upper bounds (``plan/logical.py``
``estimated_rows``); an unknown estimate anywhere in an island never
demotes it.  The constants and the reason's text are the JAX package's
(the text says "TPU": ``explain()`` shows it as it is).

``exec_estimated_rows`` is the runtime-filter pass's gate on the build
side's size, over the physical nodes the port has.  (The broadcast
choice reads the logical plan's estimates.)
"""

from __future__ import annotations

from typing import Optional

from spark_rapids_tpu_torch import config as C

DEMOTION_REASON = "not cost-effective on TPU (cost-based optimizer)"


def _rows(p) -> Optional[int]:
    return p.estimated_rows()


def _work_rows(p) -> Optional[int]:
    """Rows an operator processes: its inputs' (an aggregate reads a
    million rows to make ten), a leaf's own output."""
    if p.children:
        total = 0
        for c in p.children:
            r = _rows(c)
            if r is None:
                return None
            total += r
        return total
    return _rows(p)


def optimize_costs(meta) -> None:
    """Tag every node of each island whose device cost passes its CPU
    cost with ``DEMOTION_REASON`` (``meta``: the tagged root)."""
    conf = meta.conf
    if not conf.get(C.CBO_ENABLED):
        return
    costs = (conf.get(C.CPU_ROW_COST), conf.get(C.TPU_ROW_COST),
             conf.get(C.TRANSFER_ROW_COST))

    def walk(m, parent_replaceable: bool) -> None:
        if m.can_replace and not parent_replaceable:
            _consider_island(m, *costs)
            # the island's nodes were weighed: go on below its frontier
            for f in _frontier(m):
                for c in f.children:
                    walk(c, False)
        else:
            for c in m.children:
                walk(c, m.can_replace)

    walk(meta, False)


def _frontier(island_root) -> list:
    """The CPU nodes hanging right below an island."""
    out = []

    def rec(m):
        for c in m.children:
            if c.can_replace:
                rec(c)
            else:
                out.append(c)
    rec(island_root)
    return out


def _consider_island(root, cpu_c: float, tpu_c: float,
                     xfer_c: float) -> None:
    nodes = []

    def rec(m):
        nodes.append(m)
        for c in m.children:
            if c.can_replace:
                rec(c)
    rec(root)

    op_rows, entry_rows = [], []
    for m in nodes:
        w = _work_rows(m.plan)
        if w is None:
            return  # unknown work: never demote on a guess
        op_rows.append(w)
        if not m.plan.children:
            r = _rows(m.plan)  # a source: its output is uploaded
            if r is None:
                return
            entry_rows.append(r)
        else:
            for c in m.children:
                if not c.can_replace:
                    r = _rows(c.plan)  # a CPU child's output is uploaded
                    if r is None:
                        return
                    entry_rows.append(r)
    exit_rows = _rows(root.plan)
    if exit_rows is None:
        return
    tpu_cost = tpu_c * sum(op_rows) + xfer_c * (sum(entry_rows) + exit_rows)
    if tpu_cost > cpu_c * sum(op_rows):
        for m in nodes:
            m.will_not_work(DEMOTION_REASON)


def exec_estimated_rows(node) -> Optional[int]:
    """An upper bound on a physical subtree's rows: a scan answers with
    its files' footer rows (the logical scan's estimate, copied on at
    lowering), an in-memory source with its table's rows and a range
    with its values; nodes that can only keep or drop rows pass their
    child's bound on, an Expand multiplies it by its projections, a
    union sums its members', and any other node is unknown (None), on
    which the caller never acts."""
    from spark_rapids_tpu_torch.execs.basic import (
        TpuFilterExec,
        TpuProjectExec,
        TpuRangeExec,
        TpuUnionExec,
    )
    from spark_rapids_tpu_torch.execs.exchange import (
        TpuCoalescePartitionsExec,
        TpuShuffleExchangeExec,
    )
    from spark_rapids_tpu_torch.execs.expand import TpuExpandExec
    from spark_rapids_tpu_torch.execs.join import TpuRuntimeFilterBuildExec
    from spark_rapids_tpu_torch.io.scan import (
        ArrowSourceExec,
        ParquetScanExec,
    )

    if isinstance(node, (ParquetScanExec, ArrowSourceExec)):
        return node.estimated_rows
    if isinstance(node, TpuRangeExec):
        return node.total
    if isinstance(node, (TpuFilterExec, TpuProjectExec,
                         TpuShuffleExchangeExec, TpuCoalescePartitionsExec,
                         TpuRuntimeFilterBuildExec)):
        return exec_estimated_rows(node.children[0])
    if isinstance(node, TpuExpandExec):
        n = exec_estimated_rows(node.children[0])
        return None if n is None else n * len(node.projections)
    if isinstance(node, TpuUnionExec):
        rows = [exec_estimated_rows(c) for c in node.children]
        return None if None in rows else sum(rows)
    return None
