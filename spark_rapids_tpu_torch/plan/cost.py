"""Row estimates of lowered physical plans.

Counterpart of ``exec_estimated_rows`` in
``spark_rapids_tpu/plan/cost.py``, for the physical nodes the port has:
the runtime-filter pass's gate on the build side's size.  (The
broadcast choice reads the logical plan's estimates,
``plan/logical.py``.)  The JAX module's cost-based demotion to the CPU
engine is not ported: only the tags send a node there
(``plan/planner.py``).
"""

from __future__ import annotations

from typing import Optional


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
