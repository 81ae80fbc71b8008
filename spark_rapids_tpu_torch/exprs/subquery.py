"""Scalar subqueries: a one-row, one-column query used as a value.

Counterpart of ``spark_rapids_tpu/exprs/subquery.py``.  The planner's
prepass (``plan/planner.py::Planner.plan``) runs each subplan once,
through the same planner on the session's device, and splices its value
in as a Literal before the outer plan is lowered, as Spark's driver
evaluates a scalar subquery eagerly.  The port has no CPU engine to
evaluate one instead, so ``eval`` raises.
"""

from __future__ import annotations

import dataclasses

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import Expression


@dataclasses.dataclass(repr=False)
class ScalarSubquery(Expression):
    """The value of ``plan`` (a LogicalPlan of one column that yields
    one row; none is NULL); replaced by the planner's prepass."""

    plan: object

    @property
    def dtype(self) -> T.DataType:
        return self.plan.schema.fields[0].dtype

    @property
    def name(self) -> str:
        return "scalar_subquery"

    def eval(self, ctx):
        raise NotImplementedError(
            "ScalarSubquery must be replaced by the planner's prepass")


def scalar_value(table):
    """The Python value of a subquery's result: NULL for no rows (Spark),
    ValueError for more than one row or column."""
    if table.num_columns != 1 or table.num_rows > 1:
        raise ValueError("scalar subquery must return one row of one "
                         f"column, got {table.num_rows}x{table.num_columns}")
    return table.column(0)[0].as_py() if table.num_rows else None
