"""Sort and top-n execs.

Counterparts of ``TpuSortExec`` and ``TpuTopNExec`` in
``spark_rapids_tpu/execs/sort.py``.  Sort keys are expressions: they
are evaluated per batch and sorted by ``ops/sort.py``.  A sort of one
partition (``scope="global"``) sorts its input in memory; below a
range exchange (``scope="partition"``) each partition is sorted alone,
and partition order is then the total order.  The out-of-core
sample-split sort is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    concat_batches,
)
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.exprs.base import (
    EvalContext,
    Expression,
    bind_references,
)
from spark_rapids_tpu_torch.ops.sort import SortOrder, sort_permutation

#: primary key types a top-n can threshold (fixed width)
TOPN_PRIMARY_TYPES = (T.BooleanType, T.IntegerType, T.LongType,
                      T.DoubleType, T.DateType)
#: LIMIT values up to this plan ORDER BY + LIMIT as a top-n (the JAX
#: package's spark.rapids.tpu.sql.topn.maxRows default)
TOPN_MAX_ROWS = 1 << 14


@dataclasses.dataclass
class SortKey:
    """Front-end sort key: expression, direction, NULL placement."""

    expr: Expression
    descending: bool = False
    nulls_last: bool = False


def describe_keys(keys: Sequence[SortKey]) -> str:
    return ", ".join(f"{k.expr.name}{' DESC' if k.descending else ''}"
                     for k in keys)


class _SortMixin(TpuExec):
    def _bind(self, keys: Sequence[SortKey], child: TpuExec) -> None:
        self.keys = [SortKey(bind_references(k.expr, child.schema),
                             k.descending, k.nulls_last) for k in keys]

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    def _sorted(self, batch: ColumnarBatch) -> ColumnarBatch:
        """The batch in the keys' order (stable)."""
        ctx = EvalContext.for_batch(batch)
        cols = [k.expr.eval(ctx) for k in self.keys]
        key_schema = T.Schema([T.Field(f"__sortkey{i}", k.expr.dtype)
                               for i, k in enumerate(self.keys)])
        keys = ColumnarBatch(cols, batch.num_rows, key_schema, batch.device)
        orders = [SortOrder(i, k.descending, k.nulls_last)
                  for i, k in enumerate(self.keys)]
        return batch.gather(sort_permutation(keys, orders))


class TpuSortExec(_SortMixin):
    """An in-memory sort: each child partition's batches concatenated
    and sorted once.  ``scope="global"`` sorts a child of one partition;
    ``scope="partition"`` sorts every partition of a range-partitioned
    child and keeps its distribution."""

    def __init__(self, keys: Sequence[SortKey], child: TpuExec,
                 scope: str = "global"):
        super().__init__(child)
        if scope not in ("global", "partition"):
            raise ValueError(f"unknown sort scope {scope!r}")
        if scope == "global" and child.num_partitions != 1:
            raise ValueError("a global TpuSortExec sorts one partition; "
                             "coalesce its child first")
        self.scope = scope
        self._bind(keys, child)

    @property
    def output_partitioning(self):
        return self.children[0].output_partitioning \
            if self.scope == "partition" else None

    def node_desc(self) -> str:
        return f"TpuSortExec [{describe_keys(self.keys)}] scope={self.scope}"

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        parts = [b for b in self.children[0].execute_partition(p)
                 if b.num_rows]
        if parts:
            yield self._sorted(concat_batches(parts))


class TpuTopNExec(_SortMixin):
    """ORDER BY + LIMIT n as a streaming top-n: each batch keeps only
    its candidates, the rows at or beyond its n-th best primary key,
    and one final sort of the candidates takes the first n.

    A row worse than n rows on the primary key alone is not in the top
    n whatever the later keys say, so keeping every row tied with the
    threshold (and the NULLs their placement may need) keeps a superset
    of the answer.  The primary key's image for ``torch.topk`` is
    monotone in the sort order (NaN as +inf, -0.0 as 0.0: order-keeping,
    tie-making).  When the candidates pass ``max(4n, 2^16)`` rows they
    are cut to their own top n, which keeps every top-n row they hold."""

    def __init__(self, n: int, keys: Sequence[SortKey], child: TpuExec):
        super().__init__(child)
        if n <= 0:
            raise ValueError(f"top-n of {n} rows")
        self.n = n
        self._bind(keys, child)
        primary = self.keys[0].expr.dtype
        if not isinstance(primary, TOPN_PRIMARY_TYPES):
            raise TypeError(f"top-n primary key of type {primary}")
        self.reduce_rows = max(4 * n, 1 << 16)

    @property
    def num_partitions(self) -> int:
        return 1

    def node_desc(self) -> str:
        return f"TpuTopNExec n={self.n} [{describe_keys(self.keys)}]"

    def _primary_scalar(self, data: torch.Tensor) -> torch.Tensor:
        """Larger = earlier in the sort order."""
        if data.is_floating_point():
            v = torch.where(torch.isnan(data),
                            torch.full_like(data, float("inf")), data)
            return v if self.keys[0].descending else -v
        v = data.long()
        return v if self.keys[0].descending else ~v

    def _candidates(self, batch: ColumnarBatch) -> ColumnarBatch:
        kc = self.keys[0].expr.eval(EvalContext.for_batch(batch))
        valid = kc.validity
        s = self._primary_scalar(kc.data)
        lowest = float("-inf") if s.is_floating_point() \
            else torch.iinfo(torch.int64).min
        sm = torch.where(valid, s, torch.full_like(s, lowest))
        k = min(self.n, batch.num_rows)
        thr = torch.topk(sm, k, sorted=True).values[k - 1]
        keep = valid & (sm >= thr)
        if self.keys[0].nulls_last:
            # NULLs matter only when the non-NULL rows cannot fill n
            keep |= ~valid & (valid.sum() < self.n)
        else:
            keep |= ~valid  # NULLs come first: every one is a candidate
        return batch.compact(keep)

    def _final(self, batch: ColumnarBatch) -> ColumnarBatch:
        return self._sorted(batch).slice_prefix(self.n)

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        if p != 0:
            return
        pending: list[ColumnarBatch] = []
        rows = 0
        for batch in self.children[0].execute():
            if batch.num_rows == 0:
                continue
            cand = self._candidates(batch)
            pending.append(cand)
            rows += cand.num_rows
            if rows > self.reduce_rows and len(pending) > 1:
                pending = [self._final(concat_batches(pending))]
                rows = pending[0].num_rows
        pending = [b for b in pending if b.num_rows]
        if pending:
            yield self._final(concat_batches(pending))
