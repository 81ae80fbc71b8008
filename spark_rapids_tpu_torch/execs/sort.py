"""Sort and top-n execs.

Counterparts of ``TpuSortExec``, ``TpuTopNExec`` and
``TpuTakeOrderedAndProjectExec`` in ``spark_rapids_tpu/execs/sort.py``.
Sort keys are expressions: they are evaluated per batch and sorted by
``ops/sort.py``.  A sort of one partition (``scope="global"``) sorts its
input; below a range exchange (``scope="partition"``) each partition is
sorted alone, and partition order is then the total order.

Up to ``sql.sort.singleBatchRows`` rows a partition sorts as one batch.
Above it the sort is the JAX exec's out-of-core sample-split sort (the
reference's GpuOutOfCoreSortIterator, redesigned): each batch, with its
keys evaluated and appended, waits in the buffer store while keys are
sampled (``samplesPerBatch`` rows a batch, once the running total
passes the threshold); bounds come from the pooled samples
(``ops/range_partition.choose_bounds``); every batch is split into at
most ``sql.sort.maxBuckets`` key-range buckets and parked on the host
(``register_host``: it may go on to disk); then each bucket is
assembled from its runs, uploaded, sorted alone and emitted in bound
order.  A bucket over twice the threshold (skewed keys) is sorted the
same way once more; past that it sorts as one batch.  Every step is
stable, so rows with equal keys come out in input order either way.
Collecting a batch is a unit of the OOM ladder.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    concat_batches,
)
from spark_rapids_tpu_torch.columnar.column import Column, StringColumn
from spark_rapids_tpu_torch.execs.base import Metrics, TaskRuntime, TpuExec
from spark_rapids_tpu_torch.execs.jit_cache import exprs_key
from spark_rapids_tpu_torch.execs.retry import with_split_retry
from spark_rapids_tpu_torch.exprs.base import (
    EvalContext,
    Expression,
    bind_references,
    output_field,
)
from spark_rapids_tpu_torch.memory.store import (
    SpillableBatch,
    SpillPriorities,
    batch_to_host,
    host_to_batch,
)
from spark_rapids_tpu_torch.ops.partition import id_counts
from spark_rapids_tpu_torch.ops.range_partition import (
    bucket_ids,
    choose_bounds,
)
from spark_rapids_tpu_torch.ops.sort import SortOrder, sort_permutation
from spark_rapids_tpu_torch.parallel.pipeline import device_read

#: primary key types a top-n can threshold (fixed width)
TOPN_PRIMARY_TYPES = (T.BooleanType, T.IntegralType, T.FractionalType,
                      T.DateType, T.TimestampType, T.DecimalType)


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

    def _keys_key(self) -> tuple:
        """The structural key of the sort keys (directions included)."""
        return tuple((exprs_key([k.expr]), k.descending, k.nulls_last)
                     for k in self.keys)


def _plain(c):
    """A column without its dictionary sidecar (a bucket's rows come
    from batches with different dictionaries)."""
    if isinstance(c, StringColumn):
        return StringColumn(c.chars, c.lengths, c.validity, c.dtype)
    if isinstance(c, Column):
        return Column(c.data, c.validity, c.dtype)
    return c  # a nested column carries no sidecar


def _host_rows(arrays: dict, start: int, stop: int) -> dict:
    """Rows [start, stop) of a host batch (``batch_to_host``'s layout,
    no sidecars), as views."""
    out = {k: t[start:stop] for k, t in arrays.items() if k != "__num_rows"}
    out["__num_rows"] = torch.tensor(stop - start, dtype=torch.int64)
    return out


class TpuSortExec(_SortMixin):
    """Each child partition sorted: in one batch up to
    ``single_batch_rows`` rows, out of core above (module docstring).
    ``scope="global"`` sorts a child of one partition;
    ``scope="partition"`` sorts every partition of a range-partitioned
    child and keeps its distribution.  ``metrics``: the out-of-core
    path's buckets, its rows, and the rows it parked on the host."""

    def __init__(self, keys: Sequence[SortKey], child: TpuExec,
                 scope: str = "global",
                 runtime: Optional[TaskRuntime] = None,
                 single_batch_rows: int = 1 << 21, max_buckets: int = 64,
                 samples_per_batch: int = 128):
        super().__init__(child)
        if scope not in ("global", "partition"):
            raise ValueError(f"unknown sort scope {scope!r}")
        if scope == "global" and child.num_partitions != 1:
            raise ValueError("a global TpuSortExec sorts one partition; "
                             "coalesce its child first")
        self.scope = scope
        self._bind(keys, child)
        self.runtime = runtime or TaskRuntime.serial()
        self.single_batch_rows = single_batch_rows
        self.max_buckets = max_buckets
        self.samples_per_batch = samples_per_batch
        self.metrics = Metrics("sortBuckets", "oocRows", "hostRows")
        self._n_data = len(child.schema)
        self.key_schema = T.Schema([T.Field(f"__sortkey{i}", k.expr.dtype)
                                    for i, k in enumerate(self.keys)])
        self.aug_schema = T.Schema(list(child.schema.fields)
                                   + list(self.key_schema.fields))
        self.key_orders = [SortOrder(i, k.descending, k.nulls_last)
                           for i, k in enumerate(self.keys)]

    @property
    def output_partitioning(self):
        return self.children[0].output_partitioning \
            if self.scope == "partition" else None

    def node_desc(self) -> str:
        return f"TpuSortExec [{describe_keys(self.keys)}] scope={self.scope}"

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        yield from self._sort_stream(self.children[0].execute_partition(p))

    # -- the augmented layout: data columns ++ evaluated keys ------------ #

    def _augment(self, batch: ColumnarBatch) -> ColumnarBatch:
        ctx = EvalContext.for_batch(batch)
        cols = [_plain(c) for c in batch.columns] \
            + [_plain(k.expr.eval(ctx)) for k in self.keys]
        return ColumnarBatch(cols, batch.num_rows, self.aug_schema,
                             batch.device)

    def _keys_of(self, aug: ColumnarBatch) -> ColumnarBatch:
        return aug.with_columns(aug.columns[self._n_data:], self.key_schema)

    def _sort_aug(self, aug: ColumnarBatch) -> ColumnarBatch:
        """Sorted by the appended keys (stable), keys dropped."""
        out = aug.gather(sort_permutation(self._keys_of(aug),
                                          self.key_orders))
        return ColumnarBatch(out.columns[: self._n_data], out.num_rows,
                             self.schema, out.device)

    def _sample(self, aug: ColumnarBatch, rng) -> ColumnarBatch:
        pos = rng.integers(0, aug.num_rows, self.samples_per_batch)
        return self._keys_of(aug).gather(
            torch.from_numpy(pos).to(aug.device))

    # -- driver ------------------------------------------------------------ #

    def _sort_stream(self, source, depth: int = 0
                     ) -> Iterator[ColumnarBatch]:
        """Collect (each batch a ladder unit), then sort in one batch or
        out of core.  ``depth`` > 0: ``source`` holds augmented batches
        of one oversized bucket."""
        store, policy = self.runtime.store, self.runtime.retry
        single = self.single_batch_rows
        handles: list[SpillableBatch] = []
        rows: list[int] = []
        samples: list[ColumnarBatch] = []
        rng = np.random.default_rng(0x5047 + depth)
        total = 0

        def ingest(b: ColumnarBatch):
            nonlocal total
            h0, s0, t0 = len(handles), len(samples), total
            try:
                aug = self._augment(b) if depth == 0 else b
                n = aug.num_rows
                crossing = total <= single < total + n
                total += n
                handles.append(store.register(
                    aug, SpillPriorities.COALESCE_PENDING))
                rows.append(n)
                if crossing:
                    # the threshold is passed: sample the batches before
                    for h in handles[:-1]:
                        try:
                            samples.append(self._sample(h.get(), rng))
                        finally:
                            h.unpin()
                if total > single:
                    samples.append(self._sample(aug, rng))
            except BaseException:
                for h in handles[h0:]:
                    h.close()
                del handles[h0:], rows[h0:], samples[s0:]
                total = t0
                raise
            return ()

        try:
            for b in source:
                if b.num_rows:
                    for _ in with_split_retry(ingest, b, "sort.collect",
                                              policy):
                        pass
            if total == 0:
                return
            if total <= single or len(handles) == 1:
                big = concat_batches([h.get() for h in handles])
                for h in handles:
                    h.close()
                handles.clear()
                sort = self.program("sort", lambda: (
                    self._keys_key(), repr(self.schema)), self._sort_aug)
                with self.timer() as t:
                    out = t.observe(sort(big))
                yield out
                return
            yield from self._merge_buckets(handles, total, samples, depth)
        finally:
            for h in handles:
                h.close()

    def _merge_buckets(self, handles: list, total: int, samples: list,
                       depth: int) -> Iterator[ColumnarBatch]:
        """Bounds, each batch split into host-parked bucket runs, then
        each bucket assembled, sorted and emitted in bound order."""
        if any(isinstance(f.dtype, T.NESTED_TYPES)
               for f in self.schema.fields):
            # its host runs are sliced by row, which an array's offsets
            # and children are not
            raise NotImplementedError(
                "the out-of-core sort of nested columns is not ported")
        store, single = self.runtime.store, self.single_batch_rows
        n_parts = min(max(2, -(-total // single)), self.max_buckets)
        self.metrics.add("sortBuckets", n_parts)
        self.metrics.add("oocRows", total)
        bounds = choose_bounds(concat_batches(samples), self.key_orders,
                               n_parts)
        runs: list[tuple[SpillableBatch, np.ndarray]] = []
        try:
            while handles:
                aug = handles[0].get()
                pids = bucket_ids(self._keys_of(aug), bounds, self.key_orders)
                grouped = aug.gather(torch.sort(pids, stable=True).indices)
                counts = device_read(id_counts(pids, n_parts),
                                     tag="sort.ooc.split")
                host = batch_to_host(grouped)
                del aug, grouped
                handles.pop(0).close()
                runs.append((store.register_host(
                    host, self.aug_schema, self.leaf_device(),
                    SpillPriorities.COALESCE_PENDING),
                    np.concatenate([[0], np.cumsum(counts)])))
                self.metrics.add("hostRows", int(counts.sum()))
            for b in range(n_parts):
                total_b = sum(int(offs[b + 1] - offs[b]) for _, offs in runs)
                if total_b == 0:
                    continue
                if depth < 1 and total_b > 2 * single:
                    yield from self._sort_stream(
                        self._bucket_chunks(runs, b, single), depth + 1)
                    continue
                yield self._sort_aug(concat_batches(
                    list(self._bucket_chunks(runs, b, total_b))))
        finally:
            for rh, _ in runs:
                rh.close()

    def _bucket_chunks(self, runs: list, b: int, chunk_rows: int
                       ) -> Iterator[ColumnarBatch]:
        """Bucket ``b``'s rows, run by run, uploaded in chunks of at most
        ``chunk_rows`` rows."""
        device = self.leaf_device()
        for rh, offs in runs:
            start, stop = int(offs[b]), int(offs[b + 1])
            if start == stop:
                continue
            arrays = rh.get_host()
            try:
                for off in range(start, stop, chunk_rows):
                    yield host_to_batch(
                        _host_rows(arrays, off, min(off + chunk_rows, stop)),
                        self.aug_schema, device)
            finally:
                rh.unpin()


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
        def key():
            return (self.n, self._keys_key())

        candidates = self.program("topn.candidates", key, self._candidates)
        final = self.program("topn.final", key, self._final)
        for batch in self.children[0].execute():
            if batch.num_rows == 0:
                continue
            with self.timer() as t:
                cand = t.observe(candidates(batch))
            pending.append(cand)
            rows += cand.num_rows
            if rows > self.reduce_rows and len(pending) > 1:
                with self.timer() as t:
                    pending = [t.observe(final(concat_batches(pending)))]
                rows = pending[0].num_rows
        pending = [b for b in pending if b.num_rows]
        if pending:
            with self.timer() as t:
                out = t.observe(final(concat_batches(pending)))
            yield out


class TpuTakeOrderedAndProjectExec(_SortMixin):
    """ORDER BY ... LIMIT n with an optional projection of the result:
    a running top n (each batch concatenated to it, sorted, cut to n
    rows), then the projection over the n rows.  No planner path builds
    it, in the JAX package either: ``_maybe_topn`` plans
    ``TpuTopNExec``."""

    def __init__(self, n: int, keys: Sequence[SortKey], child: TpuExec,
                 project: Optional[Sequence[Expression]] = None):
        super().__init__(child)
        if n < 0:
            raise ValueError(f"take-ordered of {n} rows")
        self.n = n
        self._bind(keys, child)
        self.project = None if project is None else [
            bind_references(e, child.schema) for e in project]
        self._schema = child.schema if project is None else T.Schema(
            [output_field(e, i) for i, e in enumerate(self.project)])

    @property
    def schema(self) -> T.Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return 1

    def node_desc(self) -> str:
        return (f"TpuTakeOrderedAndProjectExec n={self.n} "
                f"[{describe_keys(self.keys)}]")

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        if p != 0:
            return
        top: Optional[ColumnarBatch] = None
        for b in self.children[0].execute():
            merged = b if top is None else concat_batches([top, b])
            top = self._sorted(merged).slice_prefix(self.n)
        if top is None:
            return
        if self.project is not None:
            ctx = EvalContext.for_batch(top)
            top = ColumnarBatch([e.eval(ctx) for e in self.project],
                                top.num_rows, self._schema, top.device)
        yield top
