"""Logical -> physical lowering.

Counterpart of ``spark_rapids_tpu/plan/planner.py`` for Scan,
InMemoryRelation, RangeRel, Filter, Project, Aggregate, Expand, Join,
Window, Sort, Limit and Union.  Scan and in-memory columns are pruned
to what the plan above reads: an Expand keeps only the columns read
above it and needs what their expressions read in every projection; a
Union prunes by position (its members name their columns apart, as
q5's ``ss_store_sk`` and ``sr_store_sk``), each member projected to the
kept positions where its own lowering kept more.

- An aggregate over several input partitions lowers as
  ``_plan_aggregate`` does there: partial aggregate -> hash exchange on
  the group keys -> final aggregate (a grand aggregate coalesces its
  partials instead of hashing them); a single partition aggregates
  completely.
- A join lowers as ``_plan_join`` does there.  When a legal build side
  is estimated at most ``autoBroadcastJoinThresholdBytes`` (10 MiB;
  ``broadcast_candidates``, from ``plan/logical.py``'s estimates), the
  smaller such side is broadcast.  Otherwise a keyed join whose key
  types match on both sides, with more than one input partition on
  either, takes a hash exchange on each side's keys (unless the side is
  already distributed so) under a partition-wise join.  Only identical
  key types hash alike, so other joins, and keyless ones, run as one
  wide join.  Adaptive and collective joins are not ported.
- Once the plan is lowered, ``inject_runtime_filters`` adds a runtime
  join filter to each eligible join (``plan/runtime_filter.py``).
- A window with partition keys over several input partitions lowers
  as the JAX planner's ``L.Window`` branch: a hash exchange on the
  partition keys (unless the child is already hash-distributed so)
  under a per-partition ``TpuWindowExec``; any other window drains its
  input into one batch.
- A sort over several partitions lowers as ``_plan_sort``: a range
  exchange (bounds from a sample) under a partition-scoped sort, whose
  partitions come out in key order (``sort.rangeExchange`` off, or one
  input partition: coalesce and sort once).  A LIMIT over a sort with a
  fixed-width primary key becomes a streaming top-n (``_maybe_topn``,
  which reads the sort's input before any exchange), any other LIMIT a
  collect or global limit.
- Only a hash distribution satisfies a join, an aggregate or a window:
  a range exchange's does not (``_hash_satisfies``).

The planner hands the scans, exchanges and coalesces one
``TaskRuntime``: the session's task semaphore and upload stream, and
``sql.taskThreads``, ``sql.scan.decodeThreads`` and the stage depth
from its conf.

A node this port cannot lower raises NotImplementedError: there is no
CPU fallback engine.
"""

from __future__ import annotations

from typing import Optional

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.execs.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.execs.base import TaskRuntime, TpuExec
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
from spark_rapids_tpu_torch.execs.join import (
    TpuBroadcastHashJoinExec,
    TpuShuffledHashJoinExec,
)
from spark_rapids_tpu_torch.execs.limit import (
    TpuCollectLimitExec,
    TpuGlobalLimitExec,
)
from spark_rapids_tpu_torch.execs.sort import (
    TOPN_MAX_ROWS,
    TOPN_PRIMARY_TYPES,
    TpuSortExec,
    TpuTopNExec,
)
from spark_rapids_tpu_torch.execs.window import TpuWindowExec
from spark_rapids_tpu_torch.exprs.base import BoundReference, bind_references
from spark_rapids_tpu_torch.io.scan import ArrowSourceExec, ParquetScanExec
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.ops.partition import (
    HashPartitioning,
    RangePartitioning,
)
from spark_rapids_tpu_torch.parallel.pipeline import stage_depth
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.runtime_filter import inject_runtime_filters
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager


class Planner:
    """Lowers logical plans for one session: its conf, device, shuffle
    manager, task semaphore (None: one sized by the conf) and upload
    stream (None: uploads on the consumer's stream)."""

    def __init__(self, conf: C.TorchConf, device: torch.device,
                 manager: ShuffleManager,
                 semaphore: Optional[TpuSemaphore] = None,
                 upload_stream=None):
        self.conf = conf
        self.device = device
        self.manager = manager
        self.runtime = TaskRuntime(
            semaphore or TpuSemaphore(conf.get(C.CONCURRENT_TASKS)),
            task_threads=conf.get(C.TASK_THREADS),
            decode_threads=conf.get(C.DECODE_THREADS),
            stage_depth=stage_depth(conf), upload_stream=upload_stream)

    def plan(self, plan: L.LogicalPlan) -> TpuExec:
        root = self._lower(plan, None)
        inject_runtime_filters(root, self.conf)
        return root

    def _lower(self, p: L.LogicalPlan, required: Optional[set]) -> TpuExec:
        """``required``: column names the parent reads (None = all)."""
        if isinstance(p, L.Scan):
            return ParquetScanExec(p.paths, p.schema, self.device,
                                   self.conf.get(C.TASK_TARGET_BYTES),
                                   self.conf.get(C.BATCH_ROWS),
                                   _leaf_columns(p.schema, required),
                                   p.estimated_rows(), self.runtime)
        if isinstance(p, L.InMemoryRelation):
            return ArrowSourceExec(p.table, p.schema, self.device,
                                   self.conf.get(C.BATCH_ROWS),
                                   _leaf_columns(p.schema, required),
                                   self.runtime)
        if isinstance(p, L.RangeRel):
            return TpuRangeExec(p.start, p.end, p.step, self.device,
                                self.conf.get(C.BATCH_ROWS))
        if isinstance(p, L.Expand):
            keep = _kept_positions(p.schema, required)
            need = set().union(*(proj[i].references()
                                 for proj in p.projections for i in keep))
            return TpuExpandExec(
                [[proj[i] for i in keep] for proj in p.projections],
                T.Schema([p.schema.fields[i] for i in keep]),
                self._lower(p.children[0], need))
        if isinstance(p, L.Union):
            return self._plan_union(p, required)
        if isinstance(p, L.Filter):
            need = None if required is None \
                else required | p.condition.references()
            return TpuFilterExec(p.condition,
                                 self._lower(p.children[0], need))
        if isinstance(p, L.Project):
            need = set().union(*(e.references() for e in p.exprs))
            if any(_by_position(e) for e in p.exprs):
                need = None  # ordinals of the unpruned child
            return TpuProjectExec(p.exprs, self._lower(p.children[0], need))
        if isinstance(p, L.Aggregate):
            need = set().union(*(e.references() for e in p.groups),
                               *(e.references() for na in p.aggs
                                 for e in na.fn.inputs()))
            return self._plan_aggregate(p, self._lower(p.children[0], need))
        if isinstance(p, L.Join):
            cond = set() if p.condition is None \
                else p.condition.references()
            sides = []
            for child, keys, keep in (
                    (p.children[0], p.left_keys, True),
                    (p.children[1], p.right_keys,
                     p.join_type not in ("left_semi", "left_anti"))):
                need = None
                if required is not None:
                    # each side: its keys, and what the parent reads of
                    # its half of the output
                    need = set().union(*(k.references() for k in keys))
                    names = set(child.schema.names)
                    need |= cond & names
                    if keep:
                        need |= required & names
                sides.append(self._lower(child, need))
            return self._plan_join(p, *sides)
        if isinstance(p, L.Window):
            need = None
            if required is not None:
                made = {name for _, name in p.window_exprs}
                need = (required - made).union(
                    *(we.references() for we, _ in p.window_exprs))
            return self._plan_window(p, self._lower(p.children[0], need))
        if isinstance(p, L.Sort):
            need = None if required is None else required.union(
                *(k.expr.references() for k in p.keys))
            return self._plan_sort(p, self._lower(p.children[0], need))
        if isinstance(p, L.Limit):
            child = self._lower(p.children[0], required)
            topn = self._maybe_topn(p, child)
            if topn is not None:
                return topn
            if child.num_partitions > 1:
                return TpuCollectLimitExec(p.n, child)
            return TpuGlobalLimitExec(p.n, child)
        raise NotImplementedError(
            f"{type(p).__name__} is not lowered by spark_rapids_tpu_torch")

    def _plan_union(self, p: L.Union, required: Optional[set]) -> TpuExec:
        """Each member lowered for the kept positions' names, then
        projected to exactly those positions where it kept more (a
        member with a name twice is lowered whole and projected by
        position)."""
        keep = _kept_positions(p.schema, required)
        members = []
        for child in p.children:
            names = child.schema.names
            unique = len(set(names)) == len(names)
            need = None if required is None or not unique \
                else {names[i] for i in keep}
            m = self._lower(child, need)
            ords = [m.schema.index_of(names[i]) for i in keep] if unique \
                else keep
            if ords != list(range(len(m.schema))):
                m = TpuProjectExec([
                    BoundReference(o, m.schema.fields[o].dtype,
                                   m.schema.fields[o].nullable,
                                   m.schema.fields[o].name)
                    for o in ords], m)
            members.append(m)
        return TpuUnionExec(T.Schema([p.schema.fields[i] for i in keep]),
                            *members)

    def _exchange(self, partitioning, child: TpuExec
                  ) -> TpuShuffleExchangeExec:
        return TpuShuffleExchangeExec(
            partitioning, child, self.manager,
            self.conf.get(C.SORT_SAMPLES_PER_BATCH), self.runtime)

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
            source: TpuExec = self._exchange(HashPartitioning(keys, n),
                                             partial)
        else:
            source = TpuCoalescePartitionsExec(partial, self.runtime)
        return TpuHashAggregateExec(p.groups, p.aggs, source, mode="final",
                                    input_schema=child.schema)

    def _plan_window(self, p: L.Window, child: TpuExec) -> TpuExec:
        part_by = p.window_exprs[0][0].spec.partition_by
        if not part_by or child.num_partitions <= 1:
            return TpuWindowExec(p.window_exprs, child)
        bound = [bind_references(e, child.schema) for e in part_by]
        if _hash_satisfies(child, bound) is None:
            n = self.conf.get(C.SHUFFLE_PARTITIONS)
            child = self._exchange(HashPartitioning(part_by, n), child)
        return TpuWindowExec(p.window_exprs, child, partitioned=True)

    def _plan_sort(self, p: L.Sort, child: TpuExec) -> TpuExec:
        if child.num_partitions > 1 and self.conf.get(C.SORT_RANGE_EXCHANGE):
            n = self.conf.get(C.SHUFFLE_PARTITIONS)
            ex = self._exchange(RangePartitioning(p.keys, n), child)
            return TpuSortExec(p.keys, ex, scope="partition")
        if child.num_partitions > 1:
            child = TpuCoalescePartitionsExec(child, self.runtime)
        return TpuSortExec(p.keys, child)

    def _maybe_topn(self, p: L.Limit, child: TpuExec) -> Optional[TpuExec]:
        """LIMIT n over a sort with a fixed-width primary key -> a
        streaming top-n over the sort's input before its coalesce or
        range exchange (the top-n drains every partition)."""
        if not (isinstance(child, TpuSortExec)
                and 0 < p.n <= TOPN_MAX_ROWS
                and isinstance(child.keys[0].expr.dtype,
                               TOPN_PRIMARY_TYPES)):
            return None
        source = child.children[0]
        if isinstance(source, TpuCoalescePartitionsExec) or (
                isinstance(source, TpuShuffleExchangeExec)
                and isinstance(source.partitioning, RangePartitioning)):
            source = source.children[0]
        return TpuTopNExec(p.n, child.keys, source)

    def _plan_join(self, p: L.Join, left: TpuExec,
                   right: TpuExec) -> TpuExec:
        chunk = self.conf.get(C.JOIN_OUTPUT_CHUNK_ROWS)
        args = (p.left_keys, p.right_keys, p.join_type, left, right, chunk,
                p.condition)
        candidates = broadcast_candidates(
            p.join_type, p.children[0].estimated_bytes(),
            p.children[1].estimated_bytes(),
            self.conf.get(C.BROADCAST_THRESHOLD))
        if candidates:
            side = min(candidates, key=lambda c: c[1])[0]
            return TpuBroadcastHashJoinExec(*args, build_side=side)
        lkeys = [bind_references(k, left.schema) for k in p.left_keys]
        rkeys = [bind_references(k, right.schema) for k in p.right_keys]
        # both sides hash a key alike only when its types are identical
        same_types = all(lk.dtype == rk.dtype
                         for lk, rk in zip(lkeys, rkeys))
        if not (lkeys and p.join_type != "cross" and same_types) or (
                left.num_partitions <= 1 and right.num_partitions <= 1):
            return TpuShuffledHashJoinExec(*args)
        lsat = _hash_satisfies(left, lkeys)
        rsat = _hash_satisfies(right, rkeys)
        if lsat is not None:
            n = lsat.num_partitions
            if rsat is not None and rsat.num_partitions != n:
                rsat = None  # mismatched widths: re-shuffle the right
        elif rsat is not None:
            n = rsat.num_partitions
        else:
            n = self.conf.get(C.SHUFFLE_PARTITIONS)
        if lsat is None:
            left = self._exchange(HashPartitioning(p.left_keys, n), left)
        if rsat is None:
            right = self._exchange(HashPartitioning(p.right_keys, n), right)
        return TpuShuffledHashJoinExec(p.left_keys, p.right_keys,
                                       p.join_type, left, right, chunk,
                                       p.condition, partition_wise=True)


def _by_position(e) -> bool:
    """True when the expression reads a column by its ordinal."""
    return isinstance(e, BoundReference) or any(_by_position(c)
                                                for c in e.children)


def _kept_positions(schema: T.Schema, required: Optional[set]
                    ) -> list[int]:
    """The positions of ``schema`` whose names the parent reads (all of
    them for None); a COUNT(*)-only parent still needs one column's row
    counts, so never none."""
    if required is None:
        return list(range(len(schema)))
    return [i for i, n in enumerate(schema.names) if n in required] or [0]


def _leaf_columns(schema: T.Schema, required: Optional[set]
                  ) -> Optional[list[str]]:
    """The columns a source reads: None for all."""
    if required is None:
        return None
    return [schema.names[i] for i in _kept_positions(schema, required)]


def broadcast_candidates(join_type: str, lbytes: Optional[int],
                         rbytes: Optional[int],
                         threshold: int) -> list[tuple[str, int]]:
    """The legal (build side, estimated bytes) pairs of a broadcast
    join within the threshold: an outer join builds the side it does not
    preserve, full_outer never broadcasts, -1 disables."""
    out: list[tuple[str, int]] = []
    if threshold < 0 or join_type == "full_outer":
        return out
    if join_type in ("inner", "cross", "left_outer", "left_semi",
                     "left_anti") and rbytes is not None \
            and rbytes <= threshold:
        out.append(("right", rbytes))
    if join_type in ("inner", "cross", "right_outer") \
            and lbytes is not None and lbytes <= threshold:
        out.append(("left", lbytes))
    return out


def _hash_satisfies(exec_: TpuExec,
                    keys: list) -> Optional[HashPartitioning]:
    """The child's hash distribution when it hashes exactly these key
    columns (same ordinals, same types), else None."""
    part = exec_.output_partitioning
    if not isinstance(part, HashPartitioning) \
            or len(part.exprs) != len(keys):
        return None
    for pe, jk in zip(part.exprs, keys):
        if not (isinstance(pe, BoundReference)
                and isinstance(jk, BoundReference)
                and pe.ordinal == jk.ordinal and pe.dtype == jk.dtype):
            return None
    return part
