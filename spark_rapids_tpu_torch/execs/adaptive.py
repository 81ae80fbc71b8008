"""Adaptive execution: a join's strategy from measured map output.

Counterpart of ``spark_rapids_tpu/execs/adaptive.py`` (Spark's
AdaptiveSparkPlanExec, the reference's GpuCustomShuffleReaderExec).
The exchanges under a partition-wise join double as query stages: once
both map stages have run, ``materialize_stats`` gives each reduce
partition's (bytes, rows), and the join is decided on those instead of
the planner's scan-time estimates.

- ``TpuAdaptiveJoinExec`` runs both map stages, then picks one of two
  device plans.  When a legal build side's measured bytes fit
  ``autoBroadcastJoinThresholdBytes`` (``plan/planner.py::
  broadcast_candidates``), a ``TpuBroadcastHashJoinExec`` whose build
  reads that side's shuffled blocks: nothing is scanned again.
  Otherwise the partition-wise ``TpuShuffledHashJoinExec``, over
  skew-split reads when a partition is skewed, else over groups of
  adjacent partitions coalesced up to ``advisoryPartitionSizeBytes``,
  else over the exchanges as planned.  It never catches a failure: the
  choice is made from bytes before either plan runs.
- ``CoalescedShuffleReaderExec`` reads groups of read units as
  partitions: a whole reduce partition, or the ``i``-th of ``k``
  block-wise slices of one (the stream side of a skew split, each slice
  paired with a whole read of the other side).

The join's ``num_partitions`` is its static plan's width: parents and
``explain()`` read it while the plan is built, so reading it must run
no map stage.  A coalesced plan leaves the tail partitions empty; a
skew split can make more tasks than the width, and the last static
partition runs the overflow.  Both map stages run under the decision's
lock; a task reaches it at its first pull, before it holds a permit of
the task semaphore, so the map tasks find permits.

The bytes measured are the store's bytes of the committed blocks,
which hold live rows only: they may be fewer than the JAX package's
for the same data (no power-of-two capacity, no string width buckets),
so a decision near a threshold can differ from its.
"""

from __future__ import annotations

import statistics
import threading
from typing import Iterator, Optional, Sequence

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.execs.base import Metrics, TaskRuntime, TpuExec
from spark_rapids_tpu_torch.execs.join import (
    TpuBroadcastHashJoinExec,
    TpuShuffledHashJoinExec,
)
from spark_rapids_tpu_torch.exprs.base import Expression

#: one reduce-side read unit: (reduce id, slice index, slice count);
#: (rid, 0, 1) reads the whole partition
PartSpec = tuple


def plan_coalesced_groups(part_bytes: Sequence[int],
                          target: int) -> list[list[int]]:
    """Adjacent reduce partitions grouped until each group reaches
    ``target`` bytes (every side grouped alike keeps them
    co-partitioned); empty partitions merge for free."""
    groups: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    for rid, b in enumerate(part_bytes):
        cur.append(rid)
        cur_bytes += b
        if cur_bytes >= target:
            groups.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        groups.append(cur)
    return groups or [[0]]


def _skew_split_side(join_type: str) -> Optional[str]:
    """The side that may be sliced: each of its rows lands in one slice,
    so an inner join or one that preserves that side stays right; the
    other side is read whole a slice."""
    if join_type == "inner":
        return "either"
    if join_type in ("left_outer", "left_semi", "left_anti"):
        return "left"
    if join_type == "right_outer":
        return "right"
    return None  # full_outer: no single side splits soundly


def plan_skew_groups(lbytes: Sequence[int], rbytes: Sequence[int],
                     target: int, factor: float, threshold: int,
                     join_type: str,
                     lblocks: Optional[Sequence[int]] = None,
                     rblocks: Optional[Sequence[int]] = None
                     ) -> Optional[tuple[list, list, int]]:
    """(left groups, right groups, slices) of read units that pair one
    to one into join tasks, or None when no partition is skewed.  A
    partition is skewed when its bytes pass ``threshold`` and ``factor``
    times its side's median; it becomes k tasks, k slices of the
    splittable side each with a whole read of the other side.  k is the
    bytes over ``target`` (at least 2), at most the partition's blocks;
    a partition of one block stays whole."""
    side = _skew_split_side(join_type)
    if side is None or not lbytes:
        return None
    med_l = statistics.median(lbytes)
    med_r = statistics.median(rbytes)

    def skewed(b, med) -> bool:
        return b > threshold and b > factor * max(med, 1)

    lgroups: list[list[PartSpec]] = []
    rgroups: list[list[PartSpec]] = []
    plain: list[int] = []
    plain_bytes: list[int] = []
    n_splits = 0

    def flush_plain() -> None:
        if not plain:
            return
        for grp in plan_coalesced_groups(plain_bytes, target):
            rids = [plain[i] for i in grp]
            lgroups.append([(r, 0, 1) for r in rids])
            rgroups.append([(r, 0, 1) for r in rids])
        plain.clear()
        plain_bytes.clear()

    for rid, (lb, rb) in enumerate(zip(lbytes, rbytes)):
        split_left = skewed(lb, med_l) and side in ("left", "either")
        split_right = skewed(rb, med_r) and side in ("right", "either")
        if split_left and split_right:
            # both sides sliced would need every pair of slices: split
            # the bigger side only
            if lb >= rb:
                split_right = False
            else:
                split_left = False
        if not (split_left or split_right):
            plain.append(rid)
            plain_bytes.append(lb + rb)
            continue
        flush_plain()
        blocks = lblocks if split_left else rblocks
        n_blocks = None if blocks is None or rid >= len(blocks) \
            else blocks[rid]
        if n_blocks is not None and n_blocks <= 1:
            plain.append(rid)  # one block cannot slice: left whole
            plain_bytes.append(lb + rb)
            continue
        k = max(2, -(-(lb if split_left else rb) // max(target, 1)))
        if n_blocks is not None:
            # slices deal blocks: one past the blocks would be a task
            # with no rows that still reads the whole other side
            k = min(k, n_blocks)
        n_splits += k
        for i in range(k):
            if split_left:
                lgroups.append([(rid, i, k)])
                rgroups.append([(rid, 0, 1)])
            else:
                lgroups.append([(rid, 0, 1)])
                rgroups.append([(rid, i, k)])
    if n_splits == 0:
        return None
    flush_plain()
    return lgroups, rgroups, n_splits


class CoalescedShuffleReaderExec(TpuExec):
    """An exchange read in groups of read units, each group a partition.
    A reduce partition that several units visit (a skew split's slices,
    or the whole partition paired with each) is read with
    ``execute_partition_keep``, which leaves its blocks registered; any
    other is read and released.  ``partition_rows`` counts the rows each
    group yielded."""

    def __init__(self, exchange: TpuExec, groups: list):
        super().__init__(exchange)
        self.groups = [[(g, 0, 1) if isinstance(g, int) else tuple(g)
                        for g in grp] for grp in groups]
        visits: dict[int, int] = {}
        for grp in self.groups:
            for rid, _i, _k in grp:
                visits[rid] = visits.get(rid, 0) + 1
        self._multi_read = {r for r, c in visits.items() if c > 1}
        self._rows_lock = threading.Lock()
        self.partition_rows = [0] * len(self.groups)

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    @property
    def num_partitions(self) -> int:
        return len(self.groups)

    def node_desc(self) -> str:
        n_raw = self.children[0].num_partitions
        n_split = sum(1 for grp in self.groups
                      for (_r, _i, k) in grp if k > 1)
        extra = f", {n_split} skew slices" if n_split else ""
        return (f"CoalescedShuffleReaderExec [{n_raw} -> "
                f"{len(self.groups)} partitions{extra}]")

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        ex = self.children[0]
        for rid, i, k in self.groups[p]:
            source = ex.execute_partition_keep(rid, i, k) \
                if rid in self._multi_read else ex.execute_partition(rid)
            for b in source:
                with self._rows_lock:
                    self.partition_rows[p] += b.num_rows
                yield b

    def slice_rows(self) -> list[int]:
        """The rows each group holding a skew slice yielded."""
        return [self.partition_rows[p] for p, grp in enumerate(self.groups)
                if any(k > 1 for _r, _i, k in grp)]


class TpuAdaptiveJoinExec(TpuExec):
    """A partition-wise equi-join over two fresh hash exchanges whose
    strategy is decided at its first execution from the exchanges'
    measured map output.  The decided exec is not a child: the children
    stay the two exchanges, and ``close()`` closes the decided exec.
    ``rf_build_first = "right"`` (set by the runtime filter pass) runs
    the right map stage first, so the filter its build side publishes
    prunes the left side's scans."""

    def __init__(self, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: str,
                 left_exchange: TpuExec, right_exchange: TpuExec,
                 chunk_rows: int, condition: Optional[Expression] = None,
                 runtime: Optional[TaskRuntime] = None,
                 conf: Optional[C.TorchConf] = None):
        super().__init__(left_exchange, right_exchange)
        self.join_type = join_type
        self.chunk_rows = chunk_rows
        self.runtime = runtime or TaskRuntime.serial()
        self.conf = conf or C.TorchConf()
        self._keys = (list(left_keys), list(right_keys))
        self._condition = condition
        self._decided: Optional[TpuExec] = None
        self._decision = "undecided"
        self._lock = threading.Lock()
        #: set by close(): the next drain decides again
        self._redrain = False
        self.rf_build_first: Optional[str] = None
        self.metrics = Metrics("adaptiveBroadcasts", "coalescedPartitions",
                               "skewSplits")
        # the static plan: schema, width and explain() before a run
        self._template = self._make_shuffled(left_exchange, right_exchange)
        #: bound to the children's schemas (the runtime filter pass reads
        #: them); the template builds right unless right_outer
        self.left_keys = self._template.left_keys
        self.right_keys = self._template.right_keys
        self.condition = self._template.condition

    def _make_shuffled(self, left: TpuExec,
                       right: TpuExec) -> TpuShuffledHashJoinExec:
        return TpuShuffledHashJoinExec(
            *self._keys, self.join_type, left, right, self.chunk_rows,
            self._condition, partition_wise=True, runtime=self.runtime)

    @property
    def schema(self) -> T.Schema:
        return self._template.schema

    @property
    def num_partitions(self) -> int:
        # static: reading it must never decide (see the module docstring)
        return self._template.num_partitions

    @property
    def build_is_right(self) -> bool:
        """The static plan's build side (a runtime broadcast builds the
        smaller legal side)."""
        return self._template.build_is_right

    @property
    def decision(self) -> str:
        return self._decision

    def node_desc(self) -> str:
        return (f"TpuAdaptiveJoinExec [{self.join_type}] "
                f"strategy={self._decision}")

    def tree_string(self, depth: int = 0) -> str:
        """Once decided over readers, the readers stand between this node
        and its exchanges."""
        decided = self._decided
        if decided is None or not any(
                isinstance(c, CoalescedShuffleReaderExec)
                for c in decided.children):
            return super().tree_string(depth)
        return "\n".join(["  " * depth + self.node_desc()]
                         + [c.tree_string(depth + 1)
                            for c in decided.children])

    def _decide(self) -> TpuExec:
        with self._lock:
            if self._decided is not None and not self._redrain:
                return self._decided
            # a cached tree drained again decides again from this
            # drain's map output: the last one's may not hold
            self._redrain = False
            from spark_rapids_tpu_torch.plan.planner import (
                broadcast_candidates,
            )

            conf = self.conf
            lex, rex = self.children
            if self.rf_build_first == "right":
                rstats = rex.materialize_stats()
                lstats = lex.materialize_stats()
            else:
                lstats = lex.materialize_stats()
                rstats = rex.materialize_stats()
            lb = [b for b, _ in lstats]
            rb = [b for b, _ in rstats]
            jt = self.join_type
            candidates = broadcast_candidates(
                jt, sum(lb), sum(rb), conf.get(C.BROADCAST_THRESHOLD))
            if candidates:
                side, nbytes = min(candidates, key=lambda c: c[1])
                self.metrics.add("adaptiveBroadcasts", 1)
                self._decision = f"broadcast[{side} {nbytes >> 10}KiB<=thr]"
                self._decided = TpuBroadcastHashJoinExec(
                    *self._keys, jt, lex, rex, self.chunk_rows,
                    self._condition, build_side=side, runtime=self.runtime)
            else:
                target = conf.get(C.ADVISORY_PARTITION_BYTES)
                skew = plan_skew_groups(
                    lb, rb, target, conf.get(C.SKEW_FACTOR),
                    conf.get(C.SKEW_THRESHOLD_BYTES), jt,
                    lblocks=lex.block_counts(), rblocks=rex.block_counts())
                groups = plan_coalesced_groups(
                    [x + y for x, y in zip(lb, rb)], target)
                if skew is not None:
                    lgroups, rgroups, n_splits = skew
                    self.metrics.add("skewSplits", n_splits)
                    self._decision = (f"shuffled[skew: {n_splits} splits, "
                                      f"{len(lgroups)} tasks]")
                    self._decided = self._make_shuffled(
                        CoalescedShuffleReaderExec(lex, lgroups),
                        CoalescedShuffleReaderExec(rex, rgroups))
                elif len(groups) < len(lb):
                    self.metrics.add("coalescedPartitions",
                                     len(lb) - len(groups))
                    self._decision = (f"shuffled[{len(lb)}->"
                                      f"{len(groups)} parts]")
                    self._decided = self._make_shuffled(
                        CoalescedShuffleReaderExec(lex, groups),
                        CoalescedShuffleReaderExec(rex, groups))
                else:
                    self._decision = "shuffled"
                    self._decided = self._template
            self._adopt_metrics()
            return self._decided

    def _adopt_metrics(self) -> None:
        """The decided exec is not a child, so a walk misses its
        counters: read them through this node."""
        theirs = getattr(self._decided, "metrics", None)
        if theirs is not None:
            self.metrics.adopt(theirs)

    def readers(self) -> list[CoalescedShuffleReaderExec]:
        """The decided plan's readers (none before a run, or when it
        reads the exchanges as planned)."""
        decided = self._decided
        return [] if decided is None else [
            c for c in decided.children
            if isinstance(c, CoalescedShuffleReaderExec)]

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        decided = self._decide()
        n_static = self._template.num_partitions
        if p < decided.num_partitions:
            yield from decided.execute_partition(p)
        # a skew split may make more tasks than the static width the
        # parent iterates: the last static partition runs the rest
        if p == n_static - 1:
            for q in range(n_static, decided.num_partitions):
                yield from decided.execute_partition(q)

    def execute(self) -> Iterator[ColumnarBatch]:
        yield from self._decide().execute()

    def close(self) -> None:
        """Close the decided exec (a runtime broadcast's build is a store
        entry); the exchanges are children, closed by the walk.  The
        decision stays readable, and the next drain makes a new one."""
        with self._lock:
            decided = self._decided
            self._redrain = decided is not None
        if decided is not None and hasattr(decided, "close"):
            decided.close()
