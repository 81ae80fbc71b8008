"""Hash join execs and the runtime filter's build exec.

Counterpart of ``spark_rapids_tpu/execs/join.py``: the build side is
collected into one batch (``concat_batches``), then every stream batch
probes it through ``ops/join.py``.  Each stream batch costs one host
sync, for its pair count; its output then comes in chunks of at most
``spark.rapids.tpu.sql.join.outputChunkRows`` rows, so a skewed key
cannot build one unbounded batch.

Three strategies, chosen by the planner:

- ``TpuShuffledHashJoinExec(partition_wise=False)``: wide, every
  partition of both sides, one output partition;
- ``TpuShuffledHashJoinExec(partition_wise=True)``: the children are
  hash exchanges on the join keys with the same partition count;
  partition p joins build part p with stream part p;
- ``TpuBroadcastHashJoinExec``: a small build side collected once and
  shared by every stream partition, so a dimension table never
  shuffles.  The JAX exec registers that batch in its spill store; the
  port has no memory runtime yet and holds it until ``close()``.

Join types: inner, left_outer, right_outer (the left side builds),
full_outer (the build rows no stream batch matched come last; never
broadcast), left_semi, left_anti and cross, all from one
``join_state``.  An inner or cross join may build either side
(``build_side``, the planner's pick).  Cross joins and keyless inner
joins are equi-joins on a constant key, so every pair shares one
group.  An inner join's residual condition filters each output chunk.
A condition or a missing key on any other join type raises
NotImplementedError (the JAX planner falls back to its CPU engine
there; the port has none).  The JAX exec's speculative sizing,
pipelining, program cache and retry ladder are not ported.

``TpuRuntimeFilterBuildExec`` passes its child's batches through and
folds their join keys into a runtime filter on the device
(``plan/runtime_filter.py``), published once every partition drained.
"""

from __future__ import annotations

import threading
from typing import Iterable, Iterator, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    concat_batches,
    empty_batch,
    null_batch,
)
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.exprs.base import (
    EvalContext,
    Expression,
    Literal,
    bind_references,
)
from spark_rapids_tpu_torch.ops.join import (
    expand_pairs,
    gather_joined,
    join_state,
)
from spark_rapids_tpu_torch.plan import runtime_filter as RF

JOIN_TYPES = ("inner", "left_outer", "right_outer", "full_outer",
              "left_semi", "left_anti", "cross")


def nullable_fields(schema: T.Schema) -> list[T.Field]:
    return [T.Field(f.name, f.dtype, True) for f in schema.fields]


def joined_schema(left: T.Schema, right: T.Schema,
                  join_type: str) -> T.Schema:
    """Left fields ++ right fields, the side an outer join does not
    preserve made nullable; semi and anti joins keep the left side."""
    if join_type in ("left_semi", "left_anti"):
        return left
    lf, rf = list(left.fields), list(right.fields)
    if join_type in ("left_outer", "full_outer"):
        rf = nullable_fields(right)
    if join_type in ("right_outer", "full_outer"):
        lf = nullable_fields(left)
    return T.Schema(lf + rf)


class _HashJoinBase(TpuExec):
    """Keys, condition, build side and schema; the probe, expand and
    condition loop over one build batch; full-outer unmatched rows."""

    def __init__(self, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: str,
                 left: TpuExec, right: TpuExec, chunk_rows: int,
                 condition: Optional[Expression] = None,
                 build_side: Optional[str] = None):
        super().__init__(left, right)
        if join_type not in JOIN_TYPES:
            raise ValueError(f"unknown join type {join_type!r}")
        self.join_type = join_type
        if join_type == "cross" or not left_keys:
            if join_type not in ("cross", "inner"):
                raise NotImplementedError(
                    f"a keyless {join_type} join is not ported to "
                    "spark_rapids_tpu_torch")
            left_keys = right_keys = [Literal.of(1)]
        self.left_keys = [bind_references(k, left.schema) for k in left_keys]
        self.right_keys = [bind_references(k, right.schema)
                           for k in right_keys]
        if condition is not None and join_type != "inner":
            raise NotImplementedError(
                f"a residual condition on a {join_type} join is not "
                "ported to spark_rapids_tpu_torch")
        self.condition = None if condition is None else bind_references(
            condition, T.Schema(list(left.schema.fields)
                                + list(right.schema.fields)))
        if chunk_rows <= 0:
            raise ValueError(f"join output chunk of {chunk_rows} rows")
        self.chunk_rows = chunk_rows
        # build = the side an outer, semi or anti join does not preserve;
        # an inner or cross join builds the side the planner picked
        if join_type in ("inner", "cross") and build_side is not None:
            if build_side not in ("left", "right"):
                raise ValueError(f"build side {build_side!r}")
            self.build_is_right = build_side == "right"
        else:
            self.build_is_right = join_type != "right_outer"
        self._schema = joined_schema(left.schema, right.schema, join_type)

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def node_desc(self) -> str:
        ks = ", ".join(f"{lk.name}={rk.name}" for lk, rk in
                       zip(self.left_keys, self.right_keys))
        cond = "" if self.condition is None else f" [{self.condition!r}]"
        return f"{self.name} {self.join_type} [{ks}]{cond}"

    @property
    def _build_child(self) -> TpuExec:
        return self.children[1] if self.build_is_right else self.children[0]

    @property
    def _stream_child(self) -> TpuExec:
        return self.children[0] if self.build_is_right else self.children[1]

    @staticmethod
    def _collect(batches: Iterable[ColumnarBatch]
                 ) -> Optional[ColumnarBatch]:
        """The build side as one batch; None when it has no rows."""
        parts = [b for b in batches if b.num_rows]
        return concat_batches(parts) if parts else None

    def _apply_condition(self, batch: ColumnarBatch) -> ColumnarBatch:
        pred = self.condition.eval(EvalContext.for_batch(batch))
        return batch.compact(pred.data.bool() & pred.validity)

    def _join_stream(self, build: Optional[ColumnarBatch],
                     stream_batches: Iterable[ColumnarBatch]
                     ) -> Iterator[ColumnarBatch]:
        if build is None:
            if self.join_type in ("inner", "left_semi", "cross"):
                return  # an empty build side joins to nothing
            build = empty_batch(self._build_child.schema,
                                self._build_child.leaf_device())
        build_keys = self.right_keys if self.build_is_right \
            else self.left_keys
        stream_keys = self.left_keys if self.build_is_right \
            else self.right_keys
        bctx = EvalContext.for_batch(build)
        bkc = [k.eval(bctx) for k in build_keys]
        # the stream side is the preserved one of every outer variant
        jt = "left_outer" if self.join_type in (
            "left_outer", "right_outer", "full_outer") else "inner" \
            if self.join_type == "cross" else self.join_type
        matched_b: Optional[torch.Tensor] = None
        for stream in stream_batches:
            if stream.num_rows == 0:
                continue
            sctx = EvalContext.for_batch(stream)
            st = join_state(bkc, [k.eval(sctx) for k in stream_keys], jt)
            if self.join_type == "full_outer":
                matched_b = st.matched_b if matched_b is None \
                    else matched_b | st.matched_b
            if self.join_type in ("left_semi", "left_anti"):
                keep = st.matched_s if self.join_type == "left_semi" \
                    else ~st.matched_s
                out = stream.compact(keep)
                if out.num_rows:
                    yield out
                continue
            total = int(st.total)  # the one host sync of this batch
            step = min(total, self.chunk_rows)
            for off in range(0, total, step or 1):
                s_idx, b_idx, live, matched = expand_pairs(
                    st, min(step, total - off), off)
                out = gather_joined(build, stream, s_idx, b_idx, live,
                                    matched, self._schema,
                                    stream_first=self.build_is_right)
                if self.condition is not None:
                    out = self._apply_condition(out)
                if out.num_rows:
                    yield out
        if self.join_type == "full_outer":
            yield from self._emit_unmatched_build(build, matched_b)

    def _emit_unmatched_build(self, build: ColumnarBatch,
                              matched_b: Optional[torch.Tensor]
                              ) -> Iterator[ColumnarBatch]:
        """The build rows no stream batch matched, with NULLs for the
        stream side."""
        if matched_b is not None:
            build = build.compact(~matched_b)
        if build.num_rows == 0:
            return
        nulls = null_batch(self._stream_child.schema, build.num_rows,
                           build.device).columns
        cols = nulls + build.columns if self.build_is_right \
            else build.columns + nulls
        yield ColumnarBatch(cols, build.num_rows, self._schema, build.device)


class TpuRuntimeFilterBuildExec(TpuExec):
    """A pass-through on the build side of an eligible join: each batch
    flows on unchanged while its join keys fold into the device state of
    the runtime filters in ``entries``; when the last partition has
    drained, each filter is read back once and published to the probe
    side's scans.  Under a broadcast or wide join it sits right under
    the join, which collects its build side before it reads the probe
    side; under a partition-wise join it sits under the build side's
    exchange, whose map stage drains the whole build input before the
    probe side's exchange runs."""

    def __init__(self, child: TpuExec, entries):
        super().__init__(child)
        #: [(bound key expression, RuntimeFilter)]
        self.entries = list(entries)
        self._lock = threading.Lock()
        self._acc: Optional[list] = None
        self._parts_done: set = set()
        self._published = False

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    @property
    def output_partitioning(self):
        return self.children[0].output_partitioning

    def node_desc(self) -> str:
        fs = ", ".join(rf.describe() for _k, rf in self.entries)
        return f"{self.name} [{fs}]"

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        dev = self.leaf_device()
        states = [RF.device_init_state(rf.n_bits, dev)
                  for _k, rf in self.entries]
        for batch in self.children[0].execute_partition(p):
            ctx = EvalContext.for_batch(batch)
            states = [RF.device_update(st, key.eval(ctx), rf.n_bits,
                                       rf.n_hashes)
                      for (key, rf), st in zip(self.entries, states)]
            yield batch
        self._merge_and_maybe_publish(p, states)

    def _merge_and_maybe_publish(self, p: int, states: list) -> None:
        with self._lock:
            if self._published:
                return
            self._acc = states if self._acc is None else [
                RF.device_merge_states(a, s)
                for a, s in zip(self._acc, states)]
            self._parts_done.add(p)
            if len(self._parts_done) < self.num_partitions:
                return
            self._published = True
            acc, self._acc = self._acc, None
        for (_k, rf), st in zip(self.entries, acc):
            RF.finalize(rf, st)


class TpuShuffledHashJoinExec(_HashJoinBase):
    """``partition_wise=False``: wide, the whole build side against every
    stream partition, one output partition.  ``partition_wise=True``:
    the children are co-partitioned hash exchanges on the join keys;
    partition p joins build part p with stream part p."""

    def __init__(self, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: str,
                 left: TpuExec, right: TpuExec, chunk_rows: int,
                 condition: Optional[Expression] = None,
                 partition_wise: bool = False,
                 build_side: Optional[str] = None):
        super().__init__(left_keys, right_keys, join_type, left, right,
                         chunk_rows, condition, build_side)
        self.partition_wise = partition_wise
        if partition_wise and left.num_partitions != right.num_partitions:
            raise ValueError("a partition-wise join needs co-partitioned "
                             "children")

    @property
    def num_partitions(self) -> int:
        return self._stream_child.num_partitions if self.partition_wise \
            else 1

    def node_desc(self) -> str:
        pw = " partition_wise" if self.partition_wise else ""
        return super().node_desc() + pw

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        if not self.partition_wise:
            if p == 0:
                yield from self._join_stream(
                    self._collect(self._build_child.execute()),
                    self._stream_child.execute())
            return
        yield from self._join_stream(
            self._collect(self._build_child.execute_partition(p)),
            self._stream_child.execute_partition(p))


class TpuBroadcastHashJoinExec(_HashJoinBase):
    """A small build side, collected once (on the first stream partition
    that asks) and shared by every stream partition; the output keeps
    the stream side's partitions.  full_outer is refused: its unmatched
    build rows need the matches of every stream partition."""

    def __init__(self, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: str,
                 left: TpuExec, right: TpuExec, chunk_rows: int,
                 condition: Optional[Expression] = None,
                 build_side: Optional[str] = None):
        if join_type == "full_outer":
            raise ValueError("a broadcast join cannot run full_outer")
        super().__init__(left_keys, right_keys, join_type, left, right,
                         chunk_rows, condition, build_side)
        self._build_lock = threading.Lock()
        self._build: Optional[ColumnarBatch] = None
        self._build_done = False

    @property
    def num_partitions(self) -> int:
        return self._stream_child.num_partitions

    def node_desc(self) -> str:
        side = "right" if self.build_is_right else "left"
        return f"{super().node_desc()} build={side}"

    def _get_build(self) -> Optional[ColumnarBatch]:
        with self._build_lock:
            if not self._build_done:
                self._build = self._collect(self._build_child.execute())
                self._build_done = True
            return self._build

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        yield from self._join_stream(self._get_build(),
                                     self._stream_child.execute_partition(p))

    def close(self) -> None:
        """Drop the collected build side."""
        with self._build_lock:
            self._build = None
            self._build_done = False
