"""Hash join execs and the runtime filter's build exec.

Counterpart of ``spark_rapids_tpu/execs/join.py``: the build side is
collected into one batch (each build batch waits in the buffer store at
``JOIN_BUILD`` priority until the side is drained, then they are
concatenated), then every stream batch probes it through
``ops/join.py``.  The stream loop is pipelined
(``parallel/pipeline.py::pipelined``): batch k+1 is dispatched before
batch k retires.  Its output comes in chunks of at most
``spark.rapids.tpu.sql.join.outputChunkRows`` rows, so a skewed key
cannot build one unbounded batch.

The pair count sizes the output (tag ``join.probe``).  With speculative
sizing on (``parallel/speculation.py``, the default), a warmed
predictor's bucket sizes the first chunk: the dispatch half runs the
probe, the expansion and the gather at that capacity with no sync, and
starts the count's asynchronous read (``device_read_async``).  The
retire half then reconciles: on a hit the chunk is cut to the count by
``slice_prefix`` (views); on an undershoot the pairs from ``offset=cap``
continue it, and nothing dispatched is redone.
The continuation keeps the blocking path's chunk boundaries (the JAX
exec emits the speculated chunk on its own and continues from ``cap``):
the first chunk is completed to ``min(pairs, outputChunkRows)`` rows
(one copy of the speculated rows, on an undershoot only), so every
operator downstream sees the same batches whether a batch hit,
overflowed or was not speculated, and a floating sum above the join
adds in the same order on every run, pooled or serial.  A residual
condition filters each chunk after that.  Warm-up
batches, a tag the kill switch has convicted and speculation off read
the count blocking (``device_read_int``) in the retire half, as before.
A speculated chunk is device memory the store does not see, made a
batch ahead: from its dispatch to its retire it holds its bytes (from
the two sides' shapes) in ``speculation.MAX_INFLIGHT_BYTES``, a budget
shared by every join in the process; a dispatch that would pass it
reads its count blocking instead (``declined`` in
``speculation.stats()``).  The predictor observes each count, and the
hit or overflow is recorded (``specHits`` / ``specOverflows``), once
the batch's retire has succeeded.  Semi and anti joins size nothing.

Each stream batch is a unit of the OOM ladder
(``execs/retry.guarded_pipeline``): a retryable failure before its
first chunk re-runs it (a speculated chunk is dropped and the re-run
dispatches again), then bisects it; after a chunk has gone downstream
it raises.

Three strategies, chosen by the planner:

- ``TpuShuffledHashJoinExec(partition_wise=False)``: wide, every
  partition of both sides, one output partition;
- ``TpuShuffledHashJoinExec(partition_wise=True)``: the children are
  hash exchanges on the join keys with the same partition count;
  partition p joins build part p with stream part p;
- ``TpuBroadcastHashJoinExec``: a small build side collected once and
  shared by every stream partition, so a dimension table never
  shuffles.  The collected build is a store entry at ``BROADCAST``
  priority (spilled last), pinned only while a stream partition joins,
  as in the JAX exec.

Join types: inner, left_outer, right_outer (the left side builds),
full_outer (the build rows no stream batch matched come last; never
broadcast), left_semi, left_anti and cross, all from one
``join_state``.  An inner or cross join may build either side
(``build_side``, the planner's pick).  Cross joins and keyless inner
joins are equi-joins on a constant key, so every pair shares one
group.  An inner join's residual condition filters each output chunk.
A condition or a missing key on any other join type raises
NotImplementedError: the planner tags such a join and runs it on the
CPU engine (``plan/planner.py``), as the JAX planner does.

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
from spark_rapids_tpu_torch.execs.base import Metrics, TaskRuntime, TpuExec
from spark_rapids_tpu_torch.execs.jit_cache import exprs_key
from spark_rapids_tpu_torch.execs.retry import (
    guarded_pipeline,
    run_with_oom_retry,
)
from spark_rapids_tpu_torch.exprs.base import (
    EvalContext,
    Expression,
    Literal,
    bind_references,
)
from spark_rapids_tpu_torch.memory.store import (
    SpillableBatch,
    SpillPriorities,
    batch_device_bytes,
)
from spark_rapids_tpu_torch.ops.join import (
    expand_pairs,
    gather_joined,
    join_state,
)
from spark_rapids_tpu_torch.parallel import speculation as SP
from spark_rapids_tpu_torch.parallel.pipeline import (
    device_read_async,
    device_read_int,
    pipelined,
)
from spark_rapids_tpu_torch.plan import runtime_filter as RF
from spark_rapids_tpu_torch.trace import ledger as _ledger

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
                 build_side: Optional[str] = None,
                 runtime: Optional[TaskRuntime] = None):
        super().__init__(left, right)
        self.runtime = runtime or TaskRuntime.serial()
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
        #: stream batches whose first chunk was speculated, by outcome,
        #: and the expansions that continued an undershoot
        self.metrics = Metrics("specHits", "specOverflows",
                               "specContinuationChunks")

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

    def _collect(self, batches: Iterable[ColumnarBatch]
                 ) -> Optional[ColumnarBatch]:
        """The build side as one batch; None when it has no rows.  Each
        batch waits in the store, spillable, until the side is
        drained."""
        store = self.runtime.store
        handles: list[SpillableBatch] = []
        try:
            for b in batches:
                if b.num_rows:
                    handles.append(store.register(
                        b, SpillPriorities.JOIN_BUILD))
            if not handles:
                return None
            return run_with_oom_retry(
                lambda: concat_batches([h.get() for h in handles]),
                "join.build", policy=self.runtime.retry)
        finally:
            for h in handles:
                h.close()

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
        probe_key = (jt, exprs_key(build_keys), exprs_key(stream_keys))
        probe = self.program("join.probe", lambda: probe_key, self._probe)
        expand_key = ("join.expand", self.build_is_right,
                      repr(self._schema))
        expand = self.program(expand_key[0], lambda: expand_key[1:],
                              self._expand)
        policy = self.runtime.speculation
        sizes_output = self.join_type not in ("left_semi", "left_anti")
        pred = SP.predictor(("join.probe",) + probe_key + ("sizing",)) \
            if sizes_output and policy.enabled \
            and SP.tag_enabled("join.probe") else None
        build_row_bytes = batch_device_bytes(build) / max(build.num_rows, 1)
        #: bytes of this loop's speculated chunks dispatched and not yet
        #: retired, held in the in-flight budget
        held = [0]

        def dispatch(stream: ColumnarBatch):
            """The pairing state of one stream batch and, past the
            predictor's warm-up and within the in-flight budget, its
            first chunk at the speculated capacity with its count's read
            started (device work, no sync)."""
            with self.timer() as t:
                st = t.observe(probe(bkc, stream, stream_keys, jt))
                # the JAX exec clamps to the chunk's bucket; here no chunk
                # passes outputChunkRows
                cap = pred.predict(policy, cap_ceiling=self.chunk_rows) \
                    if pred is not None else None
                if cap is None:
                    return stream, st, None, None, None, 0, False
                # the chunk's bytes from the two sides' shapes, no sync
                nbytes = int(cap * (build_row_bytes + batch_device_bytes(
                    stream) / stream.num_rows))
                if not SP.reserve_inflight(nbytes):
                    return stream, st, None, None, None, 0, True
                held[0] += nbytes
                try:
                    _ledger.defer_occupancy()
                    chunk = t.observe(expand(build, stream, st, cap, 0))
                except BaseException:
                    SP.release_inflight(nbytes)
                    held[0] -= nbytes
                    raise
            return (stream, st, cap, chunk,
                    device_read_async(st.total, tag="join.probe"), nbytes,
                    False)

        def emit(out: ColumnarBatch) -> Optional[ColumnarBatch]:
            if self.condition is not None:
                with self.timer() as t:
                    out = t.observe(self._apply_condition(out))
            return out if out.num_rows else None

        def retire(entry) -> Iterator[ColumnarBatch]:
            """One stream batch's output chunks: the speculated chunk
            reconciled with its count, then any continuation; or, with
            no speculation, the blocking read of the count and the
            chunks.  The ladder re-runs it (or its halves) until a chunk
            is out.  OR-ing the matched build rows again is harmless."""
            nonlocal matched_b
            stream, st, cap, chunk, fut, nbytes, declined = entry
            if nbytes:  # the chunk leaves the budget as it goes out
                SP.release_inflight(nbytes)
                held[0] -= nbytes
            if self.join_type == "full_outer":
                matched_b = st.matched_b if matched_b is None \
                    else matched_b | st.matched_b
            if self.join_type in ("left_semi", "left_anti"):
                keep = st.matched_s if self.join_type == "left_semi" \
                    else ~st.matched_s
                out = stream.compact(keep)
                if out.num_rows:
                    yield out
                return
            with self.timer():
                total = int(fut.result()) if fut is not None \
                    else device_read_int(st.total, tag="join.probe")
            start = 0
            if chunk is not None:
                live = min(total, cap)
                _ledger.note_program_occupancy(expand_key, live, cap)
                out = chunk.slice_prefix(live)
                # the first chunk ends where the blocking path's does
                start = min(total, self.chunk_rows)
                if start > cap:  # an undershoot: the rest of that chunk
                    with self.timer() as t:
                        _ledger.note_occupancy(start - cap, start - cap)
                        rest = expand(build, stream, st, start - cap, cap)
                        out = t.observe(concat_batches([out, rest]))
                out = emit(out)
                if out is not None:
                    yield out
            step = min(total - start, self.chunk_rows)
            for off in range(start, total, step or 1):
                rows = min(step, total - off)
                with self.timer() as t:
                    _ledger.note_occupancy(rows, rows)
                    out = t.observe(expand(build, stream, st, rows, off))
                out = emit(out)
                if out is not None:
                    yield out
            # once the batch is out: a failed attempt observes nothing
            if pred is None:
                return
            pred.observe(total)
            if chunk is None:
                (SP.record_declined if declined else SP.record_sync)(
                    "join.probe")
            elif total <= cap:
                self.metrics.add("specHits", 1)
                SP.record_hit("join.probe", cap, total, policy)
            else:
                self.metrics.add("specOverflows", 1)
                self.metrics.add("specContinuationChunks",
                                 (start > cap)
                                 + len(range(start, total, step or 1)))
                SP.record_overflow("join.probe", cap, total, policy)

        dispatch_guarded, retire_guarded = guarded_pipeline(
            dispatch, retire, "join.stream", self.runtime.retry)
        try:
            yield from pipelined(
                (b for b in stream_batches if b.num_rows), dispatch_guarded,
                retire_guarded, self.runtime.lookahead, tag="join.stream")
        finally:
            # the entries a closed or failed loop never retired
            SP.release_inflight(held[0])
        if self.join_type == "full_outer":
            yield from self._emit_unmatched_build(build, matched_b)

    def _expand(self, build: ColumnarBatch, stream: ColumnarBatch, st,
                rows: int, offset: int) -> ColumnarBatch:
        """Output pairs [offset, offset + rows) as a batch of ``rows``
        rows: past the pair count they are dead (NULL) rows, which the
        retire half cuts off."""
        s_idx, b_idx, live, matched = expand_pairs(st, rows, offset)
        return gather_joined(build, stream, s_idx, b_idx, live, matched,
                             self._schema, stream_first=self.build_is_right)

    @staticmethod
    def _probe(bkc, stream: ColumnarBatch, stream_keys, jt: str):
        sctx = EvalContext.for_batch(stream)
        return join_state(bkc, [k.eval(sctx) for k in stream_keys], jt)

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
        states = [RF.device_init_state(rf.n_bits, dev, rf.use_bloom)
                  for _k, rf in self.entries]
        for batch in self.children[0].execute_partition(p):
            ctx = EvalContext.for_batch(batch)
            states = [RF.device_update(st, key.eval(ctx), rf.n_bits,
                                       rf.n_hashes, rf.use_bloom)
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

    def close(self) -> None:
        """Set the filters pending again, so that a cached plan's next
        drain starts as a first drain does: its scans apply nothing
        until this drain's build side has published (the last drain's
        keys may not hold).  Each filter keeps what it published as
        ``last``."""
        with self._lock:
            self._acc, self._parts_done = None, set()
            self._published = False
            for _k, rf in self.entries:
                rf.reset()


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
                 build_side: Optional[str] = None,
                 runtime: Optional[TaskRuntime] = None):
        super().__init__(left_keys, right_keys, join_type, left, right,
                         chunk_rows, condition, build_side, runtime)
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
    the stream side's partitions.  The collected build waits in the
    store at ``BROADCAST`` priority, pinned while a partition joins.
    full_outer is refused: its unmatched build rows need the matches of
    every stream partition."""

    def __init__(self, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: str,
                 left: TpuExec, right: TpuExec, chunk_rows: int,
                 condition: Optional[Expression] = None,
                 build_side: Optional[str] = None,
                 runtime: Optional[TaskRuntime] = None):
        if join_type == "full_outer":
            raise ValueError("a broadcast join cannot run full_outer")
        super().__init__(left_keys, right_keys, join_type, left, right,
                         chunk_rows, condition, build_side, runtime)
        self._build_lock = threading.Lock()
        self._build: Optional[SpillableBatch] = None
        self._build_done = False

    @property
    def num_partitions(self) -> int:
        return self._stream_child.num_partitions

    def node_desc(self) -> str:
        side = "right" if self.build_is_right else "left"
        return f"{super().node_desc()} build={side}"

    def _get_build(self) -> Optional[SpillableBatch]:
        with self._build_lock:
            if not self._build_done:
                b = self._collect(self._build_child.execute())
                if b is not None:
                    self._build = self.runtime.store.register(
                        b, SpillPriorities.BROADCAST)
                self._build_done = True
            return self._build

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        h = self._get_build()
        build = None if h is None else h.get()
        try:
            yield from self._join_stream(
                build, self._stream_child.execute_partition(p))
        finally:
            if h is not None:
                h.unpin()

    def close(self) -> None:
        """Drop the collected build side."""
        with self._build_lock:
            if self._build is not None:
                self._build.close()
            self._build = None
            self._build_done = False
