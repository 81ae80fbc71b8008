"""Shuffled hash join exec.

Counterpart of ``TpuShuffledHashJoinExec`` in
``spark_rapids_tpu/execs/join.py``: the build side is collected into
one batch (``concat_batches``), then every stream batch probes it
through ``ops/join.py``.  Each stream batch costs one host sync, for its
pair count; its output then comes in chunks of at most
``spark.rapids.tpu.sql.join.outputChunkRows`` rows, so a skewed key
cannot build one unbounded batch.

- ``partition_wise=False``: wide, every partition of both sides, one
  output partition;
- ``partition_wise=True``: the children are hash exchanges on the join
  keys with the same partition count; partition p joins build part p
  with stream part p.

Join types: inner, left_outer, right_outer (sides swapped: the left
side builds), full_outer (the build rows no stream batch matched come
last), left_semi and left_anti, all from one ``join_state``.  Cross
joins, keyless joins and residual conditions raise NotImplementedError.
The JAX exec's speculative sizing, pipelining, program cache and retry
ladder are not ported.
"""

from __future__ import annotations

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
    bind_references,
)
from spark_rapids_tpu_torch.ops.join import (
    expand_pairs,
    gather_joined,
    join_state,
)

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


class TpuShuffledHashJoinExec(TpuExec):
    def __init__(self, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: str,
                 left: TpuExec, right: TpuExec, chunk_rows: int,
                 condition: Optional[Expression] = None,
                 partition_wise: bool = False):
        super().__init__(left, right)
        if join_type == "cross" or not left_keys:
            raise NotImplementedError(
                "cross and keyless joins are not ported to "
                "spark_rapids_tpu_torch")
        if condition is not None:
            raise NotImplementedError(
                "residual join conditions are not ported to "
                "spark_rapids_tpu_torch")
        self.join_type = join_type
        self.left_keys = [bind_references(k, left.schema) for k in left_keys]
        self.right_keys = [bind_references(k, right.schema)
                           for k in right_keys]
        if chunk_rows <= 0:
            raise ValueError(f"join output chunk of {chunk_rows} rows")
        self.chunk_rows = chunk_rows
        # build = the side an outer, semi or anti join does not preserve
        self.build_is_right = join_type != "right_outer"
        self._schema = joined_schema(left.schema, right.schema, join_type)
        self.partition_wise = partition_wise
        if partition_wise and left.num_partitions != right.num_partitions:
            raise ValueError("a partition-wise join needs co-partitioned "
                             "children")

    @property
    def schema(self) -> T.Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return self._stream_child.num_partitions if self.partition_wise \
            else 1

    def node_desc(self) -> str:
        ks = ", ".join(f"{lk.name}={rk.name}" for lk, rk in
                       zip(self.left_keys, self.right_keys))
        pw = " partition_wise" if self.partition_wise else ""
        return f"{self.name} {self.join_type} [{ks}]{pw}"

    @property
    def _build_child(self) -> TpuExec:
        return self.children[1] if self.build_is_right else self.children[0]

    @property
    def _stream_child(self) -> TpuExec:
        return self.children[0] if self.build_is_right else self.children[1]

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        if not self.partition_wise:
            if p == 0:
                yield from self._join_stream(self._build_child.execute(),
                                             self._stream_child.execute())
            return
        yield from self._join_stream(
            self._build_child.execute_partition(p),
            self._stream_child.execute_partition(p))

    def _join_stream(self, build_batches: Iterable[ColumnarBatch],
                     stream_batches: Iterable[ColumnarBatch]
                     ) -> Iterator[ColumnarBatch]:
        parts = [b for b in build_batches if b.num_rows]
        if not parts:
            if self.join_type in ("inner", "left_semi"):
                return  # an empty build side joins to nothing
            build = empty_batch(self._build_child.schema,
                                self._build_child.leaf_device())
        else:
            build = concat_batches(parts)
        build_keys = self.right_keys if self.build_is_right \
            else self.left_keys
        stream_keys = self.left_keys if self.build_is_right \
            else self.right_keys
        bctx = EvalContext.for_batch(build)
        bkc = [k.eval(bctx) for k in build_keys]
        # the stream side is the preserved one of every outer variant
        jt = "left_outer" if self.join_type in (
            "left_outer", "right_outer", "full_outer") else self.join_type
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
                yield gather_joined(build, stream, s_idx, b_idx, live,
                                    matched, self._schema,
                                    stream_first=self.build_is_right)
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
