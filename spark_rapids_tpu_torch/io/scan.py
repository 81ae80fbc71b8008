"""Multi-file Parquet scan.

Counterpart of ``ParquetScanExec`` in ``spark_rapids_tpu/io/scan.py``.
Files group into scan tasks (the exec's partitions) by the same rule as
there, ``_group_files``: files pack into one task until the next would
push it past ``scan.taskTargetBytes`` (default 512 MiB), so both
engines plan the same shape for the same conf.  Only the projected
columns are read.  Decoding is ``pyarrow.parquet``; string columns are
read dictionary-encoded, so their codes reach the coded group-by.

A scan task runs as the JAX one does (``_local_units`` there): its
files decode on a pool of ``scan.decodeThreads`` threads, at most that
many files in flight and yielded in file order (a task's files together
stay under the task target, so the window's decoded tables do too); the
decoded batches cross a ``scan.decode`` stage, the first half of their
upload (``columnar/arrow.py::stage_upload``: host copies, pinning, the
copy enqueued on the session's upload stream) runs on a ``scan.upload``
stage, and the task's consumer finishes each upload on its own stream.
With ``pipeline.enabled`` off the stages run inline, and with one
decode thread the files decode one after another.

Runtime join filters (``plan/runtime_filter.py``) registered on the scan
are read when a scan task's generator first runs (a filter its build
side has not published yet applies nothing; no stage starts before
that), and applied at two points: a row group whose footer min/max
misses a filter's range is not decoded (``rfRowGroupsPruned``), and
each decoded batch is masked on the host before upload
(``rfPrunedRows``).  Static predicate pushdown, wire codecs and the
native decoder are not ported.

``metrics`` (atomic: tasks and decodes run on several threads) count
rows and the host time of each part of a task: ``decodeTime`` (opening
files, pyarrow decode and the runtime filter's host mask, summed over
the decode threads) and ``columnar/arrow.py``'s ``UPLOAD_METRICS``.
"""

from __future__ import annotations

import itertools
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import pyarrow as pa
import pyarrow.parquet as pq
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import (
    UPLOAD_METRICS,
    finish_upload,
    stage_upload,
)
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.execs.base import (
    POOL_THREAD_PREFIX,
    Metrics,
    TaskRuntime,
    TpuExec,
)
from spark_rapids_tpu_torch.io.pa_filter import runtime_filter_column_mask
from spark_rapids_tpu_torch.io.pushdown import runtime_range_may_match
from spark_rapids_tpu_torch.parallel.pipeline import prefetch


def group_files(paths: Sequence[str], target: int) -> list[list[int]]:
    """File indices per scan task under a byte target."""
    groups: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    for i, p in enumerate(paths):
        try:
            sz = os.path.getsize(p)
        except OSError:
            sz = target
        if cur and cur_bytes + sz > target:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += sz
    if cur:
        groups.append(cur)
    return groups or [[]]


class ParquetScanExec(TpuExec):
    def __init__(self, paths: Sequence[str], schema: T.Schema,
                 device: torch.device, task_target_bytes: int,
                 batch_rows: int, columns: Optional[Sequence[str]] = None,
                 estimated_rows: Optional[int] = None,
                 runtime: Optional[TaskRuntime] = None):
        super().__init__()
        self.runtime = runtime or TaskRuntime.serial()
        self.paths = list(paths)
        self.device = torch.device(device)
        self.batch_rows = batch_rows
        self.columns = list(columns) if columns is not None else None
        self._schema = schema if columns is None else T.Schema(
            [f for f in schema.fields if f.name in self.columns])
        self._groups = group_files(self.paths, task_target_bytes)
        #: [(column name, RuntimeFilter)], registered by the planner
        self.runtime_filters: list = []
        #: the files' footer row count, from the logical scan
        #: (plan/cost.py)
        self.estimated_rows = estimated_rows
        self.metrics = Metrics("numOutputRows", "rfPrunedRows",
                               "rfRowGroupsPruned", "decodeTime",
                               *UPLOAD_METRICS)

    @property
    def schema(self) -> T.Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return len(self._groups)

    def node_desc(self) -> str:
        return (f"ParquetScanExec [{len(self.paths)} files, "
                f"{len(self._groups)} tasks] "
                f"[{', '.join(self._schema.names)}]")

    def _ready_runtime_filters(self) -> list:
        """The published filters: a scan never waits for one."""
        return [(n, rf) for n, rf in self.runtime_filters if rf.ready]

    def _keep_row_groups(self, f: pq.ParquetFile, rfs: list) -> list[int]:
        """Application point 1 (``plan/runtime_filter.py``): the row
        groups whose footer min/max may hold a key every filter can
        pass."""
        n_rgs = f.metadata.num_row_groups
        keep = [g for g in range(n_rgs)
                if all(runtime_range_may_match(n, rf, f.metadata.row_group(g))
                       for n, rf in rfs)]
        self.metrics.add("rfRowGroupsPruned", n_rgs - len(keep))
        return keep

    def _apply_runtime_filters(self, rb: pa.RecordBatch,
                               rfs: list) -> pa.RecordBatch:
        """Application point 3 (``plan/runtime_filter.py``): drop
        decoded rows whose key no build key can match, before upload.  A
        column the probe cannot model is skipped."""
        keep = None
        for name, rf in rfs:
            m = runtime_filter_column_mask(rb.column(name), rf)
            if m is not None:
                keep = m if keep is None else keep & m
        if keep is None or keep.all():
            return rb
        kept = rb.filter(pa.array(keep))
        self.metrics.add("rfPrunedRows", rb.num_rows - kept.num_rows)
        return kept

    def _file_batches(self, fi: int, rfs: list
                      ) -> Iterator[pa.RecordBatch]:
        """One file's decoded batches, masked by the runtime filters."""
        names = self._schema.names
        strings = [f.name for f in self._schema.fields
                   if isinstance(f.dtype, T.StringType)]
        t0 = time.perf_counter_ns()
        f = pq.ParquetFile(self.paths[fi], read_dictionary=strings)
        row_groups = None
        if rfs:
            row_groups = self._keep_row_groups(f, rfs)
        batches = iter(()) if row_groups == [] else f.iter_batches(
            batch_size=self.batch_rows, columns=names, row_groups=row_groups)
        for rb in batches:
            if rfs:
                rb = self._apply_runtime_filters(rb, rfs)
            self.metrics.add("numOutputRows", rb.num_rows)
            self.metrics.add("decodeTime", time.perf_counter_ns() - t0)
            yield rb
            t0 = time.perf_counter_ns()
        self.metrics.add("decodeTime", time.perf_counter_ns() - t0)

    def _decoded(self, p: int, rfs: list) -> Iterator[pa.RecordBatch]:
        """Scan task ``p``'s decoded batches in file order: one file
        after another, or on a pool with at most ``decode_threads``
        files in flight (file k + threads starts while file k's batches
        are consumed)."""
        files = self._groups[p]
        threads = min(self.runtime.decode_threads, len(files))
        if threads <= 1:
            for fi in files:
                yield from self._file_batches(fi, rfs)
            return
        pool = ThreadPoolExecutor(
            max_workers=threads,
            thread_name_prefix=POOL_THREAD_PREFIX + "decode")

        def decode(fi: int) -> list[pa.RecordBatch]:
            return list(self._file_batches(fi, rfs))

        try:
            todo = iter(files)
            pending = deque(pool.submit(decode, fi)
                            for fi in itertools.islice(todo, threads))
            while pending:
                done = pending.popleft()
                nxt = next(todo, None)
                if nxt is not None:
                    pending.append(pool.submit(decode, nxt))
                yield from done.result()
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def _staged(self, decoded: Iterator[pa.RecordBatch]) -> Iterator:
        """The first half of each decoded batch's upload."""
        try:
            for rb in decoded:
                yield stage_upload(rb, self.device, self._schema,
                                   self.runtime.upload_stream, self.metrics)
        finally:
            decoded.close()

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        names = self._schema.names
        rfs = [(n, rf) for n, rf in self._ready_runtime_filters()
               if n in names]
        depth = self.runtime.stage_depth
        units = prefetch(self._staged(prefetch(
            self._decoded(p, rfs), depth, "scan.decode")), depth,
            "scan.upload")
        try:
            for unit in units:
                yield finish_upload(unit, self.metrics)
        finally:
            units.close()
