"""Multi-file Parquet scan.

Counterpart of ``ParquetScanExec`` in ``spark_rapids_tpu/io/scan.py``.
Files group into scan tasks (the exec's partitions) by the same rule as
there, ``_group_files``: files pack into one task until the next would
push it past ``scan.taskTargetBytes`` (default 512 MiB), so both
engines plan the same shape for the same conf.  Only the projected
columns are read.  Decoding is ``pyarrow.parquet``; string columns are
read dictionary-encoded, so their codes reach the coded group-by.

Runtime join filters (``plan/runtime_filter.py``) registered on the scan
are read when a scan task starts (a filter its build side has not
published yet applies nothing), and applied at two points: a row group
whose footer min/max misses a filter's range is not decoded
(``rfRowGroupsPruned``), and each decoded batch is masked on the host
before upload (``rfPrunedRows``).  Static predicate pushdown, wire
codecs and the native decoder are not ported.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence

import pyarrow as pa
import pyarrow.parquet as pq
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import from_arrow
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.io.pa_filter import runtime_filter_column_mask
from spark_rapids_tpu_torch.io.pushdown import runtime_range_may_match


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
                 estimated_rows: Optional[int] = None):
        super().__init__()
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
        self.metrics = {"numOutputRows": 0, "rfPrunedRows": 0,
                        "rfRowGroupsPruned": 0}

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
        self.metrics["rfRowGroupsPruned"] += n_rgs - len(keep)
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
        self.metrics["rfPrunedRows"] += rb.num_rows - kept.num_rows
        return kept

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        names = self._schema.names
        strings = [f.name for f in self._schema.fields
                   if isinstance(f.dtype, T.StringType)]
        rfs = [(n, rf) for n, rf in self._ready_runtime_filters()
               if n in names]
        for fi in self._groups[p]:
            f = pq.ParquetFile(self.paths[fi], read_dictionary=strings)
            row_groups = None
            if rfs:
                row_groups = self._keep_row_groups(f, rfs)
                if not row_groups:
                    continue
            for rb in f.iter_batches(batch_size=self.batch_rows,
                                     columns=names, row_groups=row_groups):
                if rfs:
                    rb = self._apply_runtime_filters(rb, rfs)
                self.metrics["numOutputRows"] += rb.num_rows
                yield from_arrow(rb, self.device, self._schema)
