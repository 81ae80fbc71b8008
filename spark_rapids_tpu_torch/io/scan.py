"""Multi-file Parquet scan.

Counterpart of ``ParquetScanExec`` in ``spark_rapids_tpu/io/scan.py``.
Files group into scan tasks (the exec's partitions) by the same rule as
there, ``_group_files``: files pack into one task until the next would
push it past ``scan.taskTargetBytes`` (default 512 MiB), so both
engines plan the same shape for the same conf.  Only the projected
columns are read.  Decoding is ``pyarrow.parquet``; string columns are
read dictionary-encoded, so their codes reach the coded group-by.
Predicate pushdown, wire codecs, runtime filters and the native decoder
are not in this slice.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence

import pyarrow.parquet as pq
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import from_arrow
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.execs.base import TpuExec


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
                 batch_rows: int, columns: Optional[Sequence[str]] = None):
        super().__init__()
        self.paths = list(paths)
        self.device = torch.device(device)
        self.batch_rows = batch_rows
        self.columns = list(columns) if columns is not None else None
        self._schema = schema if columns is None else T.Schema(
            [f for f in schema.fields if f.name in self.columns])
        self._groups = group_files(self.paths, task_target_bytes)

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

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        names = self._schema.names
        strings = [f.name for f in self._schema.fields
                   if isinstance(f.dtype, T.StringType)]
        for fi in self._groups[p]:
            f = pq.ParquetFile(self.paths[fi], read_dictionary=strings)
            for rb in f.iter_batches(batch_size=self.batch_rows,
                                     columns=names):
                yield from_arrow(rb, self.device, self._schema)
