"""File writers: Parquet, CSV and ORC part files, Hive-partitioned or
not, under Spark's four save modes.

Counterpart of ``spark_rapids_tpu/io/write.py`` (the reference's
``GpuFileFormatWriter`` / ``GpuFileFormatDataWriter`` and the
``GpuParquetFileFormat`` / ``GpuOrcFileFormat`` output writers):

- ``FileWriteExec.run`` runs one write task a child partition on the
  session's task pool (``execs/base.py::run_tasks``, ``sql.taskThreads``
  threads, each task holding a permit of the task semaphore while it
  pulls), each writing ``part-{task:05d}-{uuid}{ext}`` files, then the
  ``_SUCCESS`` marker; ``WriteStats`` and the metrics ``numFiles``,
  ``numOutputBytes``, ``numOutputRows`` and ``writeTime`` (ns: download,
  split and encode) count what was written.  Task 0 of an unpartitioned
  write with no rows writes a file with the schema alone.
- With ``partition_by``, each batch is split by the partition columns'
  values into ``col=value`` directories (``_part_str``: NULL is
  ``__HIVE_DEFAULT_PARTITION__``, ``/ \\ { } [ ] # % : =`` are ``%XX``
  escaped; the partition columns are not written into the files).  The
  split runs on the batch's device (``split_on_device``, the reference's
  dynamic-partition writer sorts on the GPU as well): each row's key
  tuple by ``ops/sort.py::column_sort_keys``, a stable ``lexsort`` on
  them, the group starts read back once (``device_read``), the reordered
  batch downloaded once and sliced per partition on the host.  Because
  the sort is stable each partition's rows keep their order in the
  batch, as the JAX writer's filters keep it.  ``host_split`` runs the
  plain host loop instead (``split_on_host``: the batch downloaded, one
  Arrow filter per distinct tuple, the JAX ``_split_by_partitions``);
  ``splitTime`` (ns, download included either way) times the split
  alone.
- A partition is a tuple of values under SQL's grouping: NULL is one
  partition, every NaN one, and -0.0 and 0.0 one, named ``0.0``.  The
  JAX writer keys its files by the Python tuple too (so ``-0.0`` and
  ``0.0`` share one file), but splits by Arrow's ``group_by``, which
  keeps them apart, so it writes each zero row once per sign of zero in
  the batch, and names the directory by the first zero's sign; the port
  writes each row once (ROADMAP.md section 3).
- ``prepare_target`` applies the save mode: ``error`` raises on a
  non-empty target, ``ignore`` skips the write (``run`` is not called),
  ``overwrite`` removes the target first, ``append`` adds files beside
  what is there.

Encoding is pyarrow's on the host, as in JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import threading
import time
import uuid
from typing import Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import schema_to_arrow, to_arrow
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.execs.base import (
    Metrics,
    TaskRuntime,
    TpuExec,
    run_tasks,
)
from spark_rapids_tpu_torch.ops.sort import (
    column_sort_keys,
    group_starts,
    lexsort,
)
from spark_rapids_tpu_torch.parallel.pipeline import device_read
from spark_rapids_tpu_torch.plan.logical import HIVE_DEFAULT_PARTITION

#: characters ``_part_str`` escapes
_ESCAPED = '/\\{}[]#%:='
#: the save modes
SAVE_MODES = ("error", "overwrite", "append", "ignore")


@dataclasses.dataclass
class WriteStats:
    """Files, rows and bytes written, and ``partitions``: the partition
    directories the tasks opened (a directory once per task that wrote
    into it, as in JAX); then the exec's ``writeTime`` and ``splitTime``
    (ns, summed over the tasks), which the JAX stats do not carry."""

    num_files: int = 0
    num_rows: int = 0
    num_bytes: int = 0
    partitions: int = 0
    write_time_ns: int = 0
    split_time_ns: int = 0


class _FormatWriter:
    """One open output file: append Arrow tables, close, report its
    bytes."""

    def write(self, table: pa.Table) -> None:
        raise NotImplementedError

    def close(self) -> int:
        raise NotImplementedError


class _ParquetWriter(_FormatWriter):
    def __init__(self, path: str, schema: pa.Schema, compression: str):
        import pyarrow.parquet as pq

        self.path = path
        self._w = pq.ParquetWriter(path, schema, compression=compression)

    def write(self, table: pa.Table) -> None:
        self._w.write_table(table)

    def close(self) -> int:
        self._w.close()
        return os.path.getsize(self.path)


class _CsvWriter(_FormatWriter):
    def __init__(self, path: str, schema: pa.Schema):
        import pyarrow.csv as pacsv

        self.path = path
        self._w = pacsv.CSVWriter(path, schema)

    def write(self, table: pa.Table) -> None:
        self._w.write_table(table)

    def close(self) -> int:
        self._w.close()
        return os.path.getsize(self.path)


class _OrcWriter(_FormatWriter):
    def __init__(self, path: str, schema: pa.Schema, compression: str):
        import pyarrow.orc as paorc

        self.path = path
        self._w = paorc.ORCWriter(path, compression=compression)

    def write(self, table: pa.Table) -> None:
        self._w.write(table)

    def close(self) -> int:
        self._w.close()
        return os.path.getsize(self.path)


def split_on_device(batch: ColumnarBatch, part_cols: Sequence[str]
                    ) -> list[tuple[tuple, pa.Table]]:
    """(partition values, host rows) of each partition of ``batch``, in
    key order: the rows grouped on the batch's device, read back once
    (module docstring)."""
    if batch.num_rows == 0:
        return []
    names = batch.schema.names
    keys = [k for c in part_cols
            for k in column_sort_keys(batch.columns[names.index(c)],
                                      grouping=True)]
    perm = lexsort(keys)
    starts = torch.nonzero(group_starts(keys, perm)).squeeze(1)
    bounds = [int(b) for b in device_read(starts, "write.split")]
    table = to_arrow(batch.gather(perm))
    return _slices(table, part_cols, bounds + [table.num_rows])


def split_on_host(batch: ColumnarBatch, part_cols: Sequence[str]
                  ) -> list[tuple[tuple, pa.Table]]:
    """``split_on_device``'s partitions by the plain host loop: the
    batch downloaded, one Arrow filter per distinct key tuple (JAX
    ``_split_by_partitions``), the keys taken by their bits."""
    if batch.num_rows == 0:
        return []
    table = to_arrow(batch)
    keys = pa.table({c: _key_bits(table.column(c)) for c in part_cols})
    distinct = keys.group_by(list(part_cols),
                             use_threads=False).aggregate([])
    out = []
    for i in range(distinct.num_rows):
        mask = None
        for c in part_cols:
            v = distinct.column(c)[i]
            m = pc.equal(keys.column(c), v) if v.is_valid \
                else pc.is_null(keys.column(c))
            mask = m if mask is None else pc.and_(mask, m)
        rows = table.filter(mask)
        out.append((_values(rows, part_cols), rows))
    return out


def _key_bits(col: pa.ChunkedArray) -> pa.ChunkedArray:
    """A floating column as its values' int64 bits, every NaN one
    value and -0.0 as 0.0; any other column as it is."""
    if not pa.types.is_floating(col.type):
        return col
    v = col.cast(pa.float64()).fill_null(0.0).to_numpy() + 0.0
    bits = np.where(np.isnan(v), np.int64(0x7FF8000000000000),
                    v.view(np.int64))
    return pa.chunked_array([pa.array(bits,
                                      mask=col.is_null().to_numpy())])


def _slices(table: pa.Table, part_cols: Sequence[str], bounds: list[int]
            ) -> list[tuple[tuple, pa.Table]]:
    out = []
    for lo, hi in zip(bounds, bounds[1:]):
        rows = table.slice(lo, hi - lo)
        out.append((_values(rows, part_cols), rows))
    return out


def _values(rows: pa.Table, part_cols: Sequence[str]) -> tuple:
    """The partition values of ``rows`` (one partition's), from its
    first row; a float zero as 0.0."""
    vals = (rows.column(c)[0].as_py() for c in part_cols)
    return tuple(v + 0.0 if isinstance(v, float) else v for v in vals)


class FileWriteExec(TpuExec):
    """Writes the child's partitions as part files under ``path``
    (module docstring); a command: call ``run``."""

    FORMAT = ""
    EXT = ""

    def __init__(self, path: str, child: TpuExec,
                 partition_by: Sequence[str] = (),
                 compression: str = "snappy",
                 runtime: Optional[TaskRuntime] = None,
                 host_split: bool = False):
        super().__init__(child)
        self.path = path
        self.partition_by = list(partition_by)
        self.compression = compression
        self.runtime = runtime or TaskRuntime.serial()
        self.host_split = host_split
        self.stats = WriteStats()
        self._lock = threading.Lock()
        bad = [c for c in self.partition_by if c not in child.schema.names]
        if bad:
            raise ValueError(f"partition columns not in schema: {bad}")
        self.metrics = Metrics("numFiles", "numOutputBytes",
                               "numOutputRows", "writeTime", "splitTime")

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    def node_desc(self) -> str:
        extra = f" partitioned by {self.partition_by}" \
            if self.partition_by else ""
        return f"{self.name} {self.path}{extra}"

    def _open(self, path: str, schema: pa.Schema) -> _FormatWriter:
        raise NotImplementedError

    def _task_filename(self, task: int) -> str:
        return f"part-{task:05d}-{uuid.uuid4().hex[:12]}{self.EXT}"

    def _data_schema(self) -> pa.Schema:
        return pa.schema([f for f in schema_to_arrow(self.schema)
                          if f.name not in self.partition_by])

    def _split(self, batch: ColumnarBatch) -> list[tuple[tuple, pa.Table]]:
        t0 = time.perf_counter_ns()
        split = split_on_host if self.host_split else split_on_device
        out = split(batch, self.partition_by)
        self.metrics.add("splitTime", time.perf_counter_ns() - t0)
        return out

    def _write_task(self, p: int) -> None:
        data_schema = self._data_schema()
        data_names = data_schema.names
        fname = self._task_filename(p)
        writers: dict[tuple, _FormatWriter] = {}

        def writer_for(values: tuple) -> _FormatWriter:
            w = writers.get(values)
            if w is not None:
                return w
            d = self.path
            if values:
                d = os.path.join(self.path, *(
                    f"{c}={_part_str(v)}"
                    for c, v in zip(self.partition_by, values)))
                os.makedirs(d, exist_ok=True)
                with self._lock:
                    self.stats.partitions += 1
            w = writers[values] = self._open(os.path.join(d, fname),
                                             data_schema)
            return w

        sem, task = self.runtime.semaphore, object()
        rows = 0
        try:
            with contextlib.closing(
                    self.children[0].execute_partition(p)) as batches:
                for batch in batches:
                    sem.acquire_if_necessary(task)
                    t0 = time.perf_counter_ns()
                    rows += batch.num_rows
                    if not self.partition_by:
                        if batch.num_rows or p == 0:
                            writer_for(()).write(to_arrow(batch))
                    else:
                        for values, part in self._split(batch):
                            writer_for(values).write(part.select(data_names))
                    self.metrics.add("writeTime", time.perf_counter_ns() - t0)
            if not self.partition_by and not writers and p == 0:
                writer_for(())  # no rows: a file with the schema alone
        finally:
            sem.release_if_necessary(task)
            nbytes = sum(w.close() for w in writers.values())
            with self._lock:
                self.stats.num_files += len(writers)
                self.stats.num_rows += rows
                self.stats.num_bytes += nbytes
            self.metrics.add("numFiles", len(writers))
            self.metrics.add("numOutputBytes", nbytes)
            self.metrics.add("numOutputRows", rows)

    def run(self) -> WriteStats:
        """Every write task, then the ``_SUCCESS`` marker; the child tree
        is closed on every exit."""
        from spark_rapids_tpu_torch.plan.planner import close_tree

        os.makedirs(self.path, exist_ok=True)
        child = self.children[0]
        try:
            with self.timer():
                run_tasks(self._write_task, child.num_partitions,
                          self.runtime.task_threads)
        finally:
            close_tree(child)
        with open(os.path.join(self.path, "_SUCCESS"), "w"):
            pass
        self.stats.write_time_ns = self.metrics["writeTime"]
        self.stats.split_time_ns = self.metrics["splitTime"]
        return self.stats

    def execute_partition(self, p: int):
        raise TypeError(f"{self.name} is a command; call run()")


class ParquetWriteExec(FileWriteExec):
    FORMAT = "parquet"
    EXT = ".parquet"

    def _open(self, path: str, schema: pa.Schema) -> _FormatWriter:
        return _ParquetWriter(path, schema, self.compression)


class CsvWriteExec(FileWriteExec):
    FORMAT = "csv"
    EXT = ".csv"

    def _open(self, path: str, schema: pa.Schema) -> _FormatWriter:
        return _CsvWriter(path, schema)


class OrcWriteExec(FileWriteExec):
    FORMAT = "orc"
    EXT = ".orc"

    def _open(self, path: str, schema: pa.Schema) -> _FormatWriter:
        return _OrcWriter(path, schema, self.compression)


def _part_str(v) -> str:
    """A partition value as its directory name's value (Hive's
    escaping)."""
    if v is None:
        return HIVE_DEFAULT_PARTITION
    return "".join("%%%02X" % ord(c) if c in _ESCAPED else c
                   for c in str(v))


def prepare_target(path: str, mode: str) -> bool:
    """Apply the save mode to ``path``; False when the write is to be
    skipped (``ignore`` over an existing target)."""
    if mode not in SAVE_MODES:
        raise ValueError(f"unknown save mode {mode!r}")
    exists = os.path.exists(path) and (
        not os.path.isdir(path) or len(os.listdir(path)) > 0)
    if not exists:
        return True
    if mode == "error":
        raise FileExistsError(
            f"path {path} already exists (write mode 'error'; use "
            "mode('overwrite') or mode('append'))")
    if mode == "ignore":
        return False
    if mode == "overwrite":
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.unlink(path)
    return True
