"""Multi-file Parquet, ORC and CSV scans, and the in-memory source.

Counterpart of ``ParquetScanExec``, ``OrcScanExec`` and ``CsvScanExec``
in ``spark_rapids_tpu/io/scan.py``.
Files group into scan tasks (the exec's partitions) by the same rule as
there, ``_group_files``: files pack into one task until the next would
push it past ``scan.taskTargetBytes`` (default 512 MiB), so both
engines plan the same shape for the same conf.  Only the columns the
plan reads are decoded.

A file is read in four steps, each the JAX scan's:

0. Hive partition pruning: a file whose partition values violate a
   pushed conjunct (``io/pushdown.py::partition_may_match``) is not
   opened (``filesPruned``);
1. row-group pruning on the footers: the conjuncts of the Filter the
   planner pushed into the scan (``pushed_filter``; ``io/pushdown.py::
   row_group_may_match``, ``rowGroupsPruned``), then the runtime join
   filters' [min, max] (application point 1 of
   ``plan/runtime_filter.py``, ``rfRowGroupsPruned``);
2. decode: by ``pyarrow.parquet`` (``standardDecodedFiles``), string
   columns dictionary-encoded, or with ``scan.fastDecode`` (default
   off, unlike the JAX key: pyarrow decoded faster on the card's host)
   by the native decoder (``io/fastpar.py``), which decodes the kept
   row groups and applies the pushed conjuncts that read one column and
   the runtime filters on the Parquet dictionaries
   (``fastDecodedFiles``).  A file with any chunk outside its scope is
   read whole by pyarrow.  Either way string columns reach the coded
   group-by with their codes.  The native decoder decodes a row
   group's columns on one pool of a thread a host core, shared by
   every scan task;
3. the host prefilter: the runtime filters probe the decoded rows
   (point 3, ``rfPrunedRows``) unless the decoder already applied every
   one to every row, then, with ``scan.hostPrefilter`` (default on),
   the whole pushed condition drops rows before upload
   (``hostFilteredRows``): in its compiled ``pyarrow.compute`` form
   (``io/pa_filter.py::compile_filter``) where it compiles and runs,
   else through ``cpu/engine.py::cpu_eval``.  When the planner elided
   the device Filter (``exact_prefilter``), the scan reads the
   condition's columns besides its output, filters exactly (a host
   evaluation failure raises) and emits only its output columns;
4. each decoded table is cut into batches of at most ``batch_rows``
   (the size the memory runtime expects; a batch the filters emptied is
   not emitted) and uploaded (``columnar/arrow.py::stage_upload``): with
   ``sql.scan.packedUpload`` on, on the wire path
   (``columnar/transfer.py``), whose encode runs after every filter
   above, so only the kept rows of the output columns are encoded, as in
   JAX; the planner hands the scan that choice and the codecs with its
   ``TaskRuntime`` (``wire``), read on the session's thread.

Each file's footer is checked against the datetime rebase policy
(``io/rebase.py``) when it is opened, before pruning.

Each decoded table of a file gets the file's partition and hidden
columns appended before the host prefilter, in the schema's order
(file columns, partition columns, then the hidden input-file columns a
relation built ``with_input_files`` carries, asked for by the
planner's ``_rewrite_input_file_exprs``): a partition value repeated
(a STRING as a one-entry dictionary column, NULL as nulls), the file's
path (as a one-entry dictionary column), 0 and the file's size in
bytes.  A read of partition or hidden columns alone counts the rows of
the kept row groups (ORC: of the file) and decodes nothing.  The
pushed condition never reads the hidden columns (the planner keeps
such conjuncts on the device Filter); footer pruning never prunes on a
partition column (it has no statistics), and the native decoder takes
only the conjuncts over the file's own columns (the prefilter then
applies the whole condition).

The conf keys (``scan.fastDecode``, ``scan.hostPrefilter``,
``scan.maxReadBatchSizeBytes``: the most bytes a row group's needed
columns may decode to on the fast path, 128 MiB, and
``parquet.datetimeRebaseModeInRead``) are read by the
planner on the session's thread and handed to the exec, as the JAX
``execute_partition`` warns they must be.  The JAX package's
accumulation across row groups and ``_harmonize_dicts`` serve its wire
encoder and are not ported (an ORC file's stripes are joined up to
``batch_rows``, ``OrcScanExec``).  ORC and CSV decode with pyarrow; a
CSV file is a scan task of its own, read whole.

A scan task runs as the JAX one does (``_local_units`` there): its
files decode on a pool of ``scan.decodeThreads`` threads, at most that
many files in flight and yielded in file order; the decoded batches
cross a ``scan.decode`` stage, the first half of their upload (host
copies into pinned buffers, the copy enqueued on the session's upload
stream) runs on a ``scan.upload`` stage, and the task's consumer
finishes each upload on its own stream.  With ``pipeline.enabled`` off
the stages run inline, and with one decode thread the files decode one
after another.  Runtime filters are read when a scan task's generator
first runs (a filter its build side has not published yet applies
nothing).

``metrics`` (atomic: tasks and decodes run on several threads) count
rows emitted (``numOutputRows``, after every filter), the counters
above, and the host time of each part of a task: ``decodeTime``
(opening files, decode, pruning and the host filters, summed over the
decode threads) and ``columnar/arrow.py``'s ``UPLOAD_METRICS`` (the
wire path's ``encodeTime``, ``wireBytes`` and the batches on each
path among them).

``ArrowSourceExec`` (``io/scan.py`` there) serves a host Arrow table
(``TorchSession.create_dataframe``): a partition per ``batch_rows``
rows, each uploaded to the session's device through the same
``stage_upload`` / ``finish_upload`` path and side stream.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import torch

from spark_rapids_tpu_torch import trace as _trace
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import (
    UPLOAD_METRICS,
    finish_upload,
    stage_upload,
)
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.cpu.engine import cpu_eval
from spark_rapids_tpu_torch.execs.base import (
    POOL_THREAD_PREFIX,
    Metrics,
    TaskRuntime,
    TpuExec,
)
from spark_rapids_tpu_torch.exprs.base import (
    BoundReference,
    Expression,
    bind_references,
)
from spark_rapids_tpu_torch.exprs.nondeterministic import (
    INPUT_FILE_FIELDS,
    InputFileBlockLength,
    InputFileName,
)
from spark_rapids_tpu_torch.io import fastpar
from spark_rapids_tpu_torch.io.pa_filter import (
    compile_filter,
    runtime_filter_column_mask,
)
from spark_rapids_tpu_torch.io.pushdown import (
    partition_may_match,
    row_group_may_match,
    runtime_range_may_match,
    split_conjuncts,
    typed_partition_value,
)
from spark_rapids_tpu_torch.io.rebase import check_rebase
from spark_rapids_tpu_torch.parallel.pipeline import prefetch
from spark_rapids_tpu_torch.plan import runtime_filter as _rf

#: the scan's counters, besides the host split
SCAN_COUNTERS = ("numOutputRows", "scanTime", "filesPruned",
                 "rowGroupsPruned",
                 "hostFilteredRows",
                 "rfPrunedRows", "rfRowGroupsPruned", "fastDecodedFiles",
                 "standardDecodedFiles")
#: the hidden input-file columns' names
HIDDEN_COLUMNS = frozenset(f.name for f in INPUT_FILE_FIELDS)


def input_file_column(name: str, path: str, n: int) -> pa.Array:
    """A hidden input-file column of ``n`` rows of the file ``path``."""
    if name == InputFileName.HIDDEN:
        return pa.DictionaryArray.from_arrays(
            pa.array(np.zeros(n, np.int32)), pa.array([path]))
    value = os.path.getsize(path) \
        if name == InputFileBlockLength.HIDDEN else 0
    return pa.array(np.full(n, value, np.int64))


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


def partition_column(f: T.Field, v, n: int) -> pa.Array:
    """``n`` rows of the partition value ``v`` (None: NULL) of field
    ``f``; a STRING value as a one-entry dictionary column."""
    if isinstance(f.dtype, T.StringType):
        if v is None:
            return pa.nulls(n, pa.string())
        return pa.DictionaryArray.from_arrays(
            pa.array(np.zeros(n, np.int32)), pa.array([str(v)]))
    if v is None:
        return pa.nulls(n, pa.int64())
    return pa.array(np.full(n, v, np.int64))


def _row_counts(n: int) -> list[pa.Table]:
    """``n`` rows of no column."""
    return [pa.table({"_": pa.nulls(n)}).drop(["_"])] if n else []


class ParquetScanExec(TpuExec):
    def __init__(self, paths: Sequence[str], schema: T.Schema,
                 device: torch.device, task_target_bytes: int,
                 batch_rows: int, columns: Optional[Sequence[str]] = None,
                 estimated_rows: Optional[int] = None,
                 runtime: Optional[TaskRuntime] = None,
                 fast_decode: bool = False, host_prefilter: bool = True,
                 max_decoded_bytes: int = 128 << 20,
                 rebase_mode: str = "EXCEPTION",
                 partition_values: Sequence[dict] = (),
                 partition_fields: Sequence[T.Field] = ()):
        super().__init__()
        self.runtime = runtime or TaskRuntime.serial()
        self.paths = list(paths)
        self.device = torch.device(device)
        self.batch_rows = batch_rows
        self.columns = list(columns) if columns is not None else None
        self._file_schema = schema
        self._schema = schema if columns is None else T.Schema(
            [f for f in schema.fields if f.name in self.columns])
        #: the columns decoded: the output, and with an exact prefilter
        #: the columns its condition reads
        self._read_schema = self._schema
        self._groups = group_files(self.paths, task_target_bytes)
        self.fast_decode = fast_decode
        self.host_prefilter = host_prefilter
        self.max_decoded_bytes = max_decoded_bytes
        self.rebase_mode = rebase_mode
        #: each file's Hive partition values (strings by name), and the
        #: partition columns of ``schema``
        self.partition_values = list(partition_values)
        self.partition_fields = list(partition_fields)
        #: the condition of the Filter above, pushed by the planner
        self.pushed_filter: Optional[Expression] = None
        #: the planner elided that Filter: the prefilter must be exact
        self.exact_prefilter = False
        self._bound_filter: Optional[Expression] = None
        self._conjuncts: Optional[list] = None
        self._pa_filter = None
        self._pa_filter_failed = False
        self._prefilter_failed = False
        #: [(column name, RuntimeFilter)], registered by the planner
        self.runtime_filters: list = []
        #: the conf of a session with shared scans on
        #: (``serving/work_share.py``), set by the planner; None: off
        self.share_conf = None
        #: the files' footer row count, from the logical scan
        #: (plan/cost.py)
        self.estimated_rows = estimated_rows
        self.metrics = Metrics(*SCAN_COUNTERS, "decodeTime",
                               *UPLOAD_METRICS)

    @property
    def _tail_names(self) -> set:
        """The columns a file does not hold: partition and hidden."""
        return HIDDEN_COLUMNS | {f.name for f in self.partition_fields}

    def push_filter(self, condition: Expression, exact: bool = False) -> None:
        """Take the condition of the Filter above (unbound, by name).
        ``exact``: that Filter is elided, so the scan also reads the
        condition's columns and filters exactly."""
        self.pushed_filter = condition
        self.exact_prefilter = exact
        if exact:
            need = set(self._schema.names) | condition.references()
            self._read_schema = T.Schema(
                [f for f in self._file_schema.fields if f.name in need])
        self._bound_filter = bind_references(condition, self._read_schema)
        self._conjuncts = split_conjuncts(self._bound_filter)
        self._pa_filter = compile_filter(self._bound_filter)

    @property
    def schema(self) -> T.Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return len(self._groups)

    @property
    def _prefilter_on(self) -> bool:
        return self.pushed_filter is not None and (
            self.exact_prefilter
            or (self.host_prefilter and not self._prefilter_failed))

    def node_desc(self) -> str:
        pushed = "" if self.pushed_filter is None \
            else f" pushed=[{self.pushed_filter!r}]"
        if self.exact_prefilter:
            pushed += " (device Filter elided)"
        decoded = ""
        fast, std = (self.metrics["fastDecodedFiles"],
                     self.metrics["standardDecodedFiles"])
        if fast or std:
            decoded = f" [files decoded: {fast} fast, {std} standard]"
        pruned = self.metrics["filesPruned"]
        if pruned:
            decoded += f" [files pruned: {pruned}]"
        return (f"{self.name} [{len(self.paths)} files, "
                f"{len(self._groups)} tasks]{pushed}{decoded} "
                f"[{', '.join(self._schema.names)}]")

    def _ready_runtime_filters(self) -> list:
        """The published filters: a scan never waits for one."""
        return [(n, rf) for n, rf in self.runtime_filters if rf.ready]

    def _keep_row_groups(self, f: pq.ParquetFile, rfs: list) -> list[int]:
        """The row groups the pushed conjuncts' footer check and then
        the runtime filters' (application point 1) keep."""
        md = f.metadata
        keep = list(range(md.num_row_groups))
        if self._conjuncts is not None:
            before = len(keep)
            keep = [g for g in keep if row_group_may_match(
                self._conjuncts, self._read_schema, md.row_group(g))]
            self.metrics.add("rowGroupsPruned", before - len(keep))
        if rfs and keep:
            before = len(keep)
            keep = [g for g in keep
                    if all(runtime_range_may_match(n, rf, md.row_group(g))
                           for n, rf in rfs)]
            self.metrics.add("rfRowGroupsPruned", before - len(keep))
            _rf.record("row_groups_pruned", before - len(keep))
        return keep

    def _apply_runtime_filters(self, tbl, rfs: list):
        """Application point 3 (``plan/runtime_filter.py``): drop decoded
        rows whose key no build key can match, before upload.  A column
        the probe cannot model is skipped."""
        keep = None
        with _trace.span("rf.apply", scan=self.name, rows=tbl.num_rows):
            for name, rf in rfs:
                m = runtime_filter_column_mask(tbl.column(name), rf)
                if m is not None:
                    keep = m if keep is None else keep & m
            if keep is None or keep.all():
                return tbl
            kept = tbl.filter(pa.array(keep))
        self.metrics.add("rfPrunedRows", tbl.num_rows - kept.num_rows)
        _rf.record("pruned_rows", tbl.num_rows - kept.num_rows)
        return kept

    def _host_prefilter(self, tbl, rfs: list, filter_done: bool = False):
        """The runtime filters (``rfs``), then the pushed condition
        (unless the decoder applied all of it) over a decoded table,
        before upload.  Outside exact mode a failure turns the
        prefilter off for this scan (the device Filter above decides);
        in exact mode it raises."""
        if rfs:
            tbl = self._apply_runtime_filters(tbl, rfs)
        if filter_done or not self._prefilter_on or tbl.num_rows == 0:
            return tbl
        try:
            mask = None
            if self._pa_filter is not None and not self._pa_filter_failed:
                try:
                    mask = self._pa_filter(tbl)
                except (pa.ArrowException, TypeError, ValueError):
                    # a kernel gap (date32 against an integer literal,
                    # a dictionary column): the CPU engine takes it
                    self._pa_filter_failed = True
            if mask is None:
                mask = cpu_eval(self._bound_filter, tbl)
            kept = tbl.filter(pc.fill_null(mask, False))
        except Exception:
            if self.exact_prefilter:
                raise
            self._prefilter_failed = True
            return tbl
        self.metrics.add("hostFilteredRows", tbl.num_rows - kept.num_rows)
        return kept

    def _fast_tables(self, f: pq.ParquetFile, fi: int, keep: list,
                     rfs: list, file_schema: T.Schema) -> Optional[tuple]:
        """The native decoder's tables of the kept row groups, whether
        it applied the whole pushed condition, and whether it applied
        every runtime filter, to every row; None when the file is
        outside its scope."""
        conjuncts = None
        if self._prefilter_on:
            # only the conjuncts over the file's own columns
            conjuncts = [c for c in self._conjuncts
                         if not self._reads_tail(c)]
        counters: dict = {}
        # the native decoder applies the runtime filters as it decodes
        with _trace.span("rf.apply", scan=self.name, fast=True) if rfs \
                else contextlib.nullcontext():
            tables = fastpar.read_file(
                self.paths[fi], keep, file_schema.names, conjuncts,
                self._read_schema, pqfile=f,
                max_decoded_bytes=self.max_decoded_bytes,
                runtime_filters=rfs or None, counters=counters)
        if tables is None:
            return None
        rf_pruned = counters.get("rf_pruned", 0)
        self.metrics.add("rfPrunedRows", rf_pruned)
        _rf.record("pruned_rows", rf_pruned)
        if conjuncts:
            rows = sum(f.metadata.row_group(g).num_rows for g in keep)
            self.metrics.add("hostFilteredRows",
                             rows - sum(t.num_rows for t in tables)
                             - rf_pruned)
        return (tables, bool(conjuncts)
                and len(conjuncts) == len(self._conjuncts)
                and counters.get("filter_complete", False),
                bool(rfs) and counters.get("rf_complete", False))

    def _reads_tail(self, e: Expression) -> bool:
        """Whether bound ``e`` reads a partition or hidden column."""
        tail = self._tail_names
        stack = [e]
        while stack:
            x = stack.pop()
            if isinstance(x, BoundReference) \
                    and self._read_schema.fields[x.ordinal].name in tail:
                return True
            stack.extend(x.children)
        return False

    def _file_may_match(self, fi: int) -> bool:
        """Hive partition pruning: whether file ``fi``'s partition values
        may pass the pushed conjuncts (``filesPruned`` counts the
        rest)."""
        if self._conjuncts is None or not self.partition_fields:
            return True
        pv = self.partition_values[fi] \
            if fi < len(self.partition_values) else {}
        if partition_may_match(self._conjuncts, self._read_schema, pv,
                               self.partition_fields):
            return True
        self.metrics.add("filesPruned", 1)
        return False

    def _tail_column(self, name: str, fi: int, n: int) -> pa.Array:
        """``n`` rows of file ``fi``'s partition or hidden column."""
        f = next((f for f in self.partition_fields if f.name == name), None)
        if f is None:
            return input_file_column(name, self.paths[fi], n)
        pv = self.partition_values[fi] \
            if fi < len(self.partition_values) else {}
        return partition_column(f, typed_partition_value(pv, f), n)

    def _decode_file(self, fi: int, rfs: list, file_schema: T.Schema):
        """(file ``fi``'s decoded tables of ``file_schema``'s columns,
        whether the pushed condition was applied to them whole, whether
        the runtime filters were): pruned on the footers, then decoded
        by the native decoder or pyarrow."""
        strings = [f.name for f in file_schema.fields
                   if isinstance(f.dtype, T.StringType)]
        f = pq.ParquetFile(self.paths[fi], read_dictionary=strings)
        check_rebase(self.paths[fi], f.metadata, file_schema,
                     self.rebase_mode)
        keep = self._keep_row_groups(f, rfs)
        if not keep:
            return [], False, False
        if not file_schema.fields:
            # partition and hidden columns only: the rows are all it needs
            return _row_counts(sum(f.metadata.row_group(g).num_rows
                                   for g in keep)), False, False
        if self.fast_decode:
            fast = self._fast_tables(f, fi, keep, rfs, file_schema)
            if fast is not None:
                self.metrics.add("fastDecodedFiles", 1)
                return fast
        self.metrics.add("standardDecodedFiles", 1)
        return f.iter_batches(batch_size=self.batch_rows,
                              columns=file_schema.names,
                              row_groups=keep), False, False

    def _file_batches(self, fi: int, rfs: list) -> Iterator[pa.Table]:
        """One file's batches: pruned, decoded, its partition and hidden
        columns appended, prefiltered, and cut to at most
        ``batch_rows`` rows."""
        names = self._read_schema.names
        out_names = self._schema.names
        tail = self._tail_names
        file_schema = T.Schema([f for f in self._read_schema.fields
                                if f.name not in tail])
        t0 = time.perf_counter_ns()
        if not self._file_may_match(fi):
            return
        tables, filter_done, rf_done = self._decode_file(fi, rfs,
                                                         file_schema)
        for tbl in tables:
            if tbl.column_names != names:
                have = dict(zip(tbl.column_names, tbl.columns))
                make = pa.Table.from_arrays if isinstance(tbl, pa.Table) \
                    else pa.RecordBatch.from_arrays
                tbl = make(
                    [have[n] if n in have
                     else self._tail_column(n, fi, tbl.num_rows)
                     for n in names], names)
            tbl = self._host_prefilter(tbl, [] if rf_done else rfs,
                                       filter_done)
            if out_names != names:
                tbl = tbl.select(out_names)
            for off in range(0, tbl.num_rows, self.batch_rows):
                part = tbl.slice(off, self.batch_rows)
                self.metrics.add("numOutputRows", part.num_rows)
                self.metrics.add("decodeTime", time.perf_counter_ns() - t0)
                yield part
                t0 = time.perf_counter_ns()
        self.metrics.add("decodeTime", time.perf_counter_ns() - t0)

    def _decoded(self, p: int, rfs: list) -> Iterator[pa.Table]:
        """Scan task ``p``'s batches in file order: one file after
        another, or on a pool with at most ``decode_threads`` files in
        flight (file k + threads starts while file k's batches are
        consumed)."""
        files = self._groups[p]
        threads = min(self.runtime.decode_threads, len(files))
        if threads <= 1:
            for fi in files:
                yield from self._file_batches(fi, rfs)
            return
        pool = ThreadPoolExecutor(
            max_workers=threads,
            thread_name_prefix=POOL_THREAD_PREFIX + "decode")

        def decode(fi: int) -> list[pa.Table]:
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

    def _staged(self, decoded: Iterator[pa.Table]) -> Iterator:
        """The first half of each decoded batch's upload."""
        try:
            for rb in decoded:
                yield self._stage(rb)
        finally:
            decoded.close()

    def _stage(self, tbl: pa.Table):
        """The first half of ``tbl``'s upload; ``scanTime`` (ns) counts
        both halves' host time (JAX: a host unit to its device batch)."""
        t0 = time.perf_counter_ns()
        unit = stage_upload(tbl, self.device, self._schema,
                            self.runtime.upload_stream, self.metrics,
                            self.runtime.wire)
        self.metrics.add("scanTime", time.perf_counter_ns() - t0)
        return unit

    def _finished(self, unit) -> ColumnarBatch:
        """The second half of an upload (``_stage``)."""
        t0 = time.perf_counter_ns()
        batch = finish_upload(unit, self.metrics)
        self.metrics.add("scanTime", time.perf_counter_ns() - t0)
        return batch

    def task_paths(self, p: int) -> list[str]:
        """The files of scan task ``p``."""
        return [self.paths[fi] for fi in self._groups[p]]

    def task_partition_values(self, p: int) -> list[dict]:
        """The Hive partition values of scan task ``p``'s files."""
        return [self.partition_values[fi] for fi in self._groups[p]
                if fi < len(self.partition_values)]

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        """Scan task ``p``.  With shared scans on (``share_conf``) and no
        runtime filter, a task another query is already decoding under
        the same key is subscribed to instead of decoded again (JAX
        ``io/scan.py``); the first arrival leads and publishes each
        decoded table."""
        names = self._read_schema.names
        rfs = [(n, rf) for n, rf in self._ready_runtime_filters()
               if n in names]
        depth = self.runtime.stage_depth
        share = None
        if self.share_conf is not None and not self.runtime_filters:
            from spark_rapids_tpu_torch import config as C
            from spark_rapids_tpu_torch.plan.share_key import scan_share_key
            from spark_rapids_tpu_torch.serving import work_share as _ws

            skey = scan_share_key(self, p, self.share_conf)
            if skey is not None:
                share, leader = _ws.SCAN_REGISTRY.begin(
                    skey, int(self.share_conf.get(C.SCAN_CACHE_BUDGET)))
                if share is not None and not leader:
                    yield from self._subscribe_shared(share, p, rfs)
                    return
        decoded = self._counted(self._decoded(p, rfs))
        if share is not None:
            decoded = self._publishing(decoded, share)
        units = prefetch(self._staged(prefetch(
            decoded, depth, "scan.decode")), depth, "scan.upload")
        try:
            for unit in units:
                yield self._finished(unit)
        finally:
            units.close()

    @staticmethod
    def _counted(decoded: Iterator[pa.Table]) -> Iterator[pa.Table]:
        """Tick the sharing tier's decode counter per decoded table."""
        from spark_rapids_tpu_torch.serving.work_share import (
            record_scan_decode,
        )

        try:
            for tbl in decoded:
                record_scan_decode(tbl.num_rows)
                yield tbl
        finally:
            decoded.close()

    def _publishing(self, decoded: Iterator[pa.Table], share
                    ) -> Iterator[pa.Table]:
        """The leader's tables, each published to the shared entry as it
        is made; the entry completes after the last, and aborts (its
        subscribers then decode themselves) if the leader stops
        early."""
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch.serving import work_share as _ws

        completed = False
        try:
            for tbl in decoded:
                share.publish(tbl)
                yield tbl
            completed = True
        finally:
            decoded.close()
            if completed:
                share.complete()
            else:
                share.abort()
            _ws.SCAN_REGISTRY.release(
                share, int(self.share_conf.get(C.SCAN_CACHE_BUDGET)))

    def _subscribe_shared(self, share, p: int, rfs: list
                          ) -> Iterator[ColumnarBatch]:
        """Ride another query's decode of this task: upload its tables
        as they come (no tensor is shared); if the leader aborts, decode
        the rest here, skipping the tables already uploaded."""
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch.serving import work_share as _ws

        _ws.tick("scan_subscribes")
        consumed = 0

        def upload(tbl: pa.Table) -> ColumnarBatch:
            return self._finished(self._stage(tbl))

        try:
            try:
                for tbl in share.subscribe_units():
                    _ws.tick("scan_units_shared")
                    self.metrics.add("numOutputRows", tbl.num_rows)
                    consumed += 1
                    yield upload(tbl)
                return
            except _ws.ScanShareAborted:
                pass
            rest = self._counted(self._decoded(p, rfs))
            try:
                for tbl in itertools.islice(rest, consumed, None):
                    yield upload(tbl)
            finally:
                rest.close()
        finally:
            _ws.SCAN_REGISTRY.release(
                share, int(self.share_conf.get(C.SCAN_CACHE_BUDGET)))


class OrcScanExec(ParquetScanExec):
    """ORC files (JAX ``OrcScanExec``): stripes play the part of row
    groups.  Task grouping, partition pruning, the host prefilter, the
    runtime filters' probe, the upload and shared scans are the Parquet
    exec's; pyarrow exposes no stripe statistics, so nothing is pruned
    on them, and pyarrow decodes every stripe.  A file's consecutive
    stripes are joined until they hold ``batch_rows`` rows (the JAX
    scan accumulates them on the host too), so a file the writer split
    into stripes makes the batches its Parquet twin of one row group
    makes."""

    def _decode_file(self, fi: int, rfs: list, file_schema: T.Schema):
        import pyarrow.orc as paorc

        f = paorc.ORCFile(self.paths[fi])
        self.metrics.add("standardDecodedFiles", 1)
        if not file_schema.fields:
            return _row_counts(f.nrows), False, False
        return self._stripes(f, file_schema.names), False, False

    def _stripes(self, f, names: list) -> Iterator[pa.Table]:
        pending: list = []
        rows = 0
        for si in range(f.nstripes):
            rb = f.read_stripe(si, columns=names)
            pending.append(rb)
            rows += rb.num_rows
            if rows >= self.batch_rows:
                yield pa.Table.from_batches(pending)
                pending, rows = [], 0
        if pending:
            yield pa.Table.from_batches(pending)


class CsvScanExec(ParquetScanExec):
    """CSV files with a header line (JAX ``CsvScanExec``): one scan task
    a file, each read whole by pyarrow with the relation's column types
    (``file_fields``; ``plan/logical.py::read_csv_file``).  Partition pruning, the host prefilter, the
    runtime filters' probe and the upload are the Parquet exec's."""

    def __init__(self, paths: Sequence[str], schema: T.Schema,
                 file_fields: Sequence[T.Field], *args, **kwargs):
        super().__init__(paths, schema, *args, **kwargs)
        self._groups = [[i] for i in range(len(self.paths))] or [[]]
        self.file_fields = list(file_fields)

    def _decode_file(self, fi: int, rfs: list, file_schema: T.Schema):
        from spark_rapids_tpu_torch.plan.logical import read_csv_file

        names = file_schema.names
        tbl = read_csv_file(self.paths[fi], self.file_fields, names or None)
        self.metrics.add("standardDecodedFiles", 1)
        if not names:
            return _row_counts(tbl.num_rows), False, False
        return [tbl.select(names)], False, False


class ArrowSourceExec(TpuExec):
    def __init__(self, table: pa.Table, schema: T.Schema,
                 device: torch.device, batch_rows: int,
                 columns: Optional[Sequence[str]] = None,
                 runtime: Optional[TaskRuntime] = None):
        super().__init__()
        self.runtime = runtime or TaskRuntime.serial()
        self.table = table
        self.device = torch.device(device)
        self.batch_rows = batch_rows
        self.columns = columns
        self._schema = schema if columns is None else T.Schema(
            [f for f in schema.fields if f.name in columns])
        self.estimated_rows = table.num_rows
        self.metrics = Metrics("numOutputRows", *UPLOAD_METRICS)

    @property
    def schema(self) -> T.Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return max(1, -(-self.table.num_rows // self.batch_rows))

    def node_desc(self) -> str:
        return (f"ArrowSourceExec [{self.table.num_rows} rows] "
                f"[{', '.join(self._schema.names)}]")

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        chunk = self.table.slice(p * self.batch_rows, self.batch_rows)
        if chunk.num_rows == 0:
            return
        if self.columns is not None:  # the table's own, names may repeat
            chunk = chunk.select(self._schema.names)
        self.metrics.add("numOutputRows", chunk.num_rows)
        yield finish_upload(stage_upload(
            chunk, self.device, self._schema, self.runtime.upload_stream,
            self.metrics, self.runtime.wire), self.metrics)
