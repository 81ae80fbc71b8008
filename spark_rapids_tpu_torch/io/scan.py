"""Multi-file Parquet scan, and the in-memory source.

Counterpart of ``ParquetScanExec`` in ``spark_rapids_tpu/io/scan.py``.
Files group into scan tasks (the exec's partitions) by the same rule as
there, ``_group_files``: files pack into one task until the next would
push it past ``scan.taskTargetBytes`` (default 512 MiB), so both
engines plan the same shape for the same conf.  Only the columns the
plan reads are decoded.

A file is read in four steps, each the JAX scan's:

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

A scan whose logical node carries the hidden input-file columns
(``plan/logical.py::Scan(input_files=True)``, asked for by the
planner's ``_rewrite_input_file_exprs``) appends them to each decoded
table of a file, before the host prefilter: the file's path (as a
one-entry dictionary column), 0 and the file's size in bytes.  The
pushed condition never reads them (the planner keeps such conjuncts on
the device Filter), so footer pruning and the native decoder see the
file's own columns only.

The conf keys (``scan.fastDecode``, ``scan.hostPrefilter``,
``scan.maxReadBatchSizeBytes``: the most bytes a row group's needed
columns may decode to on the fast path, 128 MiB, and
``parquet.datetimeRebaseModeInRead``) are read by the
planner on the session's thread and handed to the exec, as the JAX
``execute_partition`` warns they must be.  The JAX package's
accumulation across row groups and ``_harmonize_dicts`` serve its wire
encoder and are not ported, nor is Hive partition pruning.

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
from spark_rapids_tpu_torch.exprs.base import Expression, bind_references
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
    row_group_may_match,
    runtime_range_may_match,
    split_conjuncts,
)
from spark_rapids_tpu_torch.io.rebase import check_rebase
from spark_rapids_tpu_torch.parallel.pipeline import prefetch

#: the scan's counters, besides the host split
SCAN_COUNTERS = ("numOutputRows", "rowGroupsPruned", "hostFilteredRows",
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


class ParquetScanExec(TpuExec):
    def __init__(self, paths: Sequence[str], schema: T.Schema,
                 device: torch.device, task_target_bytes: int,
                 batch_rows: int, columns: Optional[Sequence[str]] = None,
                 estimated_rows: Optional[int] = None,
                 runtime: Optional[TaskRuntime] = None,
                 fast_decode: bool = False, host_prefilter: bool = True,
                 max_decoded_bytes: int = 128 << 20,
                 rebase_mode: str = "EXCEPTION"):
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
        return (f"ParquetScanExec [{len(self.paths)} files, "
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
        conjuncts = self._conjuncts if self._prefilter_on else None
        counters: dict = {}
        # the native decoder applies the runtime filters as it decodes
        with _trace.span("rf.apply", scan=self.name, fast=True) if rfs \
                else contextlib.nullcontext():
            tables = fastpar.read_file(
                self.paths[fi], keep, file_schema.names, conjuncts,
                file_schema, pqfile=f,
                max_decoded_bytes=self.max_decoded_bytes,
                runtime_filters=rfs or None, counters=counters)
        if tables is None:
            return None
        rf_pruned = counters.get("rf_pruned", 0)
        self.metrics.add("rfPrunedRows", rf_pruned)
        if conjuncts:
            rows = sum(f.metadata.row_group(g).num_rows for g in keep)
            self.metrics.add("hostFilteredRows",
                             rows - sum(t.num_rows for t in tables)
                             - rf_pruned)
        return (tables, bool(conjuncts)
                and counters.get("filter_complete", False),
                bool(rfs) and counters.get("rf_complete", False))

    def _file_batches(self, fi: int, rfs: list) -> Iterator[pa.Table]:
        """One file's batches: pruned, decoded, prefiltered, and cut to
        at most ``batch_rows`` rows."""
        names = self._read_schema.names
        out_names = self._schema.names
        hidden = [n for n in names if n in HIDDEN_COLUMNS]
        file_schema = T.Schema([f for f in self._read_schema.fields
                                if f.name not in HIDDEN_COLUMNS])
        names = file_schema.names
        strings = [f.name for f in file_schema.fields
                   if isinstance(f.dtype, T.StringType)]
        t0 = time.perf_counter_ns()
        f = pq.ParquetFile(self.paths[fi], read_dictionary=strings)
        check_rebase(self.paths[fi], f.metadata, file_schema,
                     self.rebase_mode)
        keep = self._keep_row_groups(f, rfs)
        tables, filter_done, rf_done = None, False, False
        if keep and self.fast_decode:
            fast = self._fast_tables(f, fi, keep, rfs, file_schema)
            if fast is not None:
                tables, filter_done, rf_done = fast
        if keep:
            self.metrics.add("fastDecodedFiles" if tables is not None
                             else "standardDecodedFiles", 1)
        if not keep:
            tables = []
        elif tables is None:
            tables = f.iter_batches(batch_size=self.batch_rows,
                                    columns=names, row_groups=keep)
        for tbl in tables:
            for name in hidden:
                tbl = tbl.append_column(name, input_file_column(
                    name, self.paths[fi], tbl.num_rows))
            tbl = self._host_prefilter(tbl, [] if rf_done else rfs,
                                       filter_done)
            if out_names != self._read_schema.names:
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
                yield stage_upload(rb, self.device, self._schema,
                                   self.runtime.upload_stream, self.metrics,
                                   self.runtime.wire)
        finally:
            decoded.close()

    def task_paths(self, p: int) -> list[str]:
        """The files of scan task ``p``."""
        return [self.paths[fi] for fi in self._groups[p]]

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
                yield finish_upload(unit, self.metrics)
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
            return finish_upload(
                stage_upload(tbl, self.device, self._schema,
                             self.runtime.upload_stream, self.metrics,
                             self.runtime.wire),
                self.metrics)

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
