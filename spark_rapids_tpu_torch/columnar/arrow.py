"""Arrow <-> device batch conversion.

Counterpart of ``spark_rapids_tpu/columnar/arrow.py`` (``from_arrow``
and ``to_arrow``).  An upload runs in two halves, so a scan can run the
first on a stage thread of its own (``io/scan.py``):

- ``stage_upload``: Arrow -> host numpy arrays (``convertTime``), an
  owned copy of each (pyarrow buffers are read-only), a pinned copy,
  and the copy to the card enqueued with ``non_blocking=True`` on the
  session's upload stream, then an event recorded there.  The copy is
  issued under that stream, so the CUDA caching host allocator keeps
  each pinned buffer until the copy has run;
- ``finish_upload``: the consuming stream waits for the event before
  the first use, each uploaded tensor is recorded on that stream (the
  caching allocator then cannot hand its block out while the stream
  still reads it), and the columns are assembled there.

Each part's host time, and whether the copy was still running when the
consumer took it, can go to a scan's metrics.

A dictionary-encoded string column (Parquet read with
``read_dictionary``) uploads its int32 codes and the small dictionary;
the row byte matrix is gathered on the device from the dictionary, and
the codes stay on the column as the sidecar the coded group-by reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterable, Optional

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import (
    AnyColumn,
    Column,
    StringColumn,
)

#: the host time of each part of an upload, and the count of batches
#: whose copy was still running when the consumer took them
UPLOAD_METRICS = ("convertTime", "hostCopyTime", "pinTime",
                  "copyEnqueueTime", "uploadWaitTime", "uploadPending")


def _numpy_dtype(dt: T.DataType) -> np.dtype:
    """The numpy dtype of a fixed-width type's physical torch dtype."""
    return torch.empty(0, dtype=T.to_torch_dtype(dt)).numpy().dtype


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array onto ``device``: pinned + async for CUDA, an owned
    copy for the CPU (pyarrow buffers are read-only)."""
    t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def strings_to_matrix(offsets: np.ndarray, data: np.ndarray,
                      valid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Offset-encoded strings -> (zero-padded (N, W) uint8 matrix,
    int32 lengths); NULL rows become empty strings."""
    starts = offsets[:-1].astype(np.int64)
    lengths = (offsets[1:] - offsets[:-1]).astype(np.int32)
    lengths = np.where(valid, lengths, 0).astype(np.int32)
    n = len(lengths)
    width = max(int(lengths.max()) if n else 0, 1)
    chars = np.zeros((n, width), np.uint8)
    if len(data):
        for j in range(width):
            has = j < lengths
            pos = np.minimum(starts + j, len(data) - 1)
            chars[:, j] = np.where(has, data[pos], 0)
    return chars, lengths


def _string_buffers(arr: pa.Array) -> tuple[np.ndarray, np.ndarray]:
    """(offsets, data bytes) of a string/large_string array, offset-
    adjusted for slices."""
    odt = np.int64 if pa.types.is_large_string(arr.type) else np.int32
    bufs = arr.buffers()
    offsets = np.frombuffer(bufs[1], odt)[arr.offset: arr.offset + len(arr)
                                           + 1]
    data = np.frombuffer(bufs[2], np.uint8) if bufs[2] is not None \
        else np.zeros(0, np.uint8)
    return offsets, data


def _validity(arr: pa.Array) -> np.ndarray:
    if arr.null_count == 0:
        return np.ones(len(arr), np.bool_)
    return arr.is_valid().to_numpy(zero_copy_only=False)


def _host_arrays(arr, dtype: T.DataType) -> tuple[str, dict]:
    """One Arrow column as host numpy arrays: ("fixed", values, valid),
    ("string", chars, lengths, valid) or ("dict", codes, valid, and the
    dictionary's chars and lengths)."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    valid = _validity(arr)
    if isinstance(dtype, T.StringType):
        if pa.types.is_dictionary(arr.type):
            dictionary = arr.dictionary
            if len(dictionary) == 0:
                dictionary = pa.array([""], pa.string())
            doffs, ddata = _string_buffers(dictionary)
            dchars, dlens = strings_to_matrix(
                doffs, ddata, np.ones(len(dictionary), np.bool_))
            codes = arr.indices.fill_null(0).to_numpy(
                zero_copy_only=False).astype(np.int32)
            return "dict", {"codes": codes, "valid": valid,
                            "dchars": dchars, "dlens": dlens}
        offsets, data = _string_buffers(arr)
        chars, lengths = strings_to_matrix(offsets, data, valid)
        return "string", {"chars": chars, "lengths": lengths,
                          "valid": valid}
    if pa.types.is_dictionary(arr.type):
        arr = arr.cast(arr.type.value_type)
    if isinstance(dtype, T.DateType):
        arr = arr.cast(pa.int32())
    values = arr.fill_null(False if isinstance(dtype, T.BooleanType)
                           else 0).to_numpy(zero_copy_only=False)
    return "fixed", {"values": values.astype(_numpy_dtype(dtype)),
                     "valid": valid}


def _assemble(kind: str, dtype: T.DataType, t: dict) -> AnyColumn:
    """A column from its uploaded tensors, on the current stream."""
    if kind == "fixed":
        return Column(t["values"], t["valid"], dtype)
    if kind == "string":
        return StringColumn(t["chars"], t["lengths"], t["valid"])
    v, c = t["valid"], t["codes"]
    chars = t["dchars"][c.long()] * v[:, None].to(torch.uint8)
    lengths = torch.where(v, t["dlens"][c.long()], 0).to(torch.int32)
    return StringColumn(chars, lengths, v, T.STRING, c, t["dchars"],
                        t["dlens"])


class _Timer:
    """Adds the nanoseconds since the last ``lap`` to a metric."""

    def __init__(self, metrics):
        self.metrics = metrics
        self.t = time.perf_counter_ns()

    def lap(self, name: str) -> None:
        now = time.perf_counter_ns()
        if self.metrics is not None:
            self.metrics.add(name, now - self.t)
        self.t = now


@dataclasses.dataclass
class UploadUnit:
    """One batch whose copies to the device are enqueued: its columns'
    tensors, and the event recorded after the copies (None when the
    copies went on the consumer's stream or to the CPU)."""

    columns: list[tuple[str, T.DataType, dict]]
    num_rows: int
    schema: T.Schema
    device: torch.device
    event: Optional[object] = None


def stage_upload(table, device: torch.device,
                 schema: T.Schema | None = None, stream=None,
                 metrics=None) -> UploadUnit:
    """The first half of an upload (module docstring): a pyarrow Table
    or RecordBatch to device tensors whose copies are enqueued on
    ``stream`` (a ``torch.cuda.Stream``; None: the current stream).
    ``metrics`` (an ``execs.base.Metrics`` with ``UPLOAD_METRICS``, or
    None) takes each part's host time."""
    device = torch.device(device)
    schema = schema or schema_from_arrow(table.schema)
    timer = _Timer(metrics)
    host = [(f.dtype, *_host_arrays(table.column(f.name), f.dtype))
            for f in schema.fields]
    timer.lap("convertTime")
    owned = [(dtype, kind, {k: torch.from_numpy(np.array(a, copy=True,
                                                         order="C"))
                            for k, a in arrays.items()})
             for dtype, kind, arrays in host]
    timer.lap("hostCopyTime")
    if device.type != "cuda":
        cols = [(kind, dtype, {k: t.to(device) for k, t in ts.items()})
                for dtype, kind, ts in owned]
        return UploadUnit(cols, table.num_rows, schema, device)
    pinned = [(dtype, kind, {k: t.pin_memory() for k, t in ts.items()})
              for dtype, kind, ts in owned]
    timer.lap("pinTime")
    event = None
    with torch.cuda.device(device), (
            torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext()):
        cols = [(kind, dtype, {k: t.to(device, non_blocking=True)
                               for k, t in ts.items()})
                for dtype, kind, ts in pinned]
        if stream is not None:
            event = torch.cuda.Event()
            event.record(stream)
    timer.lap("copyEnqueueTime")
    return UploadUnit(cols, table.num_rows, schema, device, event)


def finish_upload(unit: UploadUnit, metrics=None) -> ColumnarBatch:
    """The second half of an upload: the current stream waits for the
    copies, holds their tensors, and assembles the batch."""
    if unit.event is not None:
        timer = _Timer(metrics)
        pending = not unit.event.query()
        cur = torch.cuda.current_stream(unit.device)
        cur.wait_event(unit.event)
        for _kind, _dtype, ts in unit.columns:
            for t in ts.values():
                t.record_stream(cur)
        timer.lap("uploadWaitTime")
        if metrics is not None:
            metrics.add("uploadPending", int(pending))
    cols = [_assemble(kind, dtype, ts) for kind, dtype, ts in unit.columns]
    return ColumnarBatch(cols, unit.num_rows, unit.schema, unit.device)


def schema_from_arrow(schema: pa.Schema) -> T.Schema:
    return T.Schema([T.Field(f.name, T.from_arrow_type(f.type), f.nullable)
                     for f in schema])


def from_arrow(table, device: torch.device,
               schema: T.Schema | None = None) -> ColumnarBatch:
    """A pyarrow Table or RecordBatch -> one device batch, on the
    current stream."""
    return finish_upload(stage_upload(table, device, schema))


def from_numpy_columns(data: dict, schema: T.Schema,
                       device) -> ColumnarBatch:
    """A device batch from host columns in the JAX package's
    ``column_to_numpy`` form: ``{name: (values, validity)}`` where string
    values are an object array of ``str`` (``None`` on NULL rows).
    This carries the same data into both engines."""
    device = torch.device(device)
    cols: list[AnyColumn] = []
    n = 0
    for f in schema.fields:
        values, valid = data[f.name]
        valid = np.asarray(valid, np.bool_)
        n = len(valid)
        if isinstance(f.dtype, T.StringType):
            enc = [v.encode("utf-8") if (ok and v is not None) else b""
                   for v, ok in zip(values, valid)]
            lens = np.fromiter((len(b) for b in enc), np.int64, n)
            offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
            flat = np.frombuffer(b"".join(enc), np.uint8)
            chars, lengths = strings_to_matrix(offsets, flat, valid)
            cols.append(StringColumn(to_device(chars, device),
                                     to_device(lengths, device),
                                     to_device(valid, device)))
        else:
            cols.append(Column(
                to_device(np.asarray(values).astype(_numpy_dtype(f.dtype)),
                          device),
                to_device(valid, device), f.dtype))
    return ColumnarBatch(cols, n, schema, device)


def column_to_arrow(col: AnyColumn, dtype: T.DataType) -> pa.Array:
    valid = col.validity.cpu().numpy()
    n = len(valid)
    all_valid = bool(valid.all())
    if isinstance(col, StringColumn):
        chars = col.chars.cpu().numpy()
        lengths = np.where(valid, col.lengths.cpu().numpy(), 0)
        offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
        flat = chars[np.arange(chars.shape[1])[None, :] < lengths[:, None]]
        bitmap = None if all_valid else pa.py_buffer(
            np.packbits(valid, bitorder="little"))
        return pa.Array.from_buffers(
            pa.string(), n,
            [bitmap, pa.py_buffer(offsets),
             pa.py_buffer(np.ascontiguousarray(flat))])
    values = col.data.cpu().numpy()
    mask = None if all_valid else ~valid
    if isinstance(dtype, T.DateType):
        return pa.array(values, pa.int32(), mask=mask).cast(pa.date32())
    return pa.array(values, T.to_arrow_type(dtype), mask=mask)


def to_arrow(batch: ColumnarBatch) -> pa.Table:
    arrays = [column_to_arrow(c, f.dtype)
              for f, c in zip(batch.schema.fields, batch.columns)]
    return pa.Table.from_arrays(arrays, schema=schema_to_arrow(batch.schema))


def schema_to_arrow(schema: T.Schema) -> pa.Schema:
    return pa.schema([pa.field(f.name, T.to_arrow_type(f.dtype))
                      for f in schema.fields])


def batches_to_arrow(batches: Iterable[ColumnarBatch],
                     schema: T.Schema) -> pa.Table:
    tables = [to_arrow(b) for b in batches]
    if not tables:
        return schema_to_arrow(schema).empty_table()
    return pa.concat_tables(tables)
