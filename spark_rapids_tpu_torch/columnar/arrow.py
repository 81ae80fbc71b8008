"""Arrow <-> device batch conversion.

Counterpart of ``spark_rapids_tpu/columnar/arrow.py`` (``from_arrow``
and ``to_arrow``).  An upload runs in two halves, so a scan can run the
first on a stage thread of its own (``io/scan.py``):

- ``stage_upload``: each column's host tensors are allocated once,
  pinned on the card path (``torch.empty(pin_memory=True)``, from the
  CUDA caching host allocator; ``pinTime``), and filled straight from
  the Arrow buffers in one pass (``_Filler``; ``hostCopyTime``): the
  conversion to numpy, the zeroing of NULL slots, the widening of a
  type, the owned copy and the pinned copy, which were separate passes
  before, are that one pass, and a dictionary column of a fixed-width
  type is gathered (``dict_values[codes]``) into it.  Reading the
  validity bitmaps and string offsets is ``convertTime``.  Then the
  copy to the card is enqueued with ``non_blocking=True`` on the
  session's upload stream and an event recorded there.  The copy is
  issued under that stream, so the caching host allocator keeps each
  pinned buffer until the copy has run;
- ``finish_upload``: the consuming stream waits for the event before
  the first use, each uploaded tensor is recorded on that stream (the
  caching allocator then cannot hand its block out while the stream
  still reads it), and the columns are assembled there.

Each part's host time, and whether the copy was still running when the
consumer took it, can go to a scan's metrics.

With a ``transfer.WirePolicy`` (``sql.scan.packedUpload`` on) a batch
whose schema has a wire form takes the wire path instead
(``columnar/transfer.py``): ``stage_upload`` encodes it
(``encodeTime``), packs every component into one pinned buffer
(``pinTime``, ``hostCopyTime``) and enqueues one copy of it
(``copyEnqueueTime``); ``finish_upload`` waits for that copy, records
the one device buffer on the consumer's stream and decodes the columns
there from views of it.  ``wireBytes`` counts the staged bytes, and
``encodedBatches`` / ``plainBatches`` the batches on each path; the
choice is the schema's, made before any copy.  Nothing falls back: a
failed encode, copy or decode raises (the copy behind the
``transfer.upload`` fault seam's one retry).

An array, map or struct column uploads in Arrow's own layout, in the
same pass: the row validity, the offsets rebased to 0 (a sliced array's
offsets are absolute into its whole child) and each child column's
elements between the first and the last offset, filled as a column of
its own (``_Filler.nested``).

A dictionary-encoded string column (Parquet read with
``read_dictionary``, or from ``io/fastpar.py``) uploads its int32 codes
and the small dictionary;
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

from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import (
    AnyColumn,
    Column,
    ListColumn,
    MapColumn,
    StringColumn,
    StructColumn,
)

#: the host time of each part of an upload, and the count of batches
#: whose copy was still running when the consumer took them
UPLOAD_METRICS = ("convertTime", "hostCopyTime", "pinTime",
                  "copyEnqueueTime", "uploadWaitTime", "uploadPending",
                  "encodeTime", "wireBytes", "encodedBatches",
                  "plainBatches")


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
                      valid: np.ndarray, out: Optional[np.ndarray] = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Offset-encoded strings -> (zero-padded (N, W) uint8 matrix,
    int32 lengths); NULL rows become empty strings.  ``out``: the
    matrix to fill, of width at least the longest string."""
    starts = offsets[:-1].astype(np.int64)
    lengths = (offsets[1:] - offsets[:-1]).astype(np.int32)
    lengths = np.where(valid, lengths, 0).astype(np.int32)
    n = len(lengths)
    width = max(int(lengths.max()) if n else 0, 1)
    if out is None:
        chars = np.zeros((n, width), np.uint8)
    else:
        chars = out
        width = chars.shape[1]
        if not len(data):
            chars[:] = 0
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


class _Filler:
    """Fills one batch's host tensors straight from Arrow buffers.

    Each destination is allocated once (``torch.empty(pin_memory=True)``
    on the card path, so from the CUDA caching host allocator; plain
    memory for the CPU) and written in one pass over its source: a
    fixed-width column is copied with ``np.copyto``, which widens its
    type in that pass, and its NULL slots are zeroed in place; a
    dictionary column of a fixed-width type gathers ``dict_values[codes]``
    into the buffer (``np.take(..., out=)``); string matrices are
    filled in place.  Allocation time goes to ``pinTime``, reading the
    Arrow buffers (validity bitmaps, offsets) to ``convertTime`` and the
    fill to ``hostCopyTime``."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.ns = dict.fromkeys(("convertTime", "hostCopyTime", "pinTime"),
                                0)

    def _lap(self, name: str, t0: int) -> int:
        now = time.perf_counter_ns()
        self.ns[name] += now - t0
        return now

    def empty(self, shape, np_dtype) -> tuple[torch.Tensor, np.ndarray]:
        """A host tensor and its numpy view."""
        t0 = time.perf_counter_ns()
        dt = torch.from_numpy(np.empty(0, np_dtype)).dtype
        t = torch.empty(shape, dtype=dt, pin_memory=self.pinned)
        self._lap("pinTime", t0)
        return t, t.numpy()

    def validity(self, arr: pa.Array, out: np.ndarray) -> bool:
        """Unpack ``arr``'s validity into ``out``; whether it has NULLs."""
        if arr.null_count == 0:
            out[:] = True
            return False
        if arr.buffers()[0] is None:  # the NULL type: no bitmap
            out[:] = False
            return True
        bitmap = np.frombuffer(arr.buffers()[0], np.uint8)
        bits = np.unpackbits(bitmap, count=arr.offset + len(arr),
                             bitorder="little")[arr.offset:]
        np.copyto(out, bits, casting="unsafe")
        return True

    def fixed(self, chunks: list, dtype: T.DataType) -> dict:
        """("fixed") values and validity of a fixed-width column."""
        n = sum(len(c) for c in chunks)
        valid, mnp = self.empty((n,), np.bool_)
        if isinstance(dtype, T.NullType):
            values, vnp = self.empty((n,), np.bool_)
            vnp[:] = False
            mnp[:] = False
            return {"values": values, "valid": valid}
        np_dt = _numpy_dtype(dtype)
        values, vnp = self.empty((n,), np_dt)
        at = 0
        for arr in chunks:
            m = len(arr)
            arr = _without_dictionary_nulls(arr)
            t0 = time.perf_counter_ns()
            dst, ok = vnp[at:at + m], mnp[at:at + m]
            nulls = self.validity(arr, ok)
            t0 = self._lap("convertTime", t0)
            if m == 0 or pa.types.is_null(arr.type):
                dst[:] = 0
            elif pa.types.is_dictionary(arr.type):
                codes = fixed_view(arr.indices)
                dvals = arr.dictionary
                if len(dvals) == 0:  # every row NULL
                    dst[:] = 0
                else:
                    dnp = np.empty(len(dvals), np_dt)
                    _fill_values(dvals, dnp)
                    _gather(dnp, codes, dst)
            else:
                _fill_values(arr, dst)
            if nulls:
                np.putmask(dst, ~ok, 0)
            self._lap("hostCopyTime", t0)
            at += m
        return {"values": values, "valid": valid}

    def matrix(self, arr: pa.Array, valid: np.ndarray) -> dict:
        """(chars, lengths) of a string array, filled in place."""
        t0 = time.perf_counter_ns()
        offsets, data = _string_buffers(arr)
        lengths = np.where(valid, offsets[1:] - offsets[:-1], 0)
        width = max(int(lengths.max()) if len(lengths) else 0, 1)
        t0 = self._lap("convertTime", t0)
        chars, cnp = self.empty((len(arr), width), np.uint8)
        lens, lnp = self.empty((len(arr),), np.int32)
        t0 = time.perf_counter_ns()
        np.copyto(lnp, lengths, casting="unsafe")
        strings_to_matrix(offsets, data, valid, out=cnp)
        self._lap("hostCopyTime", t0)
        return {"chars": chars, "lengths": lens}

    def nested(self, arr: pa.Array, dtype: T.DataType) -> dict:
        """An array, map or struct as host tensors: "valid", and
        "offsets" (rebased to 0) with the child columns' (kind, tensors)
        under "e" (an array's elements), "k" and "v" (a map's keys and
        values) or "f<i>" (a struct's fields)."""
        valid, vnp = self.empty((len(arr),), np.bool_)
        t0 = time.perf_counter_ns()
        self.validity(arr, vnp)
        self._lap("convertTime", t0)
        out: dict = {"valid": valid}
        if isinstance(dtype, T.StructType):
            for i, f in enumerate(dtype.fields):
                out[f"f{i}"] = self.column(arr.field(i), f.dtype)
            return out
        t0 = time.perf_counter_ns()
        absolute = arr.offsets.to_numpy()
        lo, hi = int(absolute[0]), int(absolute[-1])
        self._lap("convertTime", t0)
        offsets, onp = self.empty((len(arr) + 1,), np.int32)
        np.subtract(absolute, lo, out=onp, casting="unsafe")
        if isinstance(dtype, T.ListType):
            out["e"] = self.column(arr.values.slice(lo, hi - lo),
                                   dtype.element)
        else:
            out["k"] = self.column(arr.keys.slice(lo, hi - lo), dtype.key)
            out["v"] = self.column(arr.items.slice(lo, hi - lo), dtype.value)
        out["offsets"] = offsets
        return out

    def column(self, col, dtype: T.DataType) -> tuple[str, dict]:
        """One Arrow column as host tensors: ("fixed", values, valid),
        ("string", chars, lengths, valid), ("dict", codes, valid, and
        the dictionary's chars and lengths) or ("nested", ``nested``'s
        tensors)."""
        chunks = col.chunks if isinstance(col, pa.ChunkedArray) else [col]
        if isinstance(dtype, T.NESTED_TYPES):
            return "nested", self.nested(
                chunks[0] if len(chunks) == 1 else pa.concat_arrays(chunks),
                dtype)
        if not isinstance(dtype, T.StringType):
            return "fixed", self.fixed(chunks, dtype)
        t0 = time.perf_counter_ns()
        arr = _without_dictionary_nulls(
            chunks[0] if len(chunks) == 1 else pa.concat_arrays(chunks))
        self._lap("convertTime", t0)
        valid, vnp = self.empty((len(arr),), np.bool_)
        nulls = self.validity(arr, vnp)
        if not pa.types.is_dictionary(arr.type):
            return "string", {**self.matrix(arr, vnp), "valid": valid}
        dictionary = arr.dictionary
        if len(dictionary) == 0:
            dictionary = pa.array([""], pa.string())
        d = self.matrix(dictionary, np.ones(len(dictionary), np.bool_))
        codes, cnp = self.empty((len(arr),), np.int32)
        t0 = time.perf_counter_ns()
        if len(arr):
            np.copyto(cnp, fixed_view(arr.indices), casting="unsafe")
        if nulls:
            np.putmask(cnp, ~vnp, 0)
        self._lap("hostCopyTime", t0)
        return "dict", {"codes": codes, "valid": valid,
                        "dchars": d["chars"], "dlens": d["lengths"]}


def _without_dictionary_nulls(arr: pa.Array) -> pa.Array:
    """A dictionary array whose dictionary holds a NULL, cast to its
    value type: its row NULLs are not in its own validity bitmap."""
    if pa.types.is_dictionary(arr.type) and arr.dictionary.null_count:
        return arr.cast(arr.type.value_type)
    return arr


def _gather(dictionary: np.ndarray, codes: np.ndarray,
            out: np.ndarray) -> None:
    """``out[i] = dictionary[codes[i]]``, a code out of range clipped:
    the host codec's ``gather_codes`` for int32 codes, else numpy."""
    if codes.dtype == np.int32 and dictionary.itemsize in (1, 2, 4, 8):
        codes = np.ascontiguousarray(codes)
        rc = native.load().gather_codes(
            dictionary.ctypes.data, len(dictionary), dictionary.itemsize,
            codes.ctypes.data, len(codes), out.ctypes.data)
        if rc == 0:
            return
    np.take(dictionary, codes, out=out, mode="clip")


#: microseconds per unit of an Arrow timestamp (ns divides by 1000)
US_PER_UNIT = {"s": 1_000_000, "ms": 1_000, "us": 1}


def fixed_view(arr: pa.Array) -> np.ndarray:
    """A zero-copy view of a fixed-width array's values buffer (NULL
    slots hold whatever is there): a date as its int32 day numbers, a
    timestamp as its raw int64 count of its unit, a decimal as its
    unscaled integers.  A decimal128 slot is 16 little-endian bytes in
    two's complement; for a precision up to 18 its value is the low 8
    bytes, read as a strided int64 view."""
    t = arr.type
    if pa.types.is_decimal(t):
        width = t.byte_width
        if width == 16:
            words = np.frombuffer(arr.buffers()[1], np.int64,
                                  count=2 * len(arr),
                                  offset=arr.offset * 16)
            return words[0::2]
        np_dt = np.dtype(f"<i{width}")
    elif pa.types.is_date32(t):
        np_dt = np.dtype(np.int32)
    elif pa.types.is_timestamp(t):
        np_dt = np.dtype(np.int64)
    else:
        np_dt = np.dtype(t.to_pandas_dtype())
    return np.frombuffer(arr.buffers()[1], np_dt, count=len(arr),
                         offset=arr.offset * np_dt.itemsize)


def _fill_values(arr: pa.Array, out: np.ndarray) -> None:
    """``out`` = the engine's physical values of a plain fixed-width
    array, in one pass over its buffer: booleans unpacked, a timestamp
    in microseconds (ns floored, as Spark converts an instant), any
    other type copied and widened as ``out`` needs."""
    t = arr.type
    if pa.types.is_boolean(t):
        bits = np.unpackbits(np.frombuffer(arr.buffers()[1], np.uint8),
                             count=arr.offset + len(arr),
                             bitorder="little")[arr.offset:]
        np.copyto(out, bits, casting="unsafe")
    elif pa.types.is_timestamp(t) and t.unit == "ns":
        np.floor_divide(fixed_view(arr), 1000, out=out)
    elif pa.types.is_timestamp(t) and t.unit != "us":
        np.multiply(fixed_view(arr), US_PER_UNIT[t.unit], out=out)
    else:
        np.copyto(out, fixed_view(arr), casting="unsafe")


def _map_tensors(ts: dict, fn) -> dict:
    """``fn`` over every tensor of a column's host dict, children
    included."""
    return {k: (v[0], _map_tensors(v[1], fn)) if isinstance(v, tuple)
            else fn(v) for k, v in ts.items()}


def _tensors(ts: dict):
    for v in ts.values():
        if isinstance(v, tuple):
            yield from _tensors(v[1])
        else:
            yield v


def _assemble(kind: str, dtype: T.DataType, t: dict) -> AnyColumn:
    """A column from its uploaded tensors, on the current stream."""
    if kind == "nested":
        if isinstance(dtype, T.StructType):
            return StructColumn(tuple(
                _assemble(t[f"f{i}"][0], f.dtype, t[f"f{i}"][1])
                for i, f in enumerate(dtype.fields)), t["valid"], dtype)
        if isinstance(dtype, T.ListType):
            return ListColumn(t["offsets"], _assemble(
                t["e"][0], dtype.element, t["e"][1]), t["valid"], dtype)
        return MapColumn(t["offsets"],
                         _assemble(t["k"][0], dtype.key, t["k"][1]),
                         _assemble(t["v"][0], dtype.value, t["v"][1]),
                         t["valid"], dtype)
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
    tensors, or on the wire path the one device buffer with its layout
    and plan (``wire``), and the event recorded after the copies (None
    when the copies went on the consumer's stream or to the CPU)."""

    columns: list[tuple[str, T.DataType, dict]]
    num_rows: int
    schema: T.Schema
    device: torch.device
    event: Optional[object] = None
    wire: Optional[tuple] = None


@contextlib.contextmanager
def _copy_context(device: torch.device, stream):
    """The device and stream the copies to ``device`` are issued on."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device), (
            torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext()):
        yield


def _record_event(device: torch.device, stream):
    if device.type != "cuda" or stream is None:
        return None
    event = torch.cuda.Event()
    event.record(stream)
    return event


def stage_upload(table, device: torch.device,
                 schema: T.Schema | None = None, stream=None,
                 metrics=None, wire=None) -> UploadUnit:
    """The first half of an upload (module docstring): a pyarrow Table
    or RecordBatch to device tensors whose copies are enqueued on
    ``stream`` (a ``torch.cuda.Stream``; None: the current stream).
    ``metrics`` (an ``execs.base.Metrics`` with ``UPLOAD_METRICS``, or
    None) takes each part's host time.  ``wire``: a
    ``transfer.WirePolicy`` (the wire path where the schema has a wire
    form), or None (the plain path)."""
    from spark_rapids_tpu_torch.columnar import transfer

    device = torch.device(device)
    schema = schema or schema_from_arrow(table.schema)
    names = table.column_names
    # by position where the table's names line up (a join's output may
    # name two columns alike), else by name
    columns = [table.column(i if names[i:i + 1] == [f.name] else f.name)
               for i, f in enumerate(schema.fields)]
    if wire is not None and table.num_rows and transfer.takes_schema(schema):
        return _stage_wire(columns, table.num_rows, device, schema, stream,
                           metrics, wire)
    filler = _Filler(pinned=device.type == "cuda")
    cols = [(*filler.column(c, f.dtype), f.dtype)
            for c, f in zip(columns, schema.fields)]
    if metrics is not None:
        for name, ns in filler.ns.items():
            metrics.add(name, ns)
        metrics.add("plainBatches", 1)
    host = [t for _k, ts, _d in cols for t in _tensors(ts)]
    transfer.note_plain_upload(sum(t.numel() * t.element_size()
                                   for t in host), len(host))
    if device.type != "cuda":
        cols = [(kind, dtype, _map_tensors(ts, lambda t: t.to(device)))
                for kind, ts, dtype in cols]
        return UploadUnit(cols, table.num_rows, schema, device)
    timer = _Timer(metrics)
    with _copy_context(device, stream):
        cols = [(kind, dtype, _map_tensors(
            ts, lambda t: t.to(device, non_blocking=True)))
                for kind, ts, dtype in cols]
        event = _record_event(device, stream)
    timer.lap("copyEnqueueTime")
    return UploadUnit(cols, table.num_rows, schema, device, event)


def _stage_wire(columns: list, n: int, device: torch.device,
                schema: T.Schema, stream, metrics, wire) -> UploadUnit:
    """The wire path's first half: encode, stage every component in one
    host buffer, enqueue its one copy."""
    from spark_rapids_tpu_torch.columnar import transfer

    timer = _Timer(metrics)
    comps, plan = transfer.encode_for_device(columns, schema, n,
                                             wire.codecs)
    timer.lap("encodeTime")
    total, lay = transfer.layout(comps)
    buf = torch.empty(max(total, 1), dtype=torch.uint8,
                      pin_memory=device.type == "cuda")
    timer.lap("pinTime")
    transfer.fill(buf, comps, lay)
    timer.lap("hostCopyTime")
    dev_buf = transfer.upload_staged(buf, device, len(comps), stream)
    with _copy_context(device, stream):
        event = _record_event(device, stream)
    timer.lap("copyEnqueueTime")
    if metrics is not None:
        metrics.add("wireBytes", int(buf.numel()))
        metrics.add("encodedBatches", 1)
    return UploadUnit([], n, schema, device, event, (dev_buf, lay, plan))


def finish_upload(unit: UploadUnit, metrics=None) -> ColumnarBatch:
    """The second half of an upload: the current stream waits for the
    copies, holds their tensors (the wire path's one buffer: its
    columns are views of it or made from it), and assembles the batch,
    on the wire path by the device decode."""
    if unit.event is not None:
        timer = _Timer(metrics)
        pending = not unit.event.query()
        cur = torch.cuda.current_stream(unit.device)
        cur.wait_event(unit.event)
        if unit.wire is not None:
            unit.wire[0].record_stream(cur)
        for _kind, _dtype, ts in unit.columns:
            for t in _tensors(ts):
                t.record_stream(cur)
        timer.lap("uploadWaitTime")
        if metrics is not None:
            metrics.add("uploadPending", int(pending))
    if unit.wire is not None:
        from spark_rapids_tpu_torch.columnar import transfer

        buf, lay, plan = unit.wire
        cols = transfer.decode_on_device(buf, lay, plan, unit.schema)
    else:
        cols = [_assemble(kind, dtype, ts)
                for kind, dtype, ts in unit.columns]
    return ColumnarBatch(cols, unit.num_rows, unit.schema, unit.device)


def schema_from_arrow(schema: pa.Schema) -> T.Schema:
    return T.Schema([T.Field(f.name, T.from_arrow_type(f.type), f.nullable)
                     for f in schema])


def from_arrow(table, device: torch.device,
               schema: T.Schema | None = None, wire=None) -> ColumnarBatch:
    """A pyarrow Table or RecordBatch -> one device batch, on the
    current stream; ``wire`` as ``stage_upload`` takes it."""
    return finish_upload(stage_upload(table, device, schema, wire=wire))


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


def _nested_to_arrow(col, dtype: T.DataType, valid: np.ndarray,
                     bitmap) -> pa.Array:
    n = len(valid)
    if isinstance(dtype, T.StructType):
        kids = [column_to_arrow(c, f.dtype)
                for c, f in zip(col.children, dtype.fields)]
        return pa.Array.from_buffers(T.to_arrow_type(dtype), n, [bitmap],
                                     children=kids)
    offsets = col.offsets.cpu().numpy()
    lo, hi = int(offsets[0]), int(offsets[-1])
    obuf = pa.py_buffer(np.ascontiguousarray(offsets - lo, np.int32))
    if isinstance(dtype, T.ListType):
        child = column_to_arrow(col.child.slice_rows(lo, hi), dtype.element)
        return pa.Array.from_buffers(T.to_arrow_type(dtype), n,
                                     [bitmap, obuf], children=[child])
    at = T.to_arrow_type(dtype)
    entries = pa.Array.from_buffers(
        pa.struct([at.key_field, at.item_field]), hi - lo, [None], children=[
            column_to_arrow(col.keys.slice_rows(lo, hi), dtype.key),
            column_to_arrow(col.values.slice_rows(lo, hi), dtype.value)])
    return pa.Array.from_buffers(at, n, [bitmap, obuf], children=[entries])


def column_to_arrow(col: AnyColumn, dtype: T.DataType) -> pa.Array:
    valid = col.validity.cpu().numpy()
    n = len(valid)
    all_valid = bool(valid.all())
    if isinstance(dtype, T.NESTED_TYPES):
        return _nested_to_arrow(col, dtype, valid, None if all_valid
                                else pa.py_buffer(np.packbits(
                                    valid, bitorder="little")))
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
    if isinstance(dtype, T.NullType):
        return pa.nulls(n)
    values = col.data.cpu().numpy()
    mask = None if all_valid else ~valid
    if isinstance(dtype, T.DateType):
        return pa.array(values, pa.int32(), mask=mask).cast(pa.date32())
    if isinstance(dtype, T.DecimalType):
        # decimal128 from buffers: the low word is the unscaled value,
        # the high word its sign extension
        words = np.empty((n, 2), np.int64)
        words[:, 0] = values
        words[:, 1] = values >> 63
        bitmap = None if all_valid else pa.py_buffer(
            np.packbits(valid, bitorder="little"))
        return pa.Array.from_buffers(T.to_arrow_type(dtype), n,
                                     [bitmap, pa.py_buffer(words)])
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
