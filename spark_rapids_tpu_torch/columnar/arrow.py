"""Arrow <-> device batch conversion.

Counterpart of ``spark_rapids_tpu/columnar/arrow.py`` (``from_arrow``
and ``to_arrow``).  Host arrays go to the device through pinned host
tensors and ``.to(device, non_blocking=True)``; the CUDA caching host
allocator keeps each pinned buffer alive until its copy has run.

A dictionary-encoded string column (Parquet read with
``read_dictionary``) uploads its int32 codes and the small dictionary;
the row byte matrix is gathered on the device from the dictionary, and
the codes stay on the column as the sidecar the coded group-by reads.
"""

from __future__ import annotations

from typing import Sequence

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


def column_from_arrow(arr, dtype: T.DataType,
                      device: torch.device) -> AnyColumn:
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
            v = to_device(valid, device)
            c = to_device(codes, device)
            dchars_t = to_device(dchars, device)
            dlens_t = to_device(dlens, device)
            chars = dchars_t[c.long()] * v[:, None].to(torch.uint8)
            lengths = torch.where(v, dlens_t[c.long()], 0).to(torch.int32)
            return StringColumn(chars, lengths, v, T.STRING, c, dchars_t,
                                dlens_t)
        offsets, data = _string_buffers(arr)
        chars, lengths = strings_to_matrix(offsets, data, valid)
        return StringColumn(to_device(chars, device),
                            to_device(lengths, device),
                            to_device(valid, device))
    if pa.types.is_dictionary(arr.type):
        arr = arr.cast(arr.type.value_type)
    if isinstance(dtype, T.DateType):
        arr = arr.cast(pa.int32())
    values = arr.fill_null(False if isinstance(dtype, T.BooleanType)
                           else 0).to_numpy(zero_copy_only=False)
    return Column(to_device(values.astype(_numpy_dtype(dtype)), device),
                  to_device(valid, device), dtype)


def schema_from_arrow(schema: pa.Schema) -> T.Schema:
    return T.Schema([T.Field(f.name, T.from_arrow_type(f.type), f.nullable)
                     for f in schema])


def from_arrow(table, device: torch.device,
               schema: T.Schema | None = None) -> ColumnarBatch:
    """A pyarrow Table or RecordBatch -> one device batch."""
    schema = schema or schema_from_arrow(table.schema)
    cols = [column_from_arrow(table.column(f.name), f.dtype, device)
            for f in schema.fields]
    return ColumnarBatch(cols, table.num_rows, schema, torch.device(device))


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


def batches_to_arrow(batches: Sequence[ColumnarBatch],
                     schema: T.Schema) -> pa.Table:
    tables = [to_arrow(b) for b in batches]
    if not tables:
        return schema_to_arrow(schema).empty_table()
    return pa.concat_tables(tables)
