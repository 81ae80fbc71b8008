"""Columnar batches.

Counterpart of ``spark_rapids_tpu/columnar/batch.py``.  A batch holds
its live rows only, so ``num_rows`` is a host int and equals every
column's length.  The device is explicit: a batch with no columns (a
COUNT(*) input) still knows where its results belong.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import (
    AnyColumn,
    Column,
    ListColumn,
    MapColumn,
    StringColumn,
    StructColumn,
)


@dataclasses.dataclass
class ColumnarBatch:
    columns: list[AnyColumn]
    num_rows: int
    schema: T.Schema
    device: torch.device

    def with_columns(self, columns: Sequence[AnyColumn],
                     schema: T.Schema) -> "ColumnarBatch":
        return ColumnarBatch(list(columns), self.num_rows, schema,
                             self.device)

    def gather(self, indices: torch.Tensor) -> "ColumnarBatch":
        return ColumnarBatch([c.gather(indices) for c in self.columns],
                             int(indices.shape[0]), self.schema,
                             self.device)

    def compact(self, keep: torch.Tensor) -> "ColumnarBatch":
        """Keep the rows where ``keep`` is True, in order (one device
        sync for the surviving count)."""
        return self.gather(torch.nonzero(keep).squeeze(1))

    def slice(self, start: int, stop: int) -> "ColumnarBatch":
        """Rows [start, stop) as views: no copy, no device work."""
        start, stop = min(start, self.num_rows), min(stop, self.num_rows)
        return ColumnarBatch([c.slice_rows(start, stop) for c in self.columns],
                             max(stop - start, 0), self.schema, self.device)

    def slice_prefix(self, n: int) -> "ColumnarBatch":
        """The first ``n`` rows (all of them when there are fewer)."""
        return self.slice(0, n)


def null_column(dtype: T.DataType, num_rows: int, device: torch.device,
                width: int = 1) -> AnyColumn:
    """``num_rows`` NULLs of a type: zeroed data, or strings of
    ``width`` zeroed chars and length 0."""
    valid = torch.zeros(num_rows, dtype=torch.bool, device=device)
    if isinstance(dtype, (T.ListType, T.MapType)):
        offsets = torch.zeros(num_rows + 1, dtype=torch.int32, device=device)
        if isinstance(dtype, T.ListType):
            return ListColumn(offsets, null_column(dtype.element, 0, device),
                              valid, dtype)
        return MapColumn(offsets, null_column(dtype.key, 0, device),
                         null_column(dtype.value, 0, device), valid, dtype)
    if isinstance(dtype, T.StructType):
        return StructColumn(tuple(null_column(f.dtype, num_rows, device)
                                  for f in dtype.fields), valid, dtype)
    if isinstance(dtype, T.StringType):
        return StringColumn(
            torch.zeros((num_rows, width), dtype=torch.uint8, device=device),
            torch.zeros(num_rows, dtype=torch.int32, device=device), valid)
    return Column(torch.zeros(num_rows, dtype=T.to_torch_dtype(dtype),
                              device=device), valid, dtype)


def null_batch(schema: T.Schema, num_rows: int,
               device: torch.device) -> ColumnarBatch:
    """``num_rows`` rows of a schema, every value NULL (zeroed data,
    empty strings)."""
    return ColumnarBatch([null_column(f.dtype, num_rows, device)
                          for f in schema.fields], num_rows, schema, device)


def empty_batch(schema: T.Schema, device: torch.device) -> ColumnarBatch:
    """Zero-row batch of a schema."""
    return null_batch(schema, 0, device)


def concat_columns(parts: Sequence[AnyColumn],
                   dtype: T.DataType) -> AnyColumn:
    """Columns of one type end to end.  Dictionary sidecars drop (each
    part may carry its own dictionary); strings widen to the widest
    part; an array's or a map's offsets shift by the elements before
    each part."""
    validity = torch.cat([p.validity for p in parts])
    if isinstance(dtype, T.StructType):
        return StructColumn(tuple(
            concat_columns([p.children[i] for p in parts], f.dtype)
            for i, f in enumerate(dtype.fields)), validity, dtype)
    if isinstance(dtype, (T.ListType, T.MapType)):
        ends = torch.stack([p.offsets[-1] for p in parts]).to(torch.int64)
        base = (torch.cumsum(ends, 0) - ends).to(torch.int32)
        offsets = torch.cat([parts[0].offsets[:1]] + [
            p.offsets[1:] + base[i] for i, p in enumerate(parts)])
        if isinstance(dtype, T.ListType):
            return ListColumn(offsets, concat_columns(
                [p.child for p in parts], dtype.element), validity, dtype)
        return MapColumn(
            offsets, concat_columns([p.keys for p in parts], dtype.key),
            concat_columns([p.values for p in parts], dtype.value),
            validity, dtype)
    if isinstance(dtype, T.StringType):
        w = max(p.width for p in parts)
        parts = [p.with_width(w) for p in parts]
        return StringColumn(torch.cat([p.chars for p in parts]),
                            torch.cat([p.lengths for p in parts]), validity)
    return Column(torch.cat([p.data for p in parts]), validity, dtype)


def concat_batches(batches: Sequence[ColumnarBatch]) -> ColumnarBatch:
    """Concatenate batches of one schema (``concat_columns`` column by
    column)."""
    assert batches, "concat of zero batches"
    if len(batches) == 1:
        return batches[0]
    first = batches[0]
    out = [concat_columns([b.columns[ci] for b in batches], f.dtype)
           for ci, f in enumerate(first.schema.fields)]
    return ColumnarBatch(out, sum(b.num_rows for b in batches),
                         first.schema, first.device)
