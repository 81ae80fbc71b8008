"""Device-resident columns.

Counterpart of ``spark_rapids_tpu/columnar/column.py``.  The JAX package
pads every column to a power-of-two capacity and strings to a width
bucket, because XLA compiles one program per static shape.  PyTorch runs
eagerly, so a column here holds exactly its live rows: ``len(column)``
is the batch's row count, and there are no padding rows to mask.

- SQL NULLs are a bool ``validity`` tensor (True = valid).
- Strings are a fixed-width ``(N, W)`` uint8 byte matrix plus int32
  ``lengths``; ``W`` is the longest string of the batch (at least 1).
  Bytes past a row's length are zero, exactly as in the JAX package, so
  string hashes and byte comparisons agree between the two engines.
- Arrays and maps keep Arrow's layout, where the JAX package pads them
  into dense ``(rows, max_len)`` matrices: int32 ``offsets[N + 1]``
  from 0, a flat child column of ``offsets[N]`` elements with its own
  validity (a map: a ``keys`` and a ``values`` child), and the row
  ``validity``.  An upload copies Arrow's offsets and child buffers as
  they are, one long list inflates no other row, and explode is a
  ``repeat_interleave`` of row ids.  A NULL row may still span elements
  (Arrow allows it): they are not part of the row, and every reader
  masks ``lengths`` by the row validity.  Structs are a child column per
  field and a row validity, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from spark_rapids_tpu_torch import types as T


@dataclasses.dataclass
class Column:
    """A fixed-width column: ``data[N]`` + ``validity[N]``.

    The optional dictionary sidecar (``codes[N]`` into ``dict_values[K]``)
    lets the coded group-by use codes as dense group ids; ops that
    cannot keep it drop it."""

    data: torch.Tensor
    validity: torch.Tensor
    dtype: T.DataType
    codes: Optional[torch.Tensor] = None
    dict_values: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def with_validity(self, validity: torch.Tensor) -> "Column":
        return dataclasses.replace(self, validity=validity)

    def gather(self, indices: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> "Column":
        """Rows by index; where ``valid`` is False the row comes out
        NULL (an outer join's missing side)."""
        validity = self.validity[indices]
        codes = None if self.codes is None else self.codes[indices]
        if valid is not None:
            validity = validity & valid
            codes = None if codes is None else torch.where(valid, codes, 0)
        return Column(self.data[indices], validity, self.dtype, codes,
                      self.dict_values)

    def slice_rows(self, start: int, stop: int) -> "Column":
        """Rows [start, stop) as views of this column's tensors."""
        codes = None if self.codes is None else self.codes[start:stop]
        return Column(self.data[start:stop], self.validity[start:stop],
                      self.dtype, codes, self.dict_values)


@dataclasses.dataclass
class StringColumn:
    """Fixed-width string column: ``chars[N, W]`` uint8 + ``lengths[N]``
    int32 + ``validity[N]``, with an optional dictionary sidecar
    (``codes[N]`` int32, 0 on null rows, into ``dict_chars[K, W]`` /
    ``dict_lens[K]``) that feeds the coded group-by."""

    chars: torch.Tensor
    lengths: torch.Tensor
    validity: torch.Tensor
    dtype: T.DataType = dataclasses.field(default_factory=lambda: T.STRING)
    codes: Optional[torch.Tensor] = None
    dict_chars: Optional[torch.Tensor] = None
    dict_lens: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return int(self.chars.shape[0])

    @property
    def width(self) -> int:
        return int(self.chars.shape[1])

    def with_validity(self, validity: torch.Tensor) -> "StringColumn":
        return dataclasses.replace(self, validity=validity)

    def gather(self, indices: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> "StringColumn":
        """Rows by index; where ``valid`` is False the row comes out
        NULL with zeroed chars and length 0."""
        chars = self.chars[indices]
        lengths = self.lengths[indices]
        validity = self.validity[indices]
        codes = None if self.codes is None else self.codes[indices]
        if valid is not None:
            validity = validity & valid
            chars = chars * valid[:, None].to(torch.uint8)
            lengths = torch.where(valid, lengths, 0)
            codes = None if codes is None else torch.where(valid, codes, 0)
        return StringColumn(chars, lengths, validity, self.dtype, codes,
                            self.dict_chars, self.dict_lens)

    def slice_rows(self, start: int, stop: int) -> "StringColumn":
        """Rows [start, stop) as views of this column's tensors."""
        codes = None if self.codes is None else self.codes[start:stop]
        return StringColumn(self.chars[start:stop], self.lengths[start:stop],
                            self.validity[start:stop], self.dtype, codes,
                            self.dict_chars, self.dict_lens)

    def with_width(self, width: int) -> "StringColumn":
        """The same strings in a wider byte matrix (zero padded)."""
        if width <= self.width:
            return self
        pad = torch.zeros((len(self), width - self.width), dtype=torch.uint8,
                          device=self.chars.device)
        return StringColumn(torch.cat([self.chars, pad], dim=1),
                            self.lengths, self.validity)


def take_ranges(starts: torch.Tensor, lengths: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows whose elements are ``[starts[i], starts[i] + lengths[i])``
    of a child, laid end to end: the new int32 offsets (from 0) and the
    child index of every element, in row order.  One sizing sync."""
    n = int(lengths.shape[0])
    dev = lengths.device
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lengths.to(torch.int64), 0, out=offsets[1:])
    total = int(offsets[-1])
    row = torch.repeat_interleave(torch.arange(n, device=dev),
                                  lengths.to(torch.int64),
                                  output_size=total)
    elem = starts.to(torch.int64)[row] + (
        torch.arange(total, device=dev) - offsets[:-1][row])
    return offsets.to(torch.int32), elem


class _Ragged:
    """What an array and a map share: ``offsets[N + 1]`` into their
    children and the row ``validity``."""

    offsets: torch.Tensor
    validity: torch.Tensor

    def __len__(self) -> int:
        return int(self.validity.shape[0])

    def lengths(self) -> torch.Tensor:
        """int32 elements per row, 0 on a NULL row."""
        lens = self.offsets[1:] - self.offsets[:-1]
        return torch.where(self.validity, lens, 0).to(torch.int32)

    def with_validity(self, validity: torch.Tensor):
        return dataclasses.replace(self, validity=validity)

    def _children(self) -> tuple:
        raise NotImplementedError

    def _rebuild(self, offsets, children, validity):
        raise NotImplementedError

    def gather(self, indices: torch.Tensor,
               valid: Optional[torch.Tensor] = None):
        """Rows by index, their elements copied end to end; where
        ``valid`` is False the row comes out NULL and empty."""
        validity = self.validity[indices]
        if valid is not None:
            validity = validity & valid
        lens = torch.where(validity, self.lengths()[indices], 0)
        offsets, elem = take_ranges(self.offsets[:-1][indices], lens)
        return self._rebuild(offsets, [c.gather(elem)
                                       for c in self._children()], validity)

    def slice_rows(self, start: int, stop: int):
        """Rows [start, stop): the offsets rebased to 0 and the children
        as views of their elements (one sync for the two bounds)."""
        lo, hi = self.offsets[[start, stop]].tolist()
        return self._rebuild(self.offsets[start:stop + 1] - lo,
                             [c.slice_rows(lo, hi) for c in self._children()],
                             self.validity[start:stop])


@dataclasses.dataclass
class ListColumn(_Ragged):
    """array<element>: ``offsets[N + 1]`` int32 into the flat ``child``
    column, and the row ``validity``."""

    offsets: torch.Tensor
    child: "AnyColumn"
    validity: torch.Tensor
    dtype: T.DataType = dataclasses.field(
        default_factory=lambda: T.ListType(T.LONG))

    def _children(self) -> tuple:
        return (self.child,)

    def _rebuild(self, offsets, children, validity) -> "ListColumn":
        return ListColumn(offsets, children[0], validity, self.dtype)


@dataclasses.dataclass
class MapColumn(_Ragged):
    """map<key, value>: ``offsets[N + 1]`` int32 into two aligned flat
    children, ``keys`` (never NULL) and ``values``, and the row
    ``validity``."""

    offsets: torch.Tensor
    keys: "AnyColumn"
    values: "AnyColumn"
    validity: torch.Tensor
    dtype: T.DataType = dataclasses.field(
        default_factory=lambda: T.MapType(T.LONG, T.LONG))

    def _children(self) -> tuple:
        return (self.keys, self.values)

    def _rebuild(self, offsets, children, validity) -> "MapColumn":
        return MapColumn(offsets, children[0], children[1], validity,
                         self.dtype)


@dataclasses.dataclass
class StructColumn:
    """struct<...>: one child column per field, each of N rows, and the
    row ``validity``; a field read through a NULL row is NULL
    (``exprs/complex.py::GetStructField``)."""

    children: tuple
    validity: torch.Tensor
    dtype: T.DataType = dataclasses.field(
        default_factory=lambda: T.StructType([]))

    def __len__(self) -> int:
        return int(self.validity.shape[0])

    def with_validity(self, validity: torch.Tensor) -> "StructColumn":
        return dataclasses.replace(self, validity=validity)

    def gather(self, indices: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> "StructColumn":
        validity = self.validity[indices]
        if valid is not None:
            validity = validity & valid
        return StructColumn(tuple(c.gather(indices, valid)
                                  for c in self.children),
                            validity, self.dtype)

    def slice_rows(self, start: int, stop: int) -> "StructColumn":
        return StructColumn(tuple(c.slice_rows(start, stop)
                                  for c in self.children),
                            self.validity[start:stop], self.dtype)


AnyColumn = Union[Column, StringColumn, ListColumn, MapColumn, StructColumn]


#: the smallest capacity bucket (the JAX package's ``MIN_CAPACITY``)
MIN_CAPACITY = 8


def pad_capacity(n: int) -> int:
    """A row count rounded up to its capacity bucket, the next power of
    two and at least ``MIN_CAPACITY``: the JAX package's
    ``pad_capacity`` under its default ``pow2`` policy (the port has no
    other).  Port batches hold their live rows: only the speculation's
    predictor buckets counts (``parallel/speculation.py``)."""
    c = MIN_CAPACITY
    while c < n:
        c <<= 1
    return c
