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


AnyColumn = Union[Column, StringColumn]
