"""SQL data types and their physical torch dtypes.

Counterpart of ``spark_rapids_tpu/types.py``, cut to what the TPC-H
q1/q6 slice needs: BOOLEAN, INT, LONG, DOUBLE, DATE and STRING, plus the
NULL type of an untyped literal.  64-bit types never narrow: LONG stays
int64 and DOUBLE float64 on every device.

Physical mapping:
- fixed-width types -> one 1-D tensor plus a bool validity tensor;
- DATE -> int32 days since the epoch;
- STRING -> a fixed-width ``(N, W)`` uint8 byte matrix plus int32
  lengths (see ``columnar/column.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


class DataType:
    """Base class for SQL-level data types."""

    name: str = "?"

    def __repr__(self) -> str:
        return self.name

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self))


class BooleanType(DataType):
    name = "boolean"


class IntegerType(DataType):
    name = "int"


class LongType(DataType):
    name = "bigint"


class DoubleType(DataType):
    name = "double"


class StringType(DataType):
    name = "string"


class DateType(DataType):
    """Days since the unix epoch, int32."""

    name = "date"


class NullType(DataType):
    name = "null"


BOOLEAN = BooleanType()
INT = IntegerType()
LONG = LongType()
DOUBLE = DoubleType()
STRING = StringType()
DATE = DateType()
NULL = NullType()

_TORCH_DTYPES = {
    BooleanType: torch.bool,
    IntegerType: torch.int32,
    LongType: torch.int64,
    DoubleType: torch.float64,
    DateType: torch.int32,
    NullType: torch.bool,
}


def to_torch_dtype(dt: DataType) -> torch.dtype:
    """Physical torch dtype backing a fixed-width SQL type."""
    try:
        return _TORCH_DTYPES[type(dt)]
    except KeyError:
        raise TypeError(f"no fixed-width physical type for {dt}") from None


def from_arrow_type(at) -> DataType:
    """Map a pyarrow DataType to ours (dictionary -> its value type)."""
    import pyarrow as pa

    if pa.types.is_dictionary(at):
        return from_arrow_type(at.value_type)
    if pa.types.is_boolean(at):
        return BOOLEAN
    if pa.types.is_int32(at):
        return INT
    if pa.types.is_int64(at):
        return LONG
    if pa.types.is_float64(at):
        return DOUBLE
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return STRING
    if pa.types.is_date32(at):
        return DATE
    if pa.types.is_null(at):
        return NULL
    raise TypeError(f"arrow type {at} is not supported by this port yet")


def to_arrow_type(dt: DataType):
    import pyarrow as pa

    m = {
        BooleanType: pa.bool_(),
        IntegerType: pa.int32(),
        LongType: pa.int64(),
        DoubleType: pa.float64(),
        StringType: pa.string(),
        DateType: pa.date32(),
        NullType: pa.null(),
    }
    try:
        return m[type(dt)]
    except KeyError:
        raise TypeError(f"unsupported type {dt}") from None


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True

    def __repr__(self) -> str:
        n = "" if self.nullable else " not null"
        return f"{self.name}: {self.dtype}{n}"


@dataclasses.dataclass(frozen=True)
class Schema:
    fields: tuple[Field, ...]

    def __init__(self, fields):
        object.__setattr__(self, "fields", tuple(fields))

    @property
    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        return self.fields[self.index_of(name)]

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __repr__(self) -> str:
        return "Schema(" + ", ".join(map(repr, self.fields)) + ")"


def common_type(a: DataType, b: DataType) -> Optional[DataType]:
    """Numeric widening as Spark's implicit promotion; NULL widens to
    anything."""
    if a == b:
        return a
    if isinstance(a, NullType):
        return b
    if isinstance(b, NullType):
        return a
    order = {IntegerType: 0, LongType: 1, DoubleType: 2}
    ta, tb = type(a), type(b)
    if ta in order and tb in order:
        return [INT, LONG, DOUBLE][max(order[ta], order[tb])]
    return None
