"""SQL data types and their physical torch dtypes.

Counterpart of ``spark_rapids_tpu/types.py`` over its scalar types:
BOOLEAN, TINYINT, SMALLINT, INT, LONG, FLOAT, DOUBLE, DECIMAL(p <= 18,
s), STRING, DATE and TIMESTAMP, plus the NULL type of an untyped
literal.  No type narrows: TINYINT is int8, SMALLINT int16, FLOAT
float32, LONG int64 and DOUBLE float64 on every device.  The nested
types: ARRAY (``ListType``), STRUCT (``StructType``) and MAP
(``MapType``); an array of arrays has no type, as in the JAX package.

Physical mapping:
- fixed-width types -> one 1-D tensor plus a bool validity tensor;
- DATE -> int32 days since the epoch;
- TIMESTAMP -> int64 microseconds since the epoch, UTC;
- DECIMAL(p, s) -> int64 unscaled values (value * 10^s), p <= 18;
- STRING -> a fixed-width ``(N, W)`` uint8 byte matrix plus int32
  lengths (see ``columnar/column.py``);
- ARRAY and MAP -> Arrow's layout: int32 offsets, a flat child column
  (a map: a keys and a values child), a row validity; STRUCT -> a child
  column per field and a row validity.
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

    @property
    def is_numeric(self) -> bool:
        return False


class BooleanType(DataType):
    name = "boolean"


class IntegralType(DataType):
    bits = 64

    @property
    def is_numeric(self) -> bool:
        return True


class ByteType(IntegralType):
    name = "tinyint"
    bits = 8


class ShortType(IntegralType):
    name = "smallint"
    bits = 16


class IntegerType(IntegralType):
    name = "int"
    bits = 32


class LongType(IntegralType):
    name = "bigint"
    bits = 64


class FractionalType(DataType):
    @property
    def is_numeric(self) -> bool:
        return True


class FloatType(FractionalType):
    name = "float"


class DoubleType(FractionalType):
    name = "double"


class StringType(DataType):
    name = "string"


class DateType(DataType):
    """Days since the unix epoch, int32."""

    name = "date"


class TimestampType(DataType):
    """Microseconds since the unix epoch, int64, UTC only."""

    name = "timestamp"


@dataclasses.dataclass(frozen=True)
class DecimalType(DataType):
    """Decimal with precision <= 18, backed by int64 unscaled values."""

    precision: int = 10
    scale: int = 0
    MAX_PRECISION = 18

    def __post_init__(self):
        if self.precision > self.MAX_PRECISION:
            raise ValueError(
                f"decimal precision {self.precision} > {self.MAX_PRECISION}")

    @property
    def name(self) -> str:  # type: ignore[override]
        return f"decimal({self.precision},{self.scale})"

    @property
    def is_numeric(self) -> bool:
        return True

    def __repr__(self) -> str:
        return self.name

    def __eq__(self, other) -> bool:
        return (isinstance(other, DecimalType)
                and other.precision == self.precision
                and other.scale == self.scale)

    def __hash__(self) -> int:
        return hash((DecimalType, self.precision, self.scale))


class NullType(DataType):
    name = "null"


class ListType(DataType):
    """array<element>.  On the card the element is fixed-width (the
    planner's tags send any other to the CPU engine, as the JAX
    package's do); a nested list is refused outright."""

    def __init__(self, element: DataType):
        if isinstance(element, ListType):
            raise TypeError(f"list element type {element} not supported "
                            "(no nested lists)")
        self.element = element

    @property
    def name(self) -> str:  # type: ignore[override]
        return f"array<{self.element.name}>"

    def __eq__(self, other) -> bool:
        return isinstance(other, ListType) and other.element == self.element

    def __hash__(self) -> int:
        return hash((ListType, self.element))


class StructType(DataType):
    """struct<name: type, ...>: a child column per field."""

    def __init__(self, fields):
        self.fields = tuple(fields)

    @property
    def name(self) -> str:  # type: ignore[override]
        inner = ", ".join(f"{f.name}: {f.dtype.name}" for f in self.fields)
        return f"struct<{inner}>"

    def field_index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def __eq__(self, other) -> bool:
        return isinstance(other, StructType) and other.fields == self.fields

    def __hash__(self) -> int:
        return hash((StructType, self.fields))


class MapType(DataType):
    """map<key, value>: keys are never NULL, values may be."""

    def __init__(self, key: DataType, value: DataType):
        self.key = key
        self.value = value

    @property
    def name(self) -> str:  # type: ignore[override]
        return f"map<{self.key.name},{self.value.name}>"

    def __eq__(self, other) -> bool:
        return (isinstance(other, MapType) and other.key == self.key
                and other.value == self.value)

    def __hash__(self) -> int:
        return hash((MapType, self.key, self.value))


NESTED_TYPES = (ListType, StructType, MapType)


BOOLEAN = BooleanType()
BYTE = ByteType()
SHORT = ShortType()
INT = IntegerType()
LONG = LongType()
FLOAT = FloatType()
DOUBLE = DoubleType()
STRING = StringType()
DATE = DateType()
TIMESTAMP = TimestampType()
NULL = NullType()

INTEGRAL_TYPES = (BYTE, SHORT, INT, LONG)
NUMERIC_TYPES = INTEGRAL_TYPES + (FLOAT, DOUBLE)
ALL_BASIC_TYPES = NUMERIC_TYPES + (BOOLEAN, STRING, DATE, TIMESTAMP)

#: decimal integral digits that hold each integral type losslessly
#: (Spark's DecimalType.forType).  Shared by common_type and
#: Cast.cast_supported: they must agree, or union widening would pick a
#: target the cast then refuses
INTEGRAL_DECIMAL_DIGITS = {ByteType: 3, ShortType: 5, IntegerType: 10,
                           LongType: 19}

_TORCH_DTYPES = {
    BooleanType: torch.bool,
    ByteType: torch.int8,
    ShortType: torch.int16,
    IntegerType: torch.int32,
    LongType: torch.int64,
    FloatType: torch.float32,
    DoubleType: torch.float64,
    DateType: torch.int32,
    TimestampType: torch.int64,
    DecimalType: torch.int64,
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
    if pa.types.is_int8(at):
        return BYTE
    if pa.types.is_int16(at):
        return SHORT
    if pa.types.is_int32(at):
        return INT
    if pa.types.is_int64(at):
        return LONG
    if pa.types.is_float32(at):
        return FLOAT
    if pa.types.is_float64(at):
        return DOUBLE
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return STRING
    if pa.types.is_date32(at):
        return DATE
    if pa.types.is_timestamp(at):
        return TIMESTAMP
    if pa.types.is_decimal(at):
        if at.precision > DecimalType.MAX_PRECISION:
            raise TypeError(f"decimal precision {at.precision} unsupported")
        return DecimalType(at.precision, at.scale)
    if pa.types.is_null(at):
        return NULL
    if pa.types.is_list(at) or pa.types.is_large_list(at):
        return ListType(from_arrow_type(at.value_type))
    if pa.types.is_struct(at):
        return StructType([Field(at.field(i).name,
                                 from_arrow_type(at.field(i).type),
                                 at.field(i).nullable)
                           for i in range(at.num_fields)])
    if pa.types.is_map(at):
        return MapType(from_arrow_type(at.key_type),
                       from_arrow_type(at.item_type))
    raise TypeError(f"arrow type {at} is not supported by this port yet")


def to_arrow_type(dt: DataType):
    import pyarrow as pa

    m = {
        BooleanType: pa.bool_(),
        ByteType: pa.int8(),
        ShortType: pa.int16(),
        IntegerType: pa.int32(),
        LongType: pa.int64(),
        FloatType: pa.float32(),
        DoubleType: pa.float64(),
        StringType: pa.string(),
        DateType: pa.date32(),
        TimestampType: pa.timestamp("us", tz="UTC"),
        NullType: pa.null(),
    }
    if isinstance(dt, DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
    if isinstance(dt, ListType):
        return pa.list_(to_arrow_type(dt.element))
    if isinstance(dt, StructType):
        return pa.struct([pa.field(f.name, to_arrow_type(f.dtype),
                                   nullable=f.nullable) for f in dt.fields])
    if isinstance(dt, MapType):
        return pa.map_(to_arrow_type(dt.key), to_arrow_type(dt.value))
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
    order = {ByteType: 0, ShortType: 1, IntegerType: 2, LongType: 3,
             FloatType: 4, DoubleType: 5}
    ta, tb = type(a), type(b)
    if ta in order and tb in order:
        return [BYTE, SHORT, INT, LONG, FLOAT, DOUBLE][
            max(order[ta], order[tb])]
    if ta is DecimalType and tb is DecimalType:
        # Spark's widerDecimalType: every integral and fractional digit
        # of both; past MAX_PRECISION there is no lossless common type
        # (no 128-bit unscaled values here)
        scale = max(a.scale, b.scale)
        integral = max(a.precision - a.scale, b.precision - b.scale)
        if integral + scale > DecimalType.MAX_PRECISION:
            return None
        return DecimalType(integral + scale, scale)
    if ta is DecimalType or tb is DecimalType:
        dec, other = (a, b) if ta is DecimalType else (b, a)
        if type(other) in (FloatType, DoubleType):
            return DOUBLE  # Spark: decimal with a fractional -> double
        digits = INTEGRAL_DECIMAL_DIGITS.get(type(other))
        if digits is None:
            return None
        integral = max(dec.precision - dec.scale, digits)
        if integral + dec.scale > DecimalType.MAX_PRECISION:
            return None  # LONG needs 19 integral digits
        return DecimalType(integral + dec.scale, dec.scale)
    if {ta, tb} == {DateType, TimestampType}:
        return TIMESTAMP  # the date side at midnight UTC
    return None


def decimal_beside_integral(a: DataType, b: DataType) -> bool:
    """A DECIMAL and an integral type with no common DECIMAL of at most
    18 digits (a LONG beside any scale): they compare exactly all the
    same (Spark widens both to a DECIMAL of up to 38 digits)."""
    return common_type(a, b) is None and any(
        isinstance(x, DecimalType) and isinstance(y, IntegralType)
        for x, y in ((a, b), (b, a)))
