"""Struct and map extractors and the struct constructor.

Counterpart of ``spark_rapids_tpu/exprs/complex.py``: ``GetStructField``
(the field's child column, its validity ANDed with the struct's),
``CreateNamedStruct``, ``GetMapValue`` and ``ElementAt`` (1-based, a
negative index counts from the end, index 0 an analysis error; a map
lookup takes the first entry whose key matches).  A map here is Arrow's
layout (``columnar/column.py``), so a lookup compares every entry's key
once and takes each row's first match with a ``scatter_reduce`` amin of
entry positions, where the JAX package compares a dense key matrix.
"""

from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import (
    Column,
    ListColumn,
    MapColumn,
    StructColumn,
)
from spark_rapids_tpu_torch.exprs.base import (
    EvalContext,
    Expression,
    Literal,
    physical_value,
)

#: element types the device lists and maps hold (fixed-width); any other
#: runs on the CPU engine
FIXED = (T.BooleanType, T.ByteType, T.ShortType, T.IntegerType,
         T.LongType, T.FloatType, T.DoubleType, T.DateType,
         T.TimestampType, T.DecimalType)


def row_ids(offsets: torch.Tensor) -> torch.Tensor:
    """The row of every element under ``offsets`` (from 0)."""
    n = int(offsets.shape[0]) - 1
    lens = (offsets[1:] - offsets[:-1]).to(torch.int64)
    return torch.repeat_interleave(
        torch.arange(n, device=offsets.device), lens,
        output_size=int(offsets[-1]) if n else 0)


def take_element(c: ListColumn | MapColumn, child: Column,
                 pos: torch.Tensor, ok: torch.Tensor,
                 dtype: T.DataType) -> Column:
    """Each row's element at ``pos`` (within the row) of ``child``,
    NULL where ``ok`` is False, the row is NULL, or the element is."""
    ok = ok & c.validity
    n_elems = len(child)
    if n_elems == 0:
        return Column(torch.zeros(len(c), dtype=T.to_torch_dtype(dtype),
                                  device=ok.device),
                      torch.zeros_like(ok), dtype)
    at = torch.where(ok, c.offsets[:-1].to(torch.int64) + pos, 0)
    data = child.data[at].to(T.to_torch_dtype(dtype))
    valid = ok & child.validity[at]
    return Column(torch.where(valid, data, torch.zeros_like(data)), valid,
                  dtype)


@dataclasses.dataclass(repr=False)
class GetStructField(Expression):
    """struct.field: the field's column, NULL where the struct is."""

    child: Expression
    field_name: str

    @property
    def dtype(self) -> T.DataType:
        dt = self.child.dtype
        if isinstance(dt, T.StructType):
            try:
                return dt.fields[dt.field_index(self.field_name)].dtype
            except KeyError:
                return T.NULL
        return T.NULL

    @property
    def name(self) -> str:
        return f"{self.child.name}.{self.field_name}"

    def check_supported(self) -> None:
        dt = self.child.dtype
        if not isinstance(dt, T.StructType):
            raise TypeError("getField requires a struct input")
        dt.field_index(self.field_name)  # KeyError when absent

    def eval(self, ctx: EvalContext):
        sc = self.child.eval(ctx)
        assert isinstance(sc, StructColumn), type(sc).__name__
        c = sc.children[self.child.dtype.field_index(self.field_name)]
        return c.with_validity(c.validity & sc.validity)


@dataclasses.dataclass(repr=False)
class CreateNamedStruct(Expression):
    """named_struct(n1, v1, ...): a struct of the evaluated values,
    never NULL itself."""

    names: tuple
    values: tuple  # of Expression

    @property
    def dtype(self) -> T.DataType:
        return T.StructType([T.Field(n, v.dtype, True)
                             for n, v in zip(self.names, self.values)])

    @property
    def name(self) -> str:
        inner = ", ".join(f"{n}: {v.name}"
                          for n, v in zip(self.names, self.values))
        return f"named_struct({inner})"

    @property
    def children(self) -> tuple:
        return tuple(self.values)

    def with_children(self, children):
        return CreateNamedStruct(self.names, tuple(children))

    def check_supported(self) -> None:
        if len(self.names) != len(self.values) or not self.values:
            raise TypeError("named_struct needs matching names/values")

    def eval(self, ctx: EvalContext) -> StructColumn:
        kids = tuple(v.eval(ctx) for v in self.values)
        b = ctx.batch
        return StructColumn(kids, torch.ones(b.num_rows, dtype=torch.bool,
                                             device=b.device), self.dtype)


def map_lookup(mc: MapColumn, key, value_dtype: T.DataType) -> Column:
    """Each row's value under ``key`` (its first entry with that key);
    NULL where the key is absent or the row is NULL."""
    n = len(mc)
    kd = mc.keys.data
    k = torch.tensor(physical_value(key, mc.dtype.key),
                     device=kd.device).to(kd.dtype)
    rows = row_ids(mc.offsets)
    entry = torch.arange(len(rows), device=kd.device)
    big = len(rows)
    cand = torch.where(kd == k, entry, big)
    first = torch.full((n,), big, dtype=torch.int64, device=kd.device)
    first.scatter_reduce_(0, rows, cand, "amin")
    found = first < big
    pos = first - mc.offsets[:-1].to(torch.int64)
    return take_element(mc, mc.values, pos, found, value_dtype)


def _check_map_device(dt: T.MapType) -> None:
    if not isinstance(dt.key, FIXED) or not isinstance(dt.value, FIXED):
        raise TypeError(
            f"map {dt.name} has non-fixed-width key/value (device "
            "lookup supports primitives; CPU fallback handles the rest)")


@dataclasses.dataclass(repr=False)
class GetMapValue(Expression):
    """map[key] with a literal key."""

    child: Expression
    key: Expression  # Literal

    @property
    def dtype(self) -> T.DataType:
        dt = self.child.dtype
        return dt.value if isinstance(dt, T.MapType) else T.NULL

    @property
    def name(self) -> str:
        return f"{self.child.name}[{self.key.name}]"

    def check_supported(self) -> None:
        dt = self.child.dtype
        if not isinstance(dt, T.MapType):
            raise TypeError("getMapValue requires a map input")
        if not isinstance(self.key, Literal) or self.key.value is None:
            raise TypeError("getMapValue key must be a non-null literal")
        _check_map_device(dt)

    def eval(self, ctx: EvalContext) -> Column:
        mc = self.child.eval(ctx)
        assert isinstance(mc, MapColumn), type(mc).__name__
        return map_lookup(mc, self.key.value, self.dtype)


@dataclasses.dataclass(repr=False)
class ElementAt(Expression):
    """element_at(array, i) (1-based, negative from the end; out of
    bounds is NULL, index 0 an analysis error, as Spark's non-ANSI
    mode) or element_at(map, key)."""

    child: Expression
    index: Expression  # Literal

    @property
    def dtype(self) -> T.DataType:
        dt = self.child.dtype
        if isinstance(dt, T.ListType):
            return dt.element
        if isinstance(dt, T.MapType):
            return dt.value
        return T.NULL

    @property
    def name(self) -> str:
        return f"element_at({self.child.name}, {self.index.name})"

    def check_supported(self) -> None:
        dt = self.child.dtype
        if not isinstance(dt, (T.ListType, T.MapType)):
            raise TypeError("element_at requires an array or map input")
        if not isinstance(self.index, Literal) or self.index.value is None:
            raise TypeError("element_at index must be a non-null literal")
        if isinstance(dt, T.ListType):
            if int(self.index.value) == 0:
                raise ValueError("SQL array indices start at 1")
        else:
            _check_map_device(dt)

    def eval(self, ctx: EvalContext) -> Column:
        c = self.child.eval(ctx)
        if isinstance(c, MapColumn):
            return map_lookup(c, self.index.value, self.dtype)
        assert isinstance(c, ListColumn), type(c).__name__
        k = int(self.index.value)
        lens = c.lengths().to(torch.int64)
        pos = torch.full_like(lens, k - 1) if k > 0 else lens + k
        return take_element(c, c.child, pos, (pos >= 0) & (pos < lens),
                            self.dtype)
