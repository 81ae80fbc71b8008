"""Array expressions.

Counterpart of ``spark_rapids_tpu/exprs/collections.py``: ``Size``,
``GetArrayItem``, ``ArrayContains``, ``Explode`` (the generator marker
the session extracts into a ``Generate`` node) and ``CreateArray``.
The JAX package computes each over a dense ``(rows, max_len)`` element
matrix; here an array is Arrow's offsets and flat child
(``columnar/column.py``), so an element read is a gather at
``offsets[row] + i`` and a per-row test an ``index_add_`` over the
elements' row ids.

``size`` of a NULL array is NULL, as in the JAX package; Spark 3.x's
default (``spark.sql.legacy.sizeOfNull``) gives -1.
"""

from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import Column, ListColumn
from spark_rapids_tpu_torch.exprs.base import (
    EvalContext,
    Expression,
    Literal,
    physical_value,
)
from spark_rapids_tpu_torch.exprs.complex import row_ids, take_element


def _as_list(col) -> ListColumn:
    assert isinstance(col, ListColumn), \
        f"collection op over non-list column {type(col).__name__}"
    return col


@dataclasses.dataclass(repr=False)
class Size(Expression):
    """size(array): its element count, NULL for a NULL array."""

    child: Expression

    @property
    def dtype(self) -> T.DataType:
        return T.INT

    @property
    def name(self) -> str:
        return f"size({self.child.name})"

    def check_supported(self) -> None:
        if not isinstance(self.child.dtype, T.ListType):
            raise TypeError(f"size() requires an array, got "
                            f"{self.child.dtype.name}")

    def eval(self, ctx: EvalContext) -> Column:
        c = _as_list(self.child.eval(ctx))
        return Column(c.lengths(), c.validity, T.INT)


@dataclasses.dataclass(repr=False)
class GetArrayItem(Expression):
    """array[i] with a literal 0-based index: NULL out of bounds or
    where the element is NULL."""

    child: Expression
    index: Expression  # Literal int

    @property
    def dtype(self) -> T.DataType:
        dt = self.child.dtype
        # a non-list child keeps the schema derivable, so the tags can
        # give check_supported's reason
        return dt.element if isinstance(dt, T.ListType) else T.NULL

    @property
    def name(self) -> str:
        return f"{self.child.name}[{self.index.name}]"

    def check_supported(self) -> None:
        if not isinstance(self.child.dtype, T.ListType):
            raise TypeError("getItem requires an array input")
        if not isinstance(self.index, Literal):
            raise TypeError("getItem index must be a literal")

    def eval(self, ctx: EvalContext) -> Column:
        c = _as_list(self.child.eval(ctx))
        k = int(self.index.value)
        lens = c.lengths().to(torch.int64)
        pos = torch.full_like(lens, k)
        return take_element(c, c.child, pos, (pos >= 0) & (pos < lens),
                            self.dtype)


@dataclasses.dataclass(repr=False)
class ArrayContains(Expression):
    """array_contains(arr, literal), Spark's NULL semantics: true when
    found; else NULL when the array holds a NULL; else false."""

    child: Expression
    value: Expression  # Literal

    @property
    def dtype(self) -> T.DataType:
        return T.BOOLEAN

    @property
    def name(self) -> str:
        return f"array_contains({self.child.name}, {self.value.name})"

    def check_supported(self) -> None:
        if not isinstance(self.child.dtype, T.ListType):
            raise TypeError("array_contains requires an array input")
        if not isinstance(self.value, Literal) or self.value.value is None:
            raise TypeError("array_contains value must be a non-null "
                            "literal")

    def eval(self, ctx: EvalContext) -> Column:
        c = _as_list(self.child.eval(ctx))
        e = c.child
        v = torch.tensor(physical_value(self.value.value, c.dtype.element),
                         device=e.data.device).to(e.data.dtype)
        rows = row_ids(c.offsets)
        n = len(c)
        hits = torch.zeros(n, dtype=torch.int32, device=e.data.device)
        hits.index_add_(0, rows, (e.validity & (e.data == v)).to(torch.int32))
        nulls = torch.zeros_like(hits)
        nulls.index_add_(0, rows, (~e.validity).to(torch.int32))
        found = hits > 0
        return Column(found & c.validity,
                      c.validity & (found | (nulls == 0)), T.BOOLEAN)


@dataclasses.dataclass(repr=False)
class Explode(Expression):
    """Generator marker: one output row per array element.  It never
    evaluates inline: the session extracts it into a ``Generate`` node;
    ``outer`` keeps a NULL-element row for an empty or NULL array
    (explode_outer), ``pos`` adds the element's position."""

    child: Expression
    pos: bool = False
    outer: bool = False

    @property
    def dtype(self) -> T.DataType:
        dt = self.child.dtype
        return dt.element if isinstance(dt, T.ListType) else T.NULL

    @property
    def name(self) -> str:
        base = "posexplode" if self.pos else "explode"
        return f"{base}{'_outer' if self.outer else ''}({self.child.name})"

    def check_supported(self) -> None:
        if not isinstance(self.child.dtype, T.ListType):
            raise TypeError(f"{self.name} requires an array input")

    def eval(self, ctx: EvalContext):
        raise TypeError("explode must appear at the top level of a "
                        "select list")


@dataclasses.dataclass(repr=False, init=False)
class CreateArray(Expression):
    """array(e1, e2, ...): a never-NULL array of the values per row, of
    their widened type."""

    exprs: tuple

    def __init__(self, *exprs: Expression):
        if not exprs:
            raise TypeError("array() needs at least one element "
                            "(empty arrays are not supported)")
        self.exprs = tuple(exprs)

    @property
    def children(self) -> tuple:
        return self.exprs

    def with_children(self, children):
        return type(self)(*children)

    @property
    def dtype(self) -> T.DataType:
        from spark_rapids_tpu_torch.exprs.predicates import _widen

        return T.ListType(_widen([e.dtype for e in self.exprs]))

    @property
    def nullable(self) -> bool:
        return False

    @property
    def name(self) -> str:
        return f"array({', '.join(e.name for e in self.exprs)})"

    def check_supported(self) -> None:
        for e in self.exprs:
            if isinstance(e.dtype, (T.StringType, T.ListType)):
                raise TypeError(
                    "array() of string/nested elements is not supported")

    def eval(self, ctx: EvalContext) -> ListColumn:
        elem = self.dtype.element
        phys = T.to_torch_dtype(elem)
        cols = [e.eval(ctx) for e in self.exprs]
        b = ctx.batch
        m = len(cols)
        data = torch.stack([c.data.to(phys) for c in cols], 1).reshape(-1)
        valid = torch.stack([c.validity for c in cols], 1).reshape(-1)
        offsets = torch.arange(0, b.num_rows * m + 1, m, dtype=torch.int32,
                               device=b.device)
        return ListColumn(offsets, Column(data, valid, elem),
                          torch.ones(b.num_rows, dtype=torch.bool,
                                     device=b.device), T.ListType(elem))
