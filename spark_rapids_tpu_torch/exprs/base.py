"""Expression tree base classes.

Counterpart of ``spark_rapids_tpu/exprs/base.py``.  ``eval`` runs
eagerly on the batch's tensors and returns a Column/StringColumn of the
batch's row count; SQL NULLs travel in the validity tensor.  Batches
hold live rows only, so there is no row mask to apply.

``EvalContext`` carries the partition context the partition-aware
expressions read (``exprs/nondeterministic.py``): the partition the exec
runs (``partition_index``) and the rows of that partition it evaluated
before this batch (``row_offset``), both 0 where that context means
nothing (sort, join and aggregate keys, where the planner forbids those
expressions).  The JAX package sets them in a thread-local while it
traces a fused pipeline; here the exec passes them.

ANSI mode (``spark.rapids.tpu.sql.ansi.enabled``): an expression whose
result would overflow or is invalid reports a per-row flag
(``ansi_report``) while a capture is open (``ansi_capture``), and the
exec that opened it polls the batch's flags once (``poll_ansi``: one
``.item()`` sync a batch), raising ``AnsiError`` with the JAX message.
The Project, Filter, Expand and Generate execs open a capture only when
the key is on, so with it off no expression reports and no exec syncs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime as _dt
import decimal
import threading
from typing import Any, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import (
    AnyColumn,
    Column,
    StringColumn,
)


_EPOCH_UTC = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


@dataclasses.dataclass
class EvalContext:
    """The input batch an expression tree evaluates over, with its
    partition and the partition's rows before it."""

    batch: ColumnarBatch
    partition_index: int = 0
    row_offset: int = 0

    @staticmethod
    def for_batch(batch: ColumnarBatch, partition_index: int = 0,
                  row_offset: int = 0) -> "EvalContext":
        return EvalContext(batch, partition_index, row_offset)


# ---------------------------------------------------------------------- #
# ANSI mode
# ---------------------------------------------------------------------- #


class AnsiError(RuntimeError):
    """org.apache.spark.SparkArithmeticException analog."""


def ansi_enabled(conf) -> bool:
    """Whether ``conf`` (a session's ``TorchConf``) turns ANSI mode on."""
    from spark_rapids_tpu_torch.config import ANSI_ENABLED

    return bool(conf.get(ANSI_ENABLED))


_ANSI_CAPTURE = threading.local()
_ANSI_MESSAGES: dict[int, str] = {}
_ANSI_CODES: dict[str, int] = {}
_ansi_lock = threading.Lock()
#: device syncs ANSI polling has made, process-wide (``ansi_polls``)
_POLLS = [0]


def ansi_code(message: str) -> int:
    """A stable small int code for an error message."""
    with _ansi_lock:
        code = _ANSI_CODES.get(message)
        if code is None:
            code = _ANSI_CODES[message] = len(_ANSI_CODES) + 1
            _ANSI_MESSAGES[code] = message
        return code


@contextlib.contextmanager
def ansi_capture():
    """Scope an ANSI flag accumulator around one batch's evaluation;
    yields the list ``ansi_report`` appends (code, any-flag) pairs to."""
    flags: list = []
    prev = getattr(_ANSI_CAPTURE, "v", None)
    _ANSI_CAPTURE.v = flags
    try:
        yield flags
    finally:
        _ANSI_CAPTURE.v = prev


def ansi_active() -> bool:
    """True while a capture is open (execs open one only with ANSI mode
    on, so expressions check this, not the conf)."""
    return getattr(_ANSI_CAPTURE, "v", None) is not None


def ansi_report(flag: torch.Tensor, message: str) -> None:
    """Record a per-row error condition: its ``any()`` stays a device
    bool until the exec polls."""
    cap = getattr(_ANSI_CAPTURE, "v", None)
    if cap is not None:
        cap.append((ansi_code(message), flag.any()))


def poll_ansi(flags: list) -> None:
    """The captured flags folded into one error code on the device and
    read back with one sync (none when nothing reported); raises
    ``AnsiError`` for a nonzero code."""
    if not flags:
        return
    codes = torch.stack([torch.where(f, code, 0) for code, f in flags])
    with _ansi_lock:
        _POLLS[0] += 1
    raise_if_ansi_error(int(codes.max().item()))


def ansi_polls() -> int:
    """Device syncs ``poll_ansi`` has made in this process."""
    return _POLLS[0]


def raise_if_ansi_error(err: int) -> None:
    code = int(err)
    if code:
        raise AnsiError(
            _ANSI_MESSAGES.get(code, f"ANSI error {code}")
            + ". If necessary set spark.rapids.tpu.sql.ansi.enabled "
            "to false to bypass this error.")


def evaluate(exprs, ctx: EvalContext, ansi: bool) -> list:
    """Each expression over ``ctx``; with ``ansi`` under one capture,
    polled once after the last."""
    if not ansi:
        return [e.eval(ctx) for e in exprs]
    with ansi_capture() as flags:
        out = [e.eval(ctx) for e in exprs]
    poll_ansi(flags)
    return out


class Expression:
    """Base expression.  Subclasses define ``dtype``, ``nullable`` and
    ``eval``; ``children`` derive from dataclass fields holding
    Expressions, in field order."""

    @property
    def children(self) -> tuple["Expression", ...]:
        if not dataclasses.is_dataclass(self):
            return ()
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self)
                     if isinstance(getattr(self, f.name), Expression))

    @property
    def dtype(self) -> T.DataType:
        raise NotImplementedError(type(self).__name__)

    @property
    def nullable(self) -> bool:
        return True

    def eval(self, ctx: EvalContext) -> AnyColumn:
        raise NotImplementedError(type(self).__name__)

    def with_children(self, children: Sequence["Expression"]) -> "Expression":
        children = list(children)
        if not children:
            return self
        updates: dict[str, Any] = {}
        i = 0
        for f in dataclasses.fields(self):
            if isinstance(getattr(self, f.name), Expression):
                updates[f.name] = children[i]
                i += 1
        assert i == len(children), f"arity mismatch in {type(self).__name__}"
        return dataclasses.replace(self, **updates)

    def transform_up(self, fn) -> "Expression":
        node = self
        if self.children:
            node = self.with_children(
                [c.transform_up(fn) for c in self.children])
        return fn(node)

    def references(self) -> set[str]:
        """Names of the columns this tree reads."""
        out: set[str] = set()
        for c in self.children:
            out |= c.references()
        return out

    @property
    def name(self) -> str:
        return type(self).__name__

    def __repr__(self) -> str:
        if self.children:
            return f"{self.name}({', '.join(map(repr, self.children))})"
        return self.name

    # the DataFrame column DSL
    def __add__(self, other):
        from spark_rapids_tpu_torch.exprs.arithmetic import Add

        return Add(_expr(self), _expr(other))

    def __sub__(self, other):
        from spark_rapids_tpu_torch.exprs.arithmetic import Subtract

        return Subtract(_expr(self), _expr(other))

    def __mul__(self, other):
        from spark_rapids_tpu_torch.exprs.arithmetic import Multiply

        return Multiply(_expr(self), _expr(other))

    def __truediv__(self, other):
        from spark_rapids_tpu_torch.exprs.arithmetic import Divide

        return Divide(_expr(self), _expr(other))

    def __and__(self, other):
        from spark_rapids_tpu_torch.exprs.predicates import And

        return And(_expr(self), _expr(other))

    def __or__(self, other):
        from spark_rapids_tpu_torch.exprs.predicates import Or

        return Or(_expr(self), _expr(other))

    def __invert__(self):
        from spark_rapids_tpu_torch.exprs.predicates import Not

        return Not(_expr(self))

    def __lt__(self, other):
        from spark_rapids_tpu_torch.exprs.predicates import LessThan

        return LessThan(_expr(self), _expr(other))

    def __le__(self, other):
        from spark_rapids_tpu_torch.exprs.predicates import LessThanOrEqual

        return LessThanOrEqual(_expr(self), _expr(other))

    def __gt__(self, other):
        from spark_rapids_tpu_torch.exprs.predicates import GreaterThan

        return GreaterThan(_expr(self), _expr(other))

    def __ge__(self, other):
        from spark_rapids_tpu_torch.exprs.predicates import (
            GreaterThanOrEqual,
        )

        return GreaterThanOrEqual(_expr(self), _expr(other))

    def eq(self, other):
        from spark_rapids_tpu_torch.exprs.predicates import EqualTo

        return EqualTo(_expr(self), _expr(other))

    def ne(self, other):
        from spark_rapids_tpu_torch.exprs.predicates import EqualTo, Not

        return Not(EqualTo(_expr(self), _expr(other)))

    def get_field(self, name: str):
        """A struct's field: ``col("s").get_field("x")``."""
        from spark_rapids_tpu_torch.exprs.complex import GetStructField

        return GetStructField(self, name)

    def element_at(self, key):
        """element_at(array, 1-based index) or element_at(map, key)."""
        from spark_rapids_tpu_torch.exprs.complex import ElementAt

        return ElementAt(self, _expr(key))

    def get_map_value(self, key):
        from spark_rapids_tpu_torch.exprs.complex import GetMapValue

        return GetMapValue(self, _expr(key))

    def is_null(self):
        from spark_rapids_tpu_torch.exprs.predicates import IsNull

        return IsNull(self)

    def is_not_null(self):
        from spark_rapids_tpu_torch.exprs.predicates import IsNotNull

        return IsNotNull(self)

    def alias(self, name: str) -> "Alias":
        return Alias(self, name)


def _expr(v) -> Expression:
    return v if isinstance(v, Expression) else Literal.of(v)


def _column(v) -> Expression:
    """A column name as a reference, anything else as an expression."""
    return ColumnReference(v) if isinstance(v, str) else _expr(v)


def lit(v) -> "Literal":
    return Literal.of(v)


def col(name: str) -> "ColumnReference":
    return ColumnReference(name)


@dataclasses.dataclass(repr=False)
class ColumnReference(Expression):
    """Unresolved reference by name; ``bind_references`` resolves it."""

    col_name: str

    @property
    def dtype(self) -> T.DataType:
        raise RuntimeError(f"unresolved reference {self.col_name}")

    @property
    def name(self) -> str:
        return self.col_name

    def references(self) -> set[str]:
        return {self.col_name}

    def eval(self, ctx: EvalContext) -> AnyColumn:
        raise RuntimeError(
            f"unbound reference {self.col_name}; bind_references first")


@dataclasses.dataclass(repr=False)
class BoundReference(Expression):
    """Reference bound to an input-batch ordinal."""

    ordinal: int
    _dtype: T.DataType = dataclasses.field(default_factory=lambda: T.LONG)
    _nullable: bool = True
    col_name: str = ""

    @property
    def dtype(self) -> T.DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self._nullable

    @property
    def name(self) -> str:
        return self.col_name or f"input[{self.ordinal}]"

    def references(self) -> set[str]:
        return {self.col_name} if self.col_name else set()

    def eval(self, ctx: EvalContext) -> AnyColumn:
        return ctx.batch.columns[self.ordinal]


@dataclasses.dataclass(repr=False)
class Literal(Expression):
    """A scalar literal, broadcast to the batch's rows at eval."""

    value: Any
    _dtype: T.DataType = dataclasses.field(default_factory=lambda: T.LONG)

    @property
    def dtype(self) -> T.DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self.value is None

    @property
    def name(self) -> str:
        return repr(self.value)

    @staticmethod
    def of(v, dtype: Optional[T.DataType] = None) -> "Literal":
        if dtype is None:
            if v is None:
                dtype = T.NULL
            elif isinstance(v, bool):
                dtype = T.BOOLEAN
            elif isinstance(v, int):
                dtype = T.LONG
            elif isinstance(v, float):
                dtype = T.DOUBLE
            elif isinstance(v, str):
                dtype = T.STRING
            else:
                raise TypeError(f"cannot infer literal type of {v!r}")
        return Literal(v, dtype)

    def eval(self, ctx: EvalContext) -> AnyColumn:
        n, dev = ctx.batch.num_rows, ctx.batch.device
        valid = torch.full((n,), self.value is not None, dtype=torch.bool,
                           device=dev)
        if isinstance(self._dtype, T.StringType):
            b = (self.value or "").encode("utf-8")
            row = torch.tensor(list(b.ljust(max(len(b), 1), b"\0")),
                               dtype=torch.uint8, device=dev)
            return StringColumn(row.expand(n, -1).contiguous(),
                                torch.full((n,), len(b), dtype=torch.int32,
                                           device=dev), valid)
        v = physical_value(self.value, self._dtype)
        return Column(torch.full((n,), v, dtype=T.to_torch_dtype(self._dtype),
                                 device=dev), valid, self._dtype)


def physical_value(v, dtype: T.DataType):
    """A literal's value as its type's physical scalar: 0 for NULL, a
    DECIMAL's unscaled integer, a TIMESTAMP's microseconds since the
    epoch (a ``datetime`` without a zone is UTC), a DATE's day number."""
    if v is None:
        return 0
    if isinstance(dtype, T.DecimalType):
        return int(decimal.Decimal(v).scaleb(dtype.scale)
                    .to_integral_value(decimal.ROUND_HALF_UP))
    if isinstance(dtype, T.TimestampType) and isinstance(v, _dt.datetime):
        if v.tzinfo is None:
            v = v.replace(tzinfo=_dt.timezone.utc)
        d = v - _EPOCH_UTC
        return d.days * 86_400_000_000 + d.seconds * 1_000_000 \
            + d.microseconds
    if isinstance(dtype, T.DateType) and isinstance(v, _dt.date):
        return (v - _dt.date(1970, 1, 1)).days
    return v


@dataclasses.dataclass(repr=False)
class Alias(Expression):
    child: Expression
    out_name: str

    @property
    def dtype(self) -> T.DataType:
        return self.child.dtype

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    @property
    def name(self) -> str:
        return self.out_name

    def eval(self, ctx: EvalContext) -> AnyColumn:
        return self.child.eval(ctx)


def bind_references(expr: Expression, schema: T.Schema) -> Expression:
    """Resolve ColumnReferences against ``schema`` into BoundReferences."""

    def rewrite(e: Expression) -> Expression:
        if isinstance(e, ColumnReference):
            idx = schema.index_of(e.col_name)
            f = schema.fields[idx]
            return BoundReference(idx, f.dtype, f.nullable, f.name)
        return e

    return expr.transform_up(rewrite)


def output_field(e: Expression, i: int) -> T.Field:
    """The output field a projected expression produces."""
    if isinstance(e, Alias):
        name = e.out_name
    elif getattr(e, "col_name", ""):
        name = e.col_name
    else:
        name = f"col{i}"
    return T.Field(name, e.dtype, e.nullable)


def broadcast_validity(*cols: AnyColumn) -> torch.Tensor:
    v = cols[0].validity
    for c in cols[1:]:
        v = v & c.validity
    return v


def _field_key(v) -> str:
    """One dataclass field serialised; tuples recurse, so CaseWhen's
    branch pairs key by structure and not by a name-only repr."""
    if isinstance(v, Expression):
        return expr_key(v)
    if isinstance(v, tuple):
        return "(" + ",".join(_field_key(x) for x in v) + ")"
    return repr(v)


def expr_key(e) -> str:
    """A deterministic structural key of an expression tree: class names
    and every dataclass field (names, ordinals, types, literal values).
    Two trees with equal keys compute the same thing; the SQL frontend
    dedupes group keys and conjuncts by it.  A non-dataclass Expression
    would key by its class alone, whatever its state, so it raises
    TypeError; a value that is not an Expression keys by its repr."""
    if not isinstance(e, Expression):
        return repr(e)
    if dataclasses.is_dataclass(e):
        parts = [_field_key(getattr(e, f.name))
                 for f in dataclasses.fields(e)]
        return f"{type(e).__name__}[{','.join(parts)}]"
    raise TypeError(f"expression {type(e).__name__} is not a dataclass; "
                    "its state would not serialise into a key")
