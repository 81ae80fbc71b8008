"""Declarative type-support signatures driving plan tagging.

Counterpart of ``spark_rapids_tpu/plan/typesig.py``, with its kinds,
their order and its sets: ``ORDERABLE`` (what sorts, compares and
groups), ``ALL`` (that and arrays) and ``NESTED``.  Every
expression and aggregate rule of the planner declares the input types
its device version handles; tagging checks the declarations, not the
operator code, and turns each unsupported child type into a
will-not-work reason, so the node runs on the CPU engine with an
explanation instead of raising.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from spark_rapids_tpu_torch import types as T

_KIND_OF = {
    T.BooleanType: "boolean",
    T.ByteType: "byte",
    T.ShortType: "short",
    T.IntegerType: "int",
    T.LongType: "long",
    T.FloatType: "float",
    T.DoubleType: "double",
    T.StringType: "string",
    T.DateType: "date",
    T.TimestampType: "timestamp",
    T.DecimalType: "decimal",
    T.NullType: "null",
    T.ListType: "array",
    T.StructType: "struct",
    T.MapType: "map",
}

KIND_ORDER = ["boolean", "byte", "short", "int", "long", "float",
              "double", "decimal", "string", "date", "timestamp",
              "null", "array", "struct", "map"]


def kind_of(dtype: T.DataType) -> str:
    return _KIND_OF[type(dtype)]


@dataclasses.dataclass(frozen=True)
class TypeSig:
    kinds: frozenset

    def supports(self, dtype: T.DataType) -> bool:
        return kind_of(dtype) in self.kinds

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self.kinds | other.kinds)

    def describe(self) -> str:
        return ", ".join(k for k in KIND_ORDER if k in self.kinds)

    @staticmethod
    def of(*kinds: str) -> "TypeSig":
        unknown = set(kinds) - set(KIND_ORDER)
        assert not unknown, f"unknown type kinds {unknown}"
        return TypeSig(frozenset(kinds))


BOOLEAN = TypeSig.of("boolean")
INTEGRAL = TypeSig.of("byte", "short", "int", "long")
NUMERIC = INTEGRAL + TypeSig.of("float", "double")
STRING = TypeSig.of("string")
DATETIME = TypeSig.of("date", "timestamp")
DECIMAL = TypeSig.of("decimal")
NULLSIG = TypeSig.of("null")
ARRAY = TypeSig.of("array")
STRUCT = TypeSig.of("struct")
MAP = TypeSig.of("map")
NESTED = ARRAY + STRUCT + MAP
#: what the columnar kernels handle alike (the reference's
#: commonCudfTypes)
COMMON = NUMERIC + BOOLEAN + STRING + DATETIME
#: what sorts, compares and groups
ORDERABLE = COMMON + DECIMAL + NULLSIG
#: what passes through an expression untouched (the JAX set: arrays,
#: not structs or maps)
ALL = ORDERABLE + ARRAY


@dataclasses.dataclass(frozen=True)
class ExprSig:
    """Input signature of one expression rule: the types its children
    may produce for the device version to run."""

    inputs: TypeSig
    note: str = ""


def check_inputs(expr, sig: Optional[ExprSig], reasons: set) -> None:
    """Add a reason for each child whose type ``sig`` does not accept."""
    if sig is None:
        return
    for c in expr.children:
        try:
            dt = c.dtype
        except Exception:
            continue  # unresolved: binding errors surface elsewhere
        if not sig.inputs.supports(dt):
            reasons.add(
                f"expression {type(expr).__name__} does not support "
                f"input type {dt.name} on the GPU "
                f"(supported: {sig.inputs.describe()})")
