"""The CPU engine: a pyarrow executor for the port's logical plans.

Counterpart of ``spark_rapids_tpu/cpu/engine.py``.  It runs the
subtrees the planner tags off the GPU (``plan/planner.py``'s
``CpuFallbackExec``) and serves as the independent reference the card's
results are held against.  So it is deliberately an *independent
implementation* of the SQL semantics, on pyarrow compute kernels and
numpy for the gaps: it uses no torch, and nothing of the port's
``ops/``, ``execs/`` or ``columnar/``; it reads the expression and plan
classes only to dispatch on them.  Where Spark's semantics differ from
pyarrow's defaults, Spark's are implemented here explicitly:

- Kleene logic for AND / OR, NULL for a zero divisor;
- NaN is the greatest double and equal to itself in comparisons,
  <=>, IN, sorts and min / max; -0.0 equals 0.0 in IN and as a group
  key;
- IN is NULL when nothing matches and the list holds a NULL;
- IF / CASE take the else branch on a NULL predicate;
- greatest() and least() skip NULLs;
- a residual condition on an outer, semi or anti join decides which
  pairs match, and unmatched rows are kept or dropped after it;
- decimal arithmetic, casts and precision checks run on the unscaled
  integers, exactly (NULL past the precision); a timestamp of any unit
  or zone counts microseconds since the epoch, UTC;
- arrays, structs and maps: a NULL array's elements are not part of it;
  size(NULL) is NULL (the JAX package's choice; Spark's default is -1);
  array_contains is NULL when the value is absent and the array holds a
  NULL; a map lookup takes the first entry with the key; explode_outer
  keeps a NULL row (and a NULL pos) for an empty or NULL array;
  collect_list / collect_set skip NULLs, keep input order, and a set
  keeps the first of equal values (NaN equals NaN, -0.0 equals 0.0);
  an all-NULL group or an empty grand collect gives an empty array;
- the string long tail as Python's ``str`` (JAX's oracle definitions):
  Java's non-overlapping ``replace``, ``regexp_replace`` and ``split``
  by Python's ``re`` (``_java_split`` keeps Java's split rules; Java and
  Python regexes differ on some syntax, ``$`` before a final newline
  among it), pads and ``locate`` in characters, ``get_json_object`` by
  ``json``; ``md5`` by ``hashlib``; shifts by Java's rules;
- ``spark_partition_id()`` is 0, ``monotonically_increasing_id()`` the
  row's index and ``rand(seed)`` is drawn with partition 0 for every
  row, as the JAX CPU engine does (it runs a node as one partition);
  the input-file expressions give Spark's no-file defaults, except over
  a scan carrying the hidden input-file columns;
- with ANSI on (``execute_cpu(plan, ansi=True)``) integral overflow in
  + - *, a zero divisor, a malformed STRING cast to an integral type and
  an out-of-range cast to one raise ``AnsiError`` with the JAX messages.

- ``Cached`` keeps its own table in the slot (``cpu_table``), made
  once; ``MapInArrow``, ``GroupedPandas`` and ``CoGroupedPandas`` run
  the workers' wrappers (``python_worker/wrappers.py``) in-process over
  whole tables; an opaque UDF runs row by row with NULLs as ``None``, a
  torch UDF on CPU tensors of its inputs' values (made by the UDF's own
  ``TorchScalarUDF.eval_numpy``: this module imports no torch).

``execute_cpu(plan)`` runs every logical node of ``plan/logical.py``;
``cpu_eval(e, table)`` evaluates every expression class of ``exprs/``
over a table whose columns are the expression's input schema.
"""

from __future__ import annotations

import calendar
import datetime as _dt
import decimal as _decimal
import hashlib
import json
import os
import re
import threading
from typing import Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs import aggregates as AG
from spark_rapids_tpu_torch.exprs import arithmetic as A
from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs import bitwise as BW
from spark_rapids_tpu_torch.exprs import collections as COLL
from spark_rapids_tpu_torch.exprs import complex as CX
from spark_rapids_tpu_torch.exprs import datetime as DT
from spark_rapids_tpu_torch.exprs import decimal as DEC
from spark_rapids_tpu_torch.exprs import math as M
from spark_rapids_tpu_torch.exprs import nondeterministic as ND
from spark_rapids_tpu_torch.exprs import predicates as P
from spark_rapids_tpu_torch.exprs import strings as S
from spark_rapids_tpu_torch.exprs import window as WX
from spark_rapids_tpu_torch.exprs.base import bind_references
from spark_rapids_tpu_torch.exprs.cast import Cast, cast_supported
from spark_rapids_tpu_torch.exprs.hashing import Md5, Murmur3Hash
from spark_rapids_tpu_torch.exprs.subquery import ScalarSubquery
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.udf.exprs import OpaquePythonUDF, TorchScalarUDF

_PC_UNARY = {
    M.Sqrt: pc.sqrt, M.Exp: pc.exp, M.Sin: pc.sin, M.Cos: pc.cos,
    M.Tan: pc.tan, M.Asin: pc.asin, M.Acos: pc.acos, M.Atan: pc.atan,
    M.Signum: pc.sign,
}
_NP_UNARY = {
    M.Cbrt: np.cbrt, M.Expm1: np.expm1, M.Sinh: np.sinh,
    M.Cosh: np.cosh, M.Tanh: np.tanh, M.Asinh: np.arcsinh,
    M.Acosh: np.arccosh, M.Atanh: np.arctanh, M.Rint: np.rint,
    M.ToDegrees: np.degrees, M.ToRadians: np.radians,
    M.Cot: lambda d: 1.0 / np.tan(d),
}
_EPOCH = _dt.date(1970, 1, 1)
#: Spark's trim for casts from STRING: ASCII control characters and space
_CAST_WS = "".join(chr(i) for i in range(33))


def arrow_schema(schema: T.Schema) -> pa.Schema:
    return pa.schema([pa.field(f.name, T.to_arrow_type(f.dtype))
                      for f in schema.fields])


# ---------------------------------------------------------------------- #
# Expression evaluation
# ---------------------------------------------------------------------- #


_MODE = threading.local()


def _ansi() -> bool:
    """Whether the ``execute_cpu`` running on this thread has ANSI on."""
    return getattr(_MODE, "ansi", False)


def _ansi_raise(message: str) -> None:
    B.raise_if_ansi_error(B.ansi_code(message))


def _ansi_div_check(zero_rows) -> None:
    """ANSI: a zero divisor in a row whose operands are both valid."""
    if _ansi() and bool(np.asarray(zero_rows).any()):
        _ansi_raise("Division by zero")


def cpu_eval(e: B.Expression, table: pa.Table) -> pa.Array:
    """``e`` over every row of ``table``, as one Arrow array."""
    out = _dispatch(e, table, table.num_rows)
    if isinstance(out, pa.ChunkedArray):
        out = out.combine_chunks()
    return out


def _atype(e: B.Expression) -> pa.DataType:
    return T.to_arrow_type(e.dtype)


def _plain(arr):
    """Dictionary-encoded columns decoded: the engine computes over
    plain arrays."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_dictionary(arr.type):
        return arr.cast(arr.type.value_type)
    return arr


def _column(table: pa.Table, i: int) -> pa.Array:
    if table.schema.field(i).metadata == _PRUNED:
        raise AssertionError(f"CPU engine: column {table.schema.field(i)}"
                             " was pruned and is read")
    return _plain(table.column(i))


def _typed(a: pa.Array, other: pa.Array) -> pa.Array:
    """An array of the NULL type cast to the other operand's type."""
    if pa.types.is_null(a.type) and not pa.types.is_null(other.type):
        return a.cast(other.type)
    return a


def _operands(e, table):
    l = cpu_eval(e.left, table)
    r = cpu_eval(e.right, table)
    return _typed(l, r), _typed(r, l)


def _np_vals(arr: pa.Array, atype) -> tuple[np.ndarray, np.ndarray]:
    """(values with NULL slots 0, validity) as numpy."""
    valid = np.asarray(arr.is_valid())
    if pa.types.is_null(arr.type):
        arr = arr.cast(atype)
    filled = arr.fill_null(0) if arr.null_count else arr
    return filled.cast(atype).to_numpy(zero_copy_only=False), valid


def _from_np(vals: np.ndarray, valid: np.ndarray, atype) -> pa.Array:
    mask = None if valid.all() else ~valid
    return pa.array(vals, type=atype, mask=mask)


def _nulls(n: int, atype) -> pa.Array:
    return pa.nulls(n, type=atype)


_US_PER_DAY = 86_400_000_000
_US_PER_UNIT = {"s": 1_000_000, "ms": 1_000, "us": 1}
_UTC_US = pa.timestamp("us", tz="UTC")


def _unscaled(a: pa.Array, scale: int) -> tuple[np.ndarray, np.ndarray]:
    """(int64 unscaled values at ``scale`` with NULL slots 0, validity)
    of a decimal array: decimal128's low word, a precision of at most
    18 digits."""
    a = _plain(a)
    if a.type != pa.decimal128(a.type.precision, scale) \
            or a.type.precision > 18:
        a = a.cast(pa.decimal128(18, scale))
    valid = np.asarray(a.is_valid())
    words = np.frombuffer(a.buffers()[1], np.int64, count=2 * len(a),
                          offset=a.offset * 16) if len(a) else \
        np.zeros(0, np.int64)
    return np.where(valid, words[0::2], 0), valid


def _from_unscaled(v: np.ndarray, ok: np.ndarray, dt) -> pa.Array:
    """A decimal128(p, s) array of int64 unscaled values."""
    v = np.where(ok, np.asarray(v, np.int64), 0)
    words = np.empty((len(v), 2), np.int64)
    words[:, 0] = v
    words[:, 1] = v >> 63
    bitmap = None if ok.all() else pa.py_buffer(
        np.packbits(ok, bitorder="little"))
    return pa.Array.from_buffers(T.to_arrow_type(dt), len(v),
                                 [bitmap, pa.py_buffer(words)])


def _micros(a: pa.Array) -> tuple[np.ndarray, np.ndarray]:
    """(int64 microseconds since the epoch, NULL slots 0; validity) of a
    timestamp array of any unit (ns floored)."""
    a = _plain(a)
    unit = a.type.unit
    v, ok = _np_vals(a.cast(pa.timestamp(unit)).cast(pa.int64()),
                     pa.int64())
    if unit == "ns":
        return np.floor_divide(v, 1000), ok
    return v * _US_PER_UNIT[unit], ok


def _from_micros(v: np.ndarray, ok: np.ndarray) -> pa.Array:
    return _from_np(np.asarray(v, np.int64), ok, pa.int64()).cast(_UTC_US)


def _as_engine_type(a: pa.Array, at: pa.DataType) -> pa.Array:
    """``a`` in the engine's Arrow type ``at``: a timestamp of another
    unit or zone to microseconds UTC, any other type by a cast."""
    if pa.types.is_timestamp(at) and pa.types.is_timestamp(a.type):
        return _from_micros(*_micros(a))
    return a.cast(at)


def _dispatch(e, table, n):  # noqa: C901 - a dispatcher is a big switch
    if isinstance(e, B.Alias):
        return cpu_eval(e.child, table)
    if isinstance(e, (TorchScalarUDF, OpaquePythonUDF)):
        return _python_udf(e, table, n)
    if isinstance(e, B.BoundReference):
        return _column(table, e.ordinal)
    if isinstance(e, B.ColumnReference):
        return _column(table, table.column_names.index(e.col_name))
    if isinstance(e, B.Literal):
        at = _atype(e)
        if e.value is None:
            return _nulls(n, at)
        if isinstance(e.dtype, T.DateType):
            day = B.physical_value(e.value, T.DATE)
            return pa.array(np.full(n, day, np.int32),
                            pa.int32()).cast(pa.date32())
        if isinstance(e.dtype, (T.DecimalType, T.TimestampType)):
            v = np.full(n, B.physical_value(e.value, e.dtype), np.int64)
            ok = np.ones(n, bool)
            return _from_unscaled(v, ok, e.dtype) if isinstance(
                e.dtype, T.DecimalType) else _from_micros(v, ok)
        return pa.array([e.value] * n, type=at)
    if isinstance(e, ScalarSubquery):
        sub = execute_cpu(e.plan)
        if sub.num_columns != 1 or sub.num_rows > 1:
            raise ValueError(f"scalar subquery must return one value, got "
                             f"{sub.num_rows}x{sub.num_columns}")
        v = sub.column(0)[0].as_py() if sub.num_rows else None
        return pa.array([v] * n, _atype(e))

    # arithmetic --------------------------------------------------------- #
    if isinstance(e, (A.Add, A.Subtract, A.Multiply)) \
            and isinstance(e.dtype, T.DecimalType):
        return _decimal_arith(e, table)
    if isinstance(e, (A.Add, A.Subtract, A.Multiply)):
        l, r = _operands(e, table)
        at = _atype(e)
        if _ansi() and pa.types.is_integer(at):
            fn = {A.Add: pc.add_checked, A.Subtract: pc.subtract_checked,
                  A.Multiply: pc.multiply_checked}[type(e)]
            try:
                return fn(l.cast(at), r.cast(at))
            except pa.ArrowInvalid:
                _ansi_raise("long overflow" if pa.types.is_int64(at)
                            else "integer overflow")
        fn = {A.Add: pc.add, A.Subtract: pc.subtract,
              A.Multiply: pc.multiply}[type(e)]
        return fn(l.cast(at), r.cast(at))  # integers wrap, as Java's
    if isinstance(e, A.Divide):
        l, r = _operands(e, table)
        l = l.cast(pa.float64())
        r = r.cast(pa.float64())
        zero = pc.fill_null(pc.equal(r, 0.0), False)
        _ansi_div_check(pc.and_(zero, pc.is_valid(l)))
        out = pc.divide(l, pc.if_else(zero, pa.scalar(1.0), r))
        return pc.if_else(zero, _nulls(n, pa.float64()), out)
    if isinstance(e, (A.IntegralDivide, A.Remainder, A.Pmod)):
        return _integral_div(e, table)
    if isinstance(e, A.UnaryMinus):
        return pc.negate(cpu_eval(e.child, table))
    if isinstance(e, A.UnaryPositive):
        return cpu_eval(e.child, table)
    if isinstance(e, A.Abs):
        return pc.abs(cpu_eval(e.child, table))
    if isinstance(e, A.Least):  # Greatest subclasses Least
        return _least_greatest(e, table)

    # predicates --------------------------------------------------------- #
    if isinstance(e, P.EqualNullSafe):
        l, r = _operands(e, table)
        eq = pc.fill_null(pc.equal(l, r), False)
        lnan, rnan = _nan_mask(l), _nan_mask(r)
        if lnan is not None and rnan is not None:
            eq = pc.or_(eq, pc.and_(lnan, rnan))  # NaN <=> NaN
        ln, rn = pc.is_null(l), pc.is_null(r)
        return pc.if_else(pc.xor(ln, rn), pa.scalar(False),
                          pc.or_(pc.and_(ln, rn), eq))
    if isinstance(e, P.BinaryComparison):
        return _compare(e, table, n)
    if isinstance(e, P.And):
        l, r = _operands(e, table)
        return pc.and_kleene(l.cast(pa.bool_()), r.cast(pa.bool_()))
    if isinstance(e, P.Or):
        l, r = _operands(e, table)
        return pc.or_kleene(l.cast(pa.bool_()), r.cast(pa.bool_()))
    if isinstance(e, P.Not):
        return pc.invert(cpu_eval(e.child, table).cast(pa.bool_()))
    if isinstance(e, P.IsNull):
        return pc.is_null(cpu_eval(e.child, table))
    if isinstance(e, P.IsNotNull):
        return pc.is_valid(cpu_eval(e.child, table))
    if isinstance(e, P.IsNaN):
        m = _nan_mask(cpu_eval(e.child, table))
        return pa.array(np.zeros(n, bool)) if m is None else m
    if isinstance(e, P.In):
        return _in(e, table, n)
    if isinstance(e, P.Coalesce):
        at = _atype(e)
        return pc.coalesce(*[cpu_eval(x, table).cast(at) for x in e.exprs])
    if isinstance(e, P.If):
        p = pc.fill_null(cpu_eval(e.pred, table).cast(pa.bool_()), False)
        at = _atype(e)
        return pc.if_else(p, cpu_eval(e.then, table).cast(at),
                          cpu_eval(e.otherwise, table).cast(at))
    if isinstance(e, P.CaseWhen):
        at = _atype(e)
        out = cpu_eval(e.else_value, table).cast(at)
        for cond, val in reversed(e.branches):
            p = pc.fill_null(cpu_eval(cond, table).cast(pa.bool_()), False)
            out = pc.if_else(p, cpu_eval(val, table).cast(at), out)
        return out
    if isinstance(e, P.AtLeastNNonNulls):
        count = np.zeros(n, np.int32)
        for x in e.exprs:
            a = cpu_eval(x, table)
            ok = np.asarray(a.is_valid())
            m = _nan_mask(a)
            if m is not None:
                ok = ok & ~np.asarray(m)
            count += ok.astype(np.int32)
        return pa.array(count >= e.n)

    if isinstance(e, _NESTED_EXPRS):
        return _dispatch_nested(e, table, n)
    if isinstance(e, Murmur3Hash):
        h = np.full(n, e.seed & 0xFFFFFFFF, np.uint32)
        with np.errstate(over="ignore"):
            for x in e.exprs:
                h = _np_hash_col(cpu_eval(x, table), h)
        return pa.array(h.view(np.int32))
    if isinstance(e, Cast):
        return _cast(e, table, n)
    if isinstance(e, Md5):
        return pa.array([None if v is None
                         else hashlib.md5(v.encode()).hexdigest()
                         for v in cpu_eval(e.child, table).to_pylist()],
                        pa.string())
    if isinstance(e, (BW.BitwiseBinary, BW.BitwiseNot, BW.ShiftLeft)):
        return _bitwise(e, table)
    if isinstance(e, ND.SparkPartitionID):  # one partition here
        return pa.array(np.zeros(n, np.int32))
    if isinstance(e, ND.MonotonicallyIncreasingID):
        return pa.array(np.arange(n, dtype=np.int64))
    if isinstance(e, ND.Rand):  # partition 0, as the JAX CPU engine
        return pa.array(ND.rand_uniform(e.seed, 0,
                                        np.arange(n, dtype=np.int64)))
    if isinstance(e, ND.InputFileName):  # no file context here
        return pa.array([e.DEFAULT] * n, _atype(e))
    if isinstance(e, (DEC.PromotePrecision, DEC.CheckOverflow,
                      DEC.UnscaledValue, DEC.MakeDecimal)):
        return _dispatch_decimal(e, table)

    out = _dispatch_math(e, table, n)
    if out is NotImplemented:
        out = _dispatch_datetime(e, table, n)
    if out is NotImplemented:
        out = _dispatch_strings(e, table, n)
    if out is NotImplemented:
        raise NotImplementedError(
            f"CPU engine: unsupported expression {type(e).__name__}")
    return out


_NESTED_EXPRS = (COLL.Size, COLL.GetArrayItem, COLL.ArrayContains,
                 COLL.CreateArray, COLL.Explode, CX.GetStructField,
                 CX.CreateNamedStruct, CX.GetMapValue, CX.ElementAt)


def _list_parts(arr) -> tuple[np.ndarray, np.ndarray, pa.Array]:
    """(row starts into the values, per-row lengths with 0 on NULL rows,
    the whole values child) of an array or map column."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    offsets = arr.offsets.to_numpy().astype(np.int64)
    valid = np.asarray(arr.is_valid())
    lens = np.where(valid, offsets[1:] - offsets[:-1], 0)
    return offsets[:-1], lens, arr


def _pick(values: pa.Array, at: np.ndarray, ok: np.ndarray,
          atype) -> pa.Array:
    """``values[at]`` where ``ok``, NULL elsewhere."""
    idx = pa.array(np.where(ok, at, 0), pa.int64(), mask=~ok)
    out = values.take(idx) if len(values) else _nulls(len(at), atype)
    return out.cast(atype) if out.type != atype else out


def _dispatch_nested(e, table, n):  # noqa: C901 - one branch a class
    if isinstance(e, COLL.Explode):
        raise TypeError("explode must appear at the top level of a "
                        "select list")
    if isinstance(e, CX.CreateNamedStruct):
        kids = [cpu_eval(v, table) for v in e.values]
        return pa.StructArray.from_arrays(kids, fields=list(
            arrow_schema(T.Schema(e.dtype.fields))))
    if isinstance(e, COLL.CreateArray):
        et = T.to_arrow_type(e.dtype.element)
        kids = [cpu_eval(x, table) for x in e.exprs]
        kids = [k.cast(et) if k.type != et else k for k in kids]
        m = len(kids)
        flat = pa.concat_arrays(kids).take(pa.array(
            (np.arange(m)[None, :] * n + np.arange(n)[:, None]).reshape(-1),
            pa.int64())) if n else pa.array([], et)
        return pa.ListArray.from_arrays(
            pa.array(np.arange(0, n * m + 1, m), pa.int32()), flat)
    c = cpu_eval(e.child, table)
    if isinstance(e, CX.GetStructField):
        field = c.field(e.child.dtype.field_index(e.field_name))
        if c.null_count:
            field = pc.if_else(pc.is_valid(c), field,
                               pa.scalar(None, field.type))
        return field
    starts, lens, arr = _list_parts(c)
    at = _atype(e)
    if isinstance(e, COLL.Size):
        return _from_np(lens.astype(np.int32), np.asarray(arr.is_valid()),
                        at)
    if isinstance(e.child.dtype, T.MapType):  # GetMapValue, ElementAt
        key = e.key.value if isinstance(e, CX.GetMapValue) \
            else e.index.value
        keys = arr.keys.to_numpy(zero_copy_only=False)
        hits = keys == B.physical_value(key, e.child.dtype.key)
        pos = np.full(len(lens), -1, np.int64)
        for i in np.nonzero(lens)[0]:
            row = np.nonzero(hits[starts[i]:starts[i] + lens[i]])[0]
            if len(row):
                pos[i] = row[0]  # the first entry with the key
        return _pick(arr.items, starts + pos, pos >= 0, at)
    if isinstance(e, COLL.ArrayContains):
        vals = arr.values
        v = B.physical_value(e.value.value, e.child.dtype.element)
        hit = np.zeros(len(vals), bool) if pa.types.is_null(vals.type) \
            else np.asarray(pc.fill_null(pc.equal(
                vals, pa.scalar(v, vals.type)), False))
        null = np.asarray(vals.is_null())
        found = np.zeros(len(lens), bool)
        has_null = np.zeros(len(lens), bool)
        for i in np.nonzero(lens)[0]:
            found[i] = hit[starts[i]:starts[i] + lens[i]].any()
            has_null[i] = null[starts[i]:starts[i] + lens[i]].any()
        valid = np.asarray(arr.is_valid()) & (found | ~has_null)
        return _from_np(found, valid, pa.bool_())
    if isinstance(e, CX.ElementAt):
        k = int(e.index.value)
        if k == 0:
            raise ValueError("SQL array indices start at 1")
        pos = np.full(len(lens), k - 1) if k > 0 else lens + k
    else:  # GetArrayItem, 0-based
        pos = np.full(len(lens), int(e.index.value))
    ok = (pos >= 0) & (pos < lens)
    return _pick(arr.values, starts + pos, ok, at)


def _python_udf(e, table, n) -> pa.Array:
    """An opaque UDF row by row, NULLs passed as ``None`` (Spark's
    Python UDFs see them); a torch UDF over the inputs' values (NULL
    slots 0) through its ``eval_numpy``, NULL where an input is, as on
    the device."""
    at = T.to_arrow_type(e.dtype)
    if isinstance(e, OpaquePythonUDF):
        cols = [cpu_eval(a, table).to_pylist() for a in e.args]
        out = [e.fn(*vals) for vals in zip(*cols)] if cols \
            else [e.fn() for _ in range(n)]
        return pa.array(out, at)
    datas, valid = [], np.ones(n, bool)
    for a in e.args:
        v, ok = _np_vals(cpu_eval(a, table), T.to_arrow_type(a.dtype))
        datas.append(v)
        valid &= ok
    return _from_np(e.eval_numpy(datas, n), valid, at)


def _decimal_arith(e, table) -> pa.Array:
    """Decimal + - * with exact integers: each operand's unscaled value
    at the result's scale (a product at the sum of the scales, rounded
    HALF_UP to the result's), NULL where the result passes its
    precision (Spark's nullOnOverflow), as the JAX CPU engine does with
    Python decimals.  An integral operand is its decimal
    (``T.INTEGRAL_DECIMAL_DIGITS`` digits, scale 0)."""
    dt = e.dtype

    def operand(x):
        a = cpu_eval(x, table)
        if isinstance(x.dtype, T.DecimalType):
            return (*_unscaled(a, x.dtype.scale), x.dtype.scale)
        return (*_np_vals(a, pa.int64()), 0)

    lv, lok, ls = operand(e.left)
    rv, rok, rs = operand(e.right)
    lv, rv = lv.astype(object), rv.astype(object)
    if isinstance(e, A.Multiply):
        out, scale = lv * rv, ls + rs
    else:
        scale = dt.scale
        lv = lv * 10 ** (scale - ls)
        rv = rv * 10 ** (scale - rs)
        out = lv + rv if isinstance(e, A.Add) else lv - rv
    if scale > dt.scale:
        p = 10 ** (scale - dt.scale)
        out = np.array([(abs(x) + p // 2) // p * (1 if x >= 0 else -1)
                        for x in out], object)
    ok = lok & rok & np.array([abs(x) < 10 ** dt.precision for x in out],
                              bool)
    vals = np.array([int(x) if o else 0 for x, o in zip(out, ok)],
                    np.int64)
    return _from_unscaled(vals, ok, dt)


def _dispatch_decimal(e, table) -> pa.Array:
    """The decimal precision expressions, on unscaled integers."""
    c = cpu_eval(e.child, table)
    if isinstance(e, DEC.UnscaledValue):
        v, ok = _unscaled(c, e.child.dtype.scale)
        return _from_np(v, ok, pa.int64())
    if isinstance(e, DEC.MakeDecimal):
        v, ok = _np_vals(c, pa.int64())
        ok = ok & (np.abs(v) < 10 ** e.precision)
        return _from_unscaled(v, ok, e.dtype)
    v, ok = _unscaled(c, e.child.dtype.scale)
    diff = e.target.scale - e.child.dtype.scale
    if isinstance(e, DEC.PromotePrecision):
        return _from_unscaled(v * 10 ** diff, ok, e.target)
    bound = 10 ** e.target.precision  # CheckOverflow, HALF_UP
    if diff < 0:
        p = 10 ** -diff
        v = np.sign(v) * ((np.abs(v) + p // 2) // p)
    elif diff > 0:
        limit = (bound - 1) // 10 ** diff
        ok = ok & (np.abs(v) <= limit)
        v = np.where(ok, v, 0) * 10 ** diff
    ok = ok & (np.abs(v) < bound)
    return _from_unscaled(v, ok, e.target)


def _nan_mask(a: pa.Array) -> Optional[pa.Array]:
    """NaN rows (NULL rows false) of a floating array; None otherwise."""
    if not pa.types.is_floating(a.type):
        return None
    return pc.fill_null(pc.is_nan(a), False)


def _compare(e, table, n):
    l, r = _operands(e, table)
    ct = T.common_type(e.left.dtype, e.right.dtype)
    if isinstance(ct, (T.DecimalType, T.TimestampType)) or (
            isinstance(ct, T.DoubleType) and not (
                pa.types.is_floating(l.type)
                and pa.types.is_floating(r.type))):
        # in the common type: decimals rescaled or made doubles, a date
        # at midnight
        at = T.to_arrow_type(ct)
        l, r = _as_engine_type(l, at), _as_engine_type(r, at)
    # a DATE compares with an integer as its day number
    for a, b in ((l, r), (r, l)):
        if pa.types.is_date32(a.type) and pa.types.is_integer(b.type):
            cast = a.cast(pa.int32()).cast(b.type)
            l, r = (cast, r) if a is l else (l, cast)
    fn = {P.EqualTo: pc.equal, P.LessThan: pc.less,
          P.LessThanOrEqual: pc.less_equal, P.GreaterThan: pc.greater,
          P.GreaterThanOrEqual: pc.greater_equal}[type(e)]
    out = fn(l, r)
    if not (pa.types.is_floating(l.type) or pa.types.is_floating(r.type)):
        return out
    # Spark: NaN is greater than every other value and equal to itself;
    # IEEE comparisons (pyarrow's) say false for every NaN operand
    lnan = _nan_mask(l.cast(pa.float64()))
    rnan = _nan_mask(r.cast(pa.float64()))
    either = pc.or_(lnan, rnan)
    if not pc.any(either).as_py():
        return out
    lt = pc.and_(pc.invert(lnan), rnan)
    eq = pc.and_(lnan, rnan)
    gt = pc.and_(lnan, pc.invert(rnan))
    repl = {P.EqualTo: eq, P.LessThan: lt,
            P.LessThanOrEqual: pc.or_(lt, eq), P.GreaterThan: gt,
            P.GreaterThanOrEqual: pc.or_(gt, eq)}[type(e)]
    valid = pc.and_(pc.is_valid(l), pc.is_valid(r))
    return pc.if_else(pc.and_(either, valid), repl, out)


def _in(e, table, n):
    c = cpu_eval(e.child, table)
    has_null = any(v is None for v in e.values)
    vals = [v for v in e.values if v is not None]
    if pa.types.is_date32(c.type):
        vals = [B.physical_value(v, T.DATE) for v in vals]
        c = c.cast(pa.int32())
        vtype = pa.int32()
    elif pa.types.is_timestamp(c.type) or (
            pa.types.is_decimal(c.type)
            and not any(isinstance(v, float) for v in vals)):
        # physical int64 keys; a decimal value with more digits than the
        # scale matches no row
        dt = e.child.dtype
        cv, cok = _unscaled(c, dt.scale) if isinstance(
            dt, T.DecimalType) else _micros(c)
        c = _from_np(cv, cok, pa.int64())
        keys = []
        for v in vals:
            if isinstance(dt, T.DecimalType):
                d = _decimal.Decimal(v).scaleb(dt.scale)
                if d != d.to_integral_value() or abs(d) >= 2 ** 63:
                    continue
            keys.append(B.physical_value(v, dt))
        vals, vtype = keys, pa.int64()
    elif pa.types.is_integer(c.type) and any(
            isinstance(v, _decimal.Decimal) for v in vals):
        # exact: a decimal with a fraction matches no integer
        vals = [int(v) for v in vals if v == int(v) and abs(v) < 2 ** 63]
        c, vtype = c.cast(pa.int64()), pa.int64()
    elif pa.types.is_decimal(c.type):  # against doubles
        c = c.cast(pa.float64())
        vtype = pa.float64()
    elif pa.types.is_integer(c.type) and any(isinstance(v, float)
                                             for v in vals):
        c = c.cast(pa.float64())
        vtype = pa.float64()
    else:
        vtype = c.type
    if pa.types.is_null(c.type):
        match = pa.array(np.zeros(n, bool))
    elif pa.types.is_floating(c.type):
        # Spark: -0.0 IN (0.0) and NaN IN (NaN) are true
        zero = pa.scalar(0.0, c.type)
        c = pc.if_else(pc.fill_null(pc.equal(c, zero), False), zero, c)
        fvals = [float(v) for v in vals]
        nan_in = any(v != v for v in fvals)
        plain = [0.0 if v == 0.0 else v for v in fvals if v == v]
        match = pc.fill_null(pc.is_in(c, value_set=pa.array(plain, vtype)),
                             False)
        if nan_in:
            match = pc.or_(match, _nan_mask(c))
        else:
            match = pc.and_(match, pc.invert(_nan_mask(c)))
    else:
        match = pc.fill_null(pc.is_in(c, value_set=pa.array(vals, vtype)),
                             False)
    if has_null:  # no match and a NULL in the list: NULL
        match = pc.if_else(match, pa.scalar(True), _nulls(n, pa.bool_()))
    return pc.if_else(pc.is_valid(c), match, _nulls(n, pa.bool_()))


def _integral_div(e, table):
    l, r = _operands(e, table)
    at = _atype(e)
    npdt = at.to_pandas_dtype()
    lv, lok = _np_vals(l, at)
    rv, rok = _np_vals(r, at)
    valid = lok & rok
    _ansi_div_check(valid & (rv == 0))
    if np.issubdtype(npdt, np.floating):
        zero = rv == 0.0
        rv = np.where(zero, 1.0, rv)
        with np.errstate(all="ignore"):
            out = np.fmod(lv, rv)  # exact, as Java's %
            if isinstance(e, A.Pmod):
                out = np.where(out < 0, np.fmod(out + rv, rv), out)
    else:
        zero = rv == 0
        rv = np.where(zero, 1, rv)
        with np.errstate(over="ignore"):
            q = np.where((lv < 0) != (rv < 0),
                         -(np.abs(lv) // np.abs(rv)), lv // rv)
            rem = lv - q * rv
            if isinstance(e, A.IntegralDivide):
                out = q
            elif isinstance(e, A.Pmod):
                out = np.where(rem < 0, _np_java_mod(rem + rv, rv), rem)
            else:
                out = rem
    return _from_np(out.astype(npdt), valid & ~zero, at)


def _np_java_mod(l, r):
    q = np.where((l < 0) != (r < 0), -(np.abs(l) // np.abs(r)), l // r)
    return l - q * r


def _least_greatest(e, table):
    least = not isinstance(e, A.Greatest)
    at = _atype(e)
    npdt = at.to_pandas_dtype()
    acc_v = acc_ok = None
    for x in e.exprs:
        v, ok = _np_vals(cpu_eval(x, table).cast(at), at)
        if acc_v is None:
            acc_v, acc_ok = v.copy(), ok.copy()
            continue
        if np.issubdtype(npdt, np.floating):
            a_nan, b_nan = np.isnan(acc_v), np.isnan(v)  # NaN greatest
            if least:
                better = np.where(a_nan, ~b_nan, ~b_nan & (v < acc_v))
            else:
                better = np.where(b_nan, ~a_nan, ~a_nan & (v > acc_v))
        else:
            better = (v < acc_v) if least else (v > acc_v)
        take = ok & (~acc_ok | better)  # NULLs are skipped
        acc_v = np.where(take, v, acc_v)
        acc_ok = acc_ok | ok
    return _from_np(acc_v.astype(npdt), acc_ok, at)


# -- math --------------------------------------------------------------- #


def _dispatch_math(e, table, n):
    if type(e) in _PC_UNARY:
        c = cpu_eval(e.child, table).cast(pa.float64())
        return _PC_UNARY[type(e)](c).cast(pa.float64())
    if type(e) in _NP_UNARY:
        v, ok = _np_vals(cpu_eval(e.child, table).cast(pa.float64()),
                         pa.float64())
        with np.errstate(all="ignore"):
            return _from_np(_NP_UNARY[type(e)](v), ok, pa.float64())
    if isinstance(e, M._LogBase):
        v, ok = _np_vals(cpu_eval(e.child, table).cast(pa.float64()),
                         pa.float64())
        bad = v <= (-1.0 if isinstance(e, M.Log1p) else 0.0)
        fn = {M.Log: np.log, M.Log10: np.log10, M.Log2: np.log2,
              M.Log1p: np.log1p}[type(e)]
        with np.errstate(all="ignore"):
            return _from_np(fn(np.where(bad, 1.0, v)), ok & ~bad,
                            pa.float64())
    if isinstance(e, M.Logarithm):
        bv, bok = _np_vals(cpu_eval(e.base, table).cast(pa.float64()),
                           pa.float64())
        cv, cok = _np_vals(cpu_eval(e.child, table).cast(pa.float64()),
                           pa.float64())
        bad = (cv <= 0) | (bv <= 0)
        with np.errstate(all="ignore"):
            out = np.log(np.where(cv <= 0, 1.0, cv)) / \
                np.log(np.where(bv <= 0, 2.0, bv))
        return _from_np(out, bok & cok & ~bad, pa.float64())
    if isinstance(e, M.Pow):
        l, r = _operands(e, table)
        return pc.power(l.cast(pa.float64()), r.cast(pa.float64()))
    if isinstance(e, M.Ceil):  # Floor subclasses Ceil
        c = cpu_eval(e.child, table)
        if not pa.types.is_floating(c.type):
            return c.cast(_atype(e))
        # Java's (long) of the rounded double: NaN -> 0, out of range
        # saturates
        v, ok = _np_vals(c, pa.float64())
        r = np.floor(v) if isinstance(e, M.Floor) else np.ceil(v)
        return _from_np(_saturating_long(r, np.int64), ok, pa.int64())
    if isinstance(e, M.Round):  # BRound subclasses Round
        c = cpu_eval(e.child, table)
        mode = "half_to_even" if e.half_even else "half_towards_infinity"
        if pa.types.is_floating(c.type) or e.scale < 0:
            return pc.round(c, ndigits=e.scale, round_mode=mode).cast(
                _atype(e))
        return c.cast(_atype(e))
    if isinstance(e, M.NaNvl):
        at = _atype(e)
        a = cpu_eval(e.left, table).cast(at)
        b = cpu_eval(e.right, table).cast(at)
        return pc.if_else(_nan_mask(a), b, a)
    if isinstance(e, M.NormalizeNaNAndZero):
        a = cpu_eval(e.child, table)
        v, ok = _np_vals(a, a.type)
        return _from_np(np.where(np.isnan(v), np.nan, v) + 0.0, ok, a.type)
    if isinstance(e, M.KnownFloatingPointNormalized):
        return cpu_eval(e.child, table)
    return NotImplemented


def _saturating_long(t: np.ndarray, npdt) -> np.ndarray:
    """Java ``(long) d`` / ``(int) d`` of truncated doubles."""
    info = np.iinfo(npdt)
    hi, lo = float(info.max) + 1.0, float(info.min)
    t = np.where(np.isnan(t), 0.0, t)
    with np.errstate(invalid="ignore"):
        out = np.where((t > lo) & (t < hi), t, 0.0).astype(npdt)
    out = np.where(t >= hi, info.max, out)
    return np.where(t <= lo, info.min, out).astype(npdt)


# -- dates -------------------------------------------------------------- #


def _days(a: pa.Array) -> tuple[np.ndarray, np.ndarray]:
    return _np_vals(a.cast(pa.int32()), pa.int32())


def _dates(v: np.ndarray, ok: np.ndarray) -> pa.Array:
    return _from_np(v.astype(np.int32), ok, pa.int32()).cast(pa.date32())


def _dispatch_datetime(e, table, n):  # noqa: C901 - one branch a class
    if isinstance(e, DT._DateField):
        c = cpu_eval(e.child, table)
        if pa.types.is_timestamp(c.type):  # its UTC day
            v, ok = _micros(c)
            c = _dates(np.floor_divide(v, _US_PER_DAY), ok)
        fns = {DT.Year: pc.year, DT.Month: pc.month,
               DT.DayOfMonth: pc.day, DT.Quarter: pc.quarter,
               DT.DayOfYear: pc.day_of_year}
        if type(e) in fns:
            return fns[type(e)](c).cast(pa.int32())
        if isinstance(e, DT.DayOfWeek):  # Sunday = 1 .. Saturday = 7
            return pc.add(pc.day_of_week(c, count_from_zero=True,
                                         week_start=7), 1).cast(pa.int32())
        if isinstance(e, DT.WeekDay):  # Monday = 0 .. Sunday = 6
            return pc.day_of_week(c, count_from_zero=True,
                                  week_start=1).cast(pa.int32())
    if isinstance(e, DT.LastDay):
        v, ok = _days(cpu_eval(e.child, table))
        m = v.astype("datetime64[D]").astype("datetime64[M]")
        last = (m + 1).astype("datetime64[D]") - np.timedelta64(1, "D")
        return _dates(last.astype(np.int64), ok)
    if isinstance(e, DT.AddMonths):
        v, ok = _days(cpu_eval(e.child, table))

        def shift(x: int) -> int:
            d = _EPOCH + _dt.timedelta(days=int(x))
            mi = d.year * 12 + (d.month - 1) + e.months
            y, m = divmod(mi, 12)
            day = min(d.day, calendar.monthrange(y, m + 1)[1])
            return (_dt.date(y, m + 1, day) - _EPOCH).days

        return _dates(np.array([shift(x) for x in v], np.int64), ok)
    if isinstance(e, DT.DateAdd):  # DateSub subclasses DateAdd
        lv, lok = _days(cpu_eval(e.left, table))
        rv, rok = _np_vals(cpu_eval(e.right, table), pa.int64())
        sign = -1 if isinstance(e, DT.DateSub) else 1
        return _dates(lv.astype(np.int64) + sign * rv, lok & rok)
    if isinstance(e, DT.DateDiff):
        lv, lok = _days(cpu_eval(e.left, table))
        rv, rok = _days(cpu_eval(e.right, table))
        return _from_np((lv - rv).astype(np.int32), lok & rok, pa.int32())
    if isinstance(e, DT._TimeField):
        v, ok = _micros(cpu_eval(e.child, table))
        secs = np.mod(v, _US_PER_DAY) // 1_000_000
        field = {DT.Hour: secs // 3600, DT.Minute: secs // 60 % 60,
                 DT.Second: secs % 60}[type(e)]
        return _from_np(field.astype(np.int32), ok, pa.int32())
    if isinstance(e, DT.UnixTimestampFromTs):
        v, ok = _micros(cpu_eval(e.child, table))
        return _from_np(np.floor_divide(v, 1_000_000), ok, pa.int64())
    if isinstance(e, (DT.FromUnixTime, DT.DateFormatClass)):
        return _format_datetime(e, table)
    if isinstance(e, DT.TimeAdd):  # TimeSub subclasses TimeAdd
        v, ok = _micros(cpu_eval(e.child, table))
        iv, sign = e.interval, e._sign
        out = [_add_interval_us(int(x), iv.months * sign, iv.days * sign,
                                iv.microseconds * sign) for x in v]
        return _from_micros(np.array(out, np.int64), ok)
    if isinstance(e, DT.DateAddInterval):
        v, ok = _days(cpu_eval(e.child, table))
        iv = e.interval
        out = [_add_interval_us(int(x) * _US_PER_DAY, iv.months, iv.days,
                                iv.microseconds) // _US_PER_DAY for x in v]
        return _dates(np.array(out, np.int64), ok)
    return NotImplemented


_PY_FORMAT = (("yyyy", "%Y"), ("MM", "%m"), ("dd", "%d"), ("HH", "%H"),
              ("mm", "%M"), ("ss", "%S"))


def _format_datetime(e, table) -> pa.Array:
    """from_unixtime / date_format in UTC by ``strftime``, any format
    made of the pattern letters of ``_PY_FORMAT``."""
    c = cpu_eval(e.child, table)
    if isinstance(e, DT.FromUnixTime):
        v, ok = _np_vals(c, pa.int64())
        v = v * 1_000_000
    elif pa.types.is_date32(c.type):
        v, ok = _days(c)
        v = v.astype(np.int64) * _US_PER_DAY
    else:
        v, ok = _micros(c)
    fmt = e.fmt
    for token, py in _PY_FORMAT:
        fmt = fmt.replace(token, py)
    epoch = _dt.datetime(1970, 1, 1)
    out = [(epoch + _dt.timedelta(microseconds=int(x))).strftime(fmt)
           if good else None for x, good in zip(v, ok)]
    return pa.array(out, pa.string())


def _add_interval_us(us: int, months: int, days: int,
                     microseconds: int) -> int:
    """Microseconds since the epoch plus a calendar interval: the month
    shift clamps the day to the target month's end (Spark's
    add_months), then the days and microseconds add."""
    t = _dt.datetime(1970, 1, 1) + _dt.timedelta(microseconds=us)
    m0 = t.month - 1 + months
    y = t.year + m0 // 12
    m = m0 % 12 + 1
    t = t.replace(year=y, month=m,
                  day=min(t.day, calendar.monthrange(y, m)[1]))
    t += _dt.timedelta(days=days, microseconds=microseconds)
    d = t - _dt.datetime(1970, 1, 1)
    return d.days * _US_PER_DAY + d.seconds * 1_000_000 + d.microseconds


# -- strings ------------------------------------------------------------ #


def _dispatch_strings(e, table, n):
    if isinstance(e, S.Length):
        return pc.utf8_length(cpu_eval(e.child, table)).cast(pa.int32())
    if isinstance(e, S.Upper):  # Lower subclasses Upper
        c = cpu_eval(e.child, table)
        return pc.utf8_lower(c) if isinstance(e, S.Lower) \
            else pc.utf8_upper(c)
    if isinstance(e, S.StartsWith):  # EndsWith, Contains subclass it
        c = cpu_eval(e.left, table)
        needle = e.right.value
        if needle is None:
            return _nulls(n, pa.bool_())
        fn = {S.StartsWith: pc.starts_with, S.EndsWith: pc.ends_with,
              S.Contains: pc.match_substring}[type(e)]
        return fn(c, pattern=needle)
    if isinstance(e, S.Like):
        return pc.match_like(cpu_eval(e.left, table), pattern=e.pattern)
    if isinstance(e, S.Substring):
        c = cpu_eval(e.child, table)
        if e.pos >= 0:
            start = max(e.pos - 1, 0)
            stop = None if e.length is None else start + max(e.length, 0)
            return pc.utf8_slice_codeunits(c, start=start, stop=stop)
        out = []
        # a negative pos counts from the end; the length runs from the
        # unclamped start (substring('abc', -5, 3) = 'a')
        for v in c.to_pylist():
            if v is None:
                out.append(None)
                continue
            start = len(v) + e.pos
            end = len(v) if e.length is None else start + max(e.length, 0)
            out.append(v[max(start, 0):max(end, 0)])
        return pa.array(out, pa.string())
    if isinstance(e, S.StringTrim):
        c = cpu_eval(e.child, table)
        if isinstance(e, S.StringTrimLeft):
            return pc.utf8_ltrim(c, characters=" ")
        if isinstance(e, S.StringTrimRight):
            return pc.utf8_rtrim(c, characters=" ")
        return pc.utf8_trim(c, characters=" ")
    if isinstance(e, S.Concat):
        arrs = [cpu_eval(x, table).cast(pa.string()) for x in e.exprs]
        return pc.binary_join_element_wise(*arrs, "",
                                           null_handling="emit_null")
    if isinstance(e, _STRING_TAIL):
        return _string_tail(e, table, n)
    return NotImplemented


_STRING_TAIL = (S.StringReplace, S.StringLPad, S.StringLocate,
                S.SubstringIndex, S.InitCap, S.ConcatWs, S.StringSplit,
                S.SplitPart, S.GetJsonObject)


def _string_tail(e, table, n):  # noqa: C901 - one branch a class
    """The long tail as Python's ``str`` does it (the JAX engine's
    definitions, Java's where Spark delegates there)."""
    if isinstance(e, S.ConcatWs):
        sep = e.sep.value
        cols = [cpu_eval(c, table).to_pylist() for c in e.exprs]
        if sep is None:
            return _nulls(n, pa.string())
        return pa.array([sep.join(c[i] for c in cols if c[i] is not None)
                         for i in range(n)], pa.string())
    vals = cpu_eval(e.child, table).to_pylist()

    def mapped(fn, at=pa.string()):
        return pa.array([None if v is None else fn(v) for v in vals], at)

    if isinstance(e, S.RegExpReplace):
        pat, rep = e.search.value, e.replacement.value or ""
        return mapped(lambda s: re.sub(pat, rep, s))
    if isinstance(e, S.StringReplace):
        search, rep = e.search.value or "", e.replacement.value or ""
        return mapped(lambda s: s.replace(search, rep) if search else s)
    if isinstance(e, S.StringLPad):  # StringRPad subclasses it
        tgt, p, left = int(e.length.value), e.pad.value or "", e._left

        def pad(s):
            if tgt <= 0:
                return ""
            if len(s) >= tgt or not p:
                return s[:tgt]
            fill = (p * tgt)[: tgt - len(s)]
            return fill + s if left else s + fill

        return mapped(pad)
    if isinstance(e, S.StringLocate):
        sub, start = e.substr.value or "", int(e.start.value)

        def locate(s):
            if start <= 0:
                return 0
            if not sub:
                return min(start, len(s) + 1)
            return s.find(sub, start - 1) + 1

        return mapped(locate, pa.int32())
    if isinstance(e, S.SubstringIndex):
        d, cnt = e.delim.value or "", int(e.count.value)

        def substring_index(s):
            if cnt == 0 or not d:
                return ""
            hits, pos = [], 0
            while (j := s.find(d, pos)) >= 0:
                hits.append(j)
                pos = j + len(d)
            if cnt > 0:
                return s if len(hits) < cnt else s[: hits[cnt - 1]]
            k = len(hits) + cnt
            return s if k < 0 else s[hits[k] + len(d):]

        return mapped(substring_index)
    if isinstance(e, S.InitCap):
        def initcap(s):
            out, prev = [], " "
            for ch in s:
                out.append(ch.upper() if prev == " " else ch.lower())
                prev = ch
            return "".join(out)

        return mapped(initcap)
    if isinstance(e, S.SplitPart):
        def part(s):
            pieces = _java_split(re.escape(e.delim.value), s, -1)
            return pieces[e.index] if 0 <= e.index < len(pieces) else None

        return mapped(part)
    if isinstance(e, S.StringSplit):
        if e.delim.value is None:
            return _nulls(n, pa.list_(pa.string()))
        return mapped(lambda s: _java_split(e.delim.value, s, e.limit),
                      pa.list_(pa.string()))
    return _get_json_object(e, vals)


def _java_split(pattern: str, s: str, limit: int) -> list[str]:
    """java.lang.String.split: groups never leak into the pieces (unlike
    re.split), a zero-width match at either end is skipped, ``limit`` >
    0 caps the piece count, ``limit`` == 0 drops trailing empty
    pieces."""
    out, last = [], 0
    for m in re.finditer(pattern, s):
        if 0 < limit <= len(out) + 1:
            break
        if m.start() == m.end() and (m.start() in (0, len(s))
                                     or m.start() < last):
            continue
        out.append(s[last:m.start()])
        last = m.end()
    out.append(s[last:])
    if limit == 0:
        while out and out[-1] == "":
            out.pop()
    return out


def _get_json_object(e, vals: list) -> pa.Array:
    """get_json_object over Python's ``json``: a string value without
    its quotes, true / false, anything else as compact JSON; NULL where
    the text is not JSON or the path finds nothing."""
    path = e.path.value
    if any(tok in path for tok in ("*", "..")):
        raise NotImplementedError(
            f"get_json_object path {path!r}: wildcard/recursive descent "
            "is not implemented (simple $.a.b[i] paths only)")
    steps = S.GetJsonObject.parse_path(path)
    out = []
    for v in vals:
        if v is None or steps is None:
            out.append(None)
            continue
        try:
            cur = json.loads(v)
        except ValueError:
            out.append(None)
            continue
        for st in steps:
            if isinstance(st, int):
                cur = cur[st] if isinstance(cur, list) \
                    and 0 <= st < len(cur) else None
            else:
                cur = cur.get(st) if isinstance(cur, dict) else None
            if cur is None:
                break
        if cur is None:
            out.append(None)
        elif isinstance(cur, str):
            out.append(cur)
        elif isinstance(cur, bool):
            out.append("true" if cur else "false")
        else:
            out.append(json.dumps(cur, separators=(",", ":"),
                                  ensure_ascii=False))
    return pa.array(out, pa.string())


def _bitwise(e, table) -> pa.Array:
    """& | ^ ~ over pyarrow; shifts in numpy with Java's rules (the
    amount modulo the width, >>> zero-filling)."""
    if isinstance(e, BW.BitwiseBinary):
        at = _atype(e)
        fn = {BW.BitwiseAnd: pc.bit_wise_and, BW.BitwiseOr: pc.bit_wise_or,
              BW.BitwiseXor: pc.bit_wise_xor}[type(e)]
        l, r = _operands(e, table)
        return fn(l.cast(at), r.cast(at))
    if isinstance(e, BW.BitwiseNot):
        return pc.bit_wise_not(cpu_eval(e.child, table))
    l = cpu_eval(e.left, table)
    bits = 64 if pa.types.is_int64(l.type) else 32
    npdt = np.int64 if bits == 64 else np.int32
    lv, lok = _np_vals(l, l.type)
    rv, rok = _np_vals(cpu_eval(e.right, table), pa.int32())
    amount = rv.astype(npdt) & (bits - 1)
    lv = lv.astype(npdt)
    if isinstance(e, BW.ShiftRightUnsigned):
        u = np.uint64 if bits == 64 else np.uint32
        out = (lv.view(u) >> amount.astype(u)).view(npdt)
    elif isinstance(e, BW.ShiftRight):
        out = lv >> amount
    else:
        with np.errstate(over="ignore"):
            out = lv << amount
    at = _atype(e)
    with np.errstate(over="ignore"):
        return _from_np(out.astype(at.to_pandas_dtype()), lok & rok, at)


# -- casts -------------------------------------------------------------- #


def _cast(e: Cast, table, n):
    src, dst = e.child.dtype, e.to
    c = cpu_eval(e.child, table)
    at = T.to_arrow_type(dst)
    if src == dst:
        return c
    if isinstance(src, T.NullType):
        return _nulls(n, at)
    if isinstance(src, (T.DecimalType, T.TimestampType)) or isinstance(
            dst, (T.DecimalType, T.TimestampType)):
        if not (cast_supported(src, dst) or _cpu_only_cast(src, dst)):
            # as both JAX engines refuse
            raise NotImplementedError(f"CPU engine: cast {src} -> {dst}")
    if isinstance(src, T.StringType):  # each distinct text parsed once
        enc = c.dictionary_encode()
        out = _cast_from_string(enc.dictionary, dst, at).take(enc.indices)
        if _ansi() and out.null_count > c.null_count:
            _ansi_raise(f"invalid input syntax for type {dst.name} "
                        "(ANSI cast)")
        return out
    if _ansi() and isinstance(dst, T.IntegralType) \
            and isinstance(src, (T.FractionalType, T.IntegralType)):
        info = np.iinfo(at.to_pandas_dtype())
        if isinstance(src, T.FractionalType):
            v, ok = _np_vals(c, pa.float64())
            t = np.trunc(v)
            bad = ok & (np.isnan(v) | (t > float(info.max))
                        | (t < float(info.min)))
        else:  # integers compared as integers: no float round trip
            v, ok = _np_vals(c, c.type)
            bad = ok & ((v > info.max) | (v < info.min))
        if bad.any():
            _ansi_raise(f"value out of range for {dst.name} (ANSI cast "
                        "overflow)")
    if isinstance(src, T.TimestampType):
        return _cast_timestamp(c, dst, at)
    if isinstance(dst, T.StringType):  # a decimal prints its scale
        return pc.cast(c, pa.string())
    if isinstance(dst, T.BooleanType):
        return pc.not_equal(c, pa.scalar(0).cast(c.type))
    if isinstance(src, T.BooleanType):
        return pc.cast(c, at)
    if isinstance(src, T.DecimalType):
        v, ok = _unscaled(c, src.scale)
        if isinstance(dst, T.DecimalType):  # widening: exact
            return _from_unscaled(v * 10 ** (dst.scale - src.scale), ok, dst)
        if isinstance(dst, T.TimestampType):  # seconds, as Spark
            return _from_micros(_wrap_long(
                _scaled_exact(v, 6 - src.scale)), ok)
        if isinstance(dst, (T.IntegralType, T.DateType)):
            # Java's truncation toward zero, then the low bits; a DATE
            # takes the day number, as both JAX engines do
            whole = _scaled_exact(v, -src.scale).astype(np.int64)
            if isinstance(dst, T.DateType):
                return _dates(whole, ok)
            return _from_np(whole.astype(at.to_pandas_dtype()), ok, at)
        return _from_np((v / 10.0 ** src.scale).astype(
            at.to_pandas_dtype()), ok, at)
    if isinstance(dst, T.DecimalType):  # from an integral type
        v, ok = _np_vals(c, pa.int64())
        return _from_unscaled(v * 10 ** dst.scale, ok, dst)
    if isinstance(dst, T.TimestampType):
        if isinstance(src, T.DateType):
            v, ok = _days(c)
            return _from_micros(v.astype(np.int64) * _US_PER_DAY, ok)
        if isinstance(src, T.FractionalType):
            # Spark's doubleToTimestamp: NaN and infinities are NULL,
            # the rest (seconds * 10^6).toLong
            v, ok = _np_vals(c, pa.float64())
            ok = ok & np.isfinite(v)
            with np.errstate(invalid="ignore", over="ignore"):
                us = _saturating_long(np.trunc(np.where(ok, v, 0.0)
                                               * 1e6), np.int64)
            return _from_micros(us, ok)
        v, ok = _np_vals(c, pa.int64())  # integral seconds, saturated
        lim = np.iinfo(np.int64).max // 1_000_000
        us = np.where(v > lim, np.iinfo(np.int64).max,
                      np.where(v < -lim, np.iinfo(np.int64).min,
                               np.clip(v, -lim, lim) * 1_000_000))
        return _from_micros(us, ok)
    if isinstance(dst, T.DateType):  # a number is a day number (JAX)
        if isinstance(src, T.FractionalType):
            v, ok = _np_vals(c, pa.float64())
            return _dates(_saturating_long(np.trunc(v), np.int32), ok)
        v, ok = _np_vals(c, pa.int64())
        return _dates(v.astype(np.int32), ok)  # the low 32 bits
    npdt = at.to_pandas_dtype()
    if isinstance(src, T.FractionalType) and isinstance(
            dst, T.IntegralType):
        v, ok = _np_vals(c, pa.float64())
        return _from_np(_saturating_long(np.trunc(v), npdt), ok, at)
    v, ok = _np_vals(c, c.type)
    with np.errstate(over="ignore"):
        return _from_np(v.astype(npdt), ok, at)  # integers keep low bits


def _cpu_only_cast(src, dst) -> bool:
    """The DECIMAL and TIMESTAMP casts outside the device matrix that
    this engine runs, as the JAX CPU engine does: a DECIMAL to a STRING,
    an integral type, a DATE or a TIMESTAMP; a TIMESTAMP to a STRING, a
    BOOLEAN or a number; a number to a TIMESTAMP."""
    num = (T.IntegralType, T.FractionalType)
    if isinstance(src, T.DecimalType):
        return isinstance(dst, (T.StringType, T.IntegralType, T.DateType,
                                T.TimestampType))
    if isinstance(src, T.TimestampType):
        return isinstance(dst, (T.StringType, T.BooleanType) + num)
    return isinstance(dst, T.TimestampType) and isinstance(src, num)


def _scaled_exact(v: np.ndarray, exp: int) -> np.ndarray:
    """``v * 10^exp`` as Python integers, truncated toward zero when
    ``exp`` is negative (Java's BigDecimal.longValue before its wrap)."""
    v = v.astype(object)
    if exp >= 0:
        return v * 10 ** exp
    p = 10 ** -exp
    return np.array([abs(x) // p * (1 if x >= 0 else -1) for x in v],
                    object)


def _wrap_long(v: np.ndarray) -> np.ndarray:
    """Python integers to int64 by their low 64 bits."""
    return np.array([(int(x) + 2 ** 63) % 2 ** 64 - 2 ** 63 for x in v],
                    np.int64)


def _cast_timestamp(c: pa.Array, dst, at) -> pa.Array:
    """A TIMESTAMP cast as Spark casts it: to a number its seconds
    (floored for an integral type, with the fraction for a floating
    one), to a BOOLEAN whether it is not the epoch, to a DATE its UTC
    day, to a STRING ``yyyy-MM-dd HH:mm:ss`` with the fraction's digits
    up to its last non-zero one."""
    v, ok = _micros(c)
    if isinstance(dst, T.DateType):
        return _dates(np.floor_divide(v, _US_PER_DAY), ok)
    if isinstance(dst, T.BooleanType):
        return _from_np(v != 0, ok, pa.bool_())
    if isinstance(dst, T.IntegralType):
        secs = np.floor_divide(v, 1_000_000)
        return _from_np(secs.astype(at.to_pandas_dtype()), ok, at)
    if isinstance(dst, T.FractionalType):
        return _from_np((v / 1e6).astype(at.to_pandas_dtype()), ok, at)
    text = np.datetime_as_string(v.astype("datetime64[us]"), unit="us")
    out = [t.replace("T", " ").rstrip("0").rstrip(".") for t in text]
    return pa.array(out, pa.string(), mask=~ok)


_INT_RE = re.compile(r"^([+-]?)([0-9]*)(?:\.([0-9]*))?$")
_DATE_RE = re.compile(r"^([0-9]{4})(?:-([0-9]{1,2})(?:-([0-9]{1,2}))?)?"
                      r"(?:[T ].*)?$")


def _cast_from_string(c: pa.Array, dst, at) -> pa.Array:
    """Spark's non-ANSI casts from STRING: the text trimmed, NULL when it
    is malformed or out of range."""
    out: list = []
    texts = c.to_pylist()
    if isinstance(dst, T.IntegralType):
        info = np.iinfo(at.to_pandas_dtype())
        for v in texts:
            m = None if v is None else _INT_RE.match(v.strip(_CAST_WS))
            if m is None or not (m.group(2) or m.group(3)):
                out.append(None)
                continue
            iv = int((m.group(1) or "") + (m.group(2) or "0"))
            out.append(iv if info.min <= iv <= info.max else None)
    elif isinstance(dst, T.FractionalType):  # parsed as a double
        for v in texts:
            try:
                out.append(None if v is None else float(v.strip(_CAST_WS)))
            except ValueError:
                out.append(None)
    elif isinstance(dst, T.BooleanType):
        true_set = {"true", "t", "yes", "y", "1"}
        false_set = {"false", "f", "no", "n", "0"}
        for v in texts:
            s = None if v is None else v.strip(_CAST_WS).lower()
            out.append(True if s in true_set
                       else False if s in false_set else None)
    elif isinstance(dst, T.DateType):
        # yyyy, yyyy-[m]m or yyyy-[m]m-[d]d, then optionally a time part
        for v in texts:
            m = None if v is None else _DATE_RE.match(v.strip(_CAST_WS))
            try:
                out.append(None if m is None else _dt.date(
                    int(m.group(1)), int(m.group(2) or 1),
                    int(m.group(3) or 1)))
            except ValueError:
                out.append(None)
    else:
        raise NotImplementedError(f"CPU cast string -> {dst}")
    return pa.array(out, at)


# -- murmur3 ------------------------------------------------------------ #


def _np_rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _np_mix_k1(k1):
    k1 = k1 * np.uint32(0xCC9E2D51)
    k1 = _np_rotl(k1, 15)
    return k1 * np.uint32(0x1B873593)


def _np_mix_h1(h1, k1):
    h1 = h1 ^ k1
    h1 = _np_rotl(h1, 13)
    return h1 * np.uint32(5) + np.uint32(0xE6546B64)


def _np_fmix(h1, length):
    h1 = h1 ^ np.uint32(length)
    h1 ^= h1 >> np.uint32(16)
    h1 = h1 * np.uint32(0x85EBCA6B)
    h1 ^= h1 >> np.uint32(13)
    h1 = h1 * np.uint32(0xC2B2AE35)
    h1 ^= h1 >> np.uint32(16)
    return h1


def _np_hash_i64(v: np.ndarray, seed: np.ndarray) -> np.ndarray:
    low = (v & np.int64(0xFFFFFFFF)).astype(np.uint32)
    high = ((v >> np.int64(32)) & np.int64(0xFFFFFFFF)).astype(np.uint32)
    h1 = _np_mix_h1(seed, _np_mix_k1(low))
    h1 = _np_mix_h1(h1, _np_mix_k1(high))
    return _np_fmix(h1, 8)


def _np_hash_col(a: pa.Array, seed: np.ndarray) -> np.ndarray:
    """Spark's murmur3 of one column, chained on ``seed``; a NULL row
    keeps its seed.  Strings hash their UTF-8 bytes, tail bytes
    sign-extended (``hashUnsafeBytes``)."""
    t = a.type
    valid = np.asarray(a.is_valid())
    if pa.types.is_null(t):
        return seed.copy()
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        out = seed.copy()
        for i, v in enumerate(a.to_pylist()):
            if v is None:
                continue
            bs = v.encode("utf-8")
            h1 = np.uint32(seed[i])
            aligned = len(bs) - len(bs) % 4
            for j in range(0, aligned, 4):
                word = np.uint32(int.from_bytes(bs[j:j + 4], "little"))
                h1 = _np_mix_h1(h1, _np_mix_k1(word))
            for j in range(aligned, len(bs)):
                b = bs[j] - 256 if bs[j] >= 128 else bs[j]
                h1 = _np_mix_h1(h1, _np_mix_k1(np.uint32(b & 0xFFFFFFFF)))
            out[i] = _np_fmix(h1, len(bs))
        return out
    if pa.types.is_float32(t):
        v, _ = _np_vals(a, pa.float32())
        v = np.where(v == 0.0, np.float32(0.0), v)  # -0.0 hashes as 0.0
        bits = np.where(np.isnan(v), np.int32(0x7FC00000), v.view(np.int32))
        h = _np_fmix(_np_mix_h1(seed, _np_mix_k1(bits.astype(np.uint32))), 4)
    elif pa.types.is_floating(t):
        v, _ = _np_vals(a, pa.float64())
        v = np.where(v == 0.0, 0.0, v)  # -0.0 hashes as 0.0
        bits = np.where(np.isnan(v), np.int64(0x7FF8000000000000),
                        v.view(np.int64))
        h = _np_hash_i64(bits, seed)
    elif pa.types.is_int64(t):
        v, _ = _np_vals(a, pa.int64())
        h = _np_hash_i64(v, seed)
    elif pa.types.is_timestamp(t):
        h = _np_hash_i64(_micros(a)[0], seed)
    elif pa.types.is_decimal(t):
        h = _np_hash_i64(_unscaled(a, t.scale)[0], seed)
    else:  # BOOLEAN, TINYINT, SMALLINT, INT and DATE hash as an int
        v, _ = _np_vals(a.cast(pa.int32()), pa.int32())
        h = _np_fmix(_np_mix_h1(seed, _np_mix_k1(v.astype(np.uint32))), 4)
    return np.where(valid, h, seed)


# ---------------------------------------------------------------------- #
# Plan execution
# ---------------------------------------------------------------------- #
#
# Each node is run for the columns its parent reads (``need``: output
# names, None for all): a scan reads only those from its files, and every
# column no one reads is a placeholder of the NULL type, marked in its
# field's metadata, that costs no memory.  Positions and names stay the
# schema's, so ordinals still resolve; a node whose expressions read by
# ordinal needs all of its child's columns.  Reading a placeholder raises.

_PRUNED = {b"pruned": b"1"}


def execute_cpu(plan: L.LogicalPlan, ansi: bool = False) -> pa.Table:
    """``plan`` run to one Arrow table of its schema; ``ansi``: ANSI mode
    (its errors raise ``AnsiError``)."""
    prev = _ansi()
    _MODE.ansi = ansi
    try:
        return _run(plan, None)
    finally:
        _MODE.ansi = prev


def _placeholder(name: str, n: int) -> tuple[pa.Field, pa.Array]:
    return pa.field(name, pa.null(), metadata=_PRUNED), pa.nulls(n)


def _assemble(arrays: list, schema: T.Schema, n: int) -> pa.Table:
    """A table of ``schema``: each array cast to its field's type, a
    None a placeholder."""
    fields, cols = [], []
    for a, f in zip(arrays, arrow_schema(schema)):
        if a is None:
            f, a = _placeholder(f.name, n)
        elif a.type != f.type:
            a = _as_engine_type(a, f.type)
        fields.append(f)
        cols.append(a)
    return pa.Table.from_arrays(cols, schema=pa.schema(fields))


def _by_position(e) -> bool:
    return isinstance(e, B.BoundReference) or any(
        _by_position(c) for c in e.children)


def _reads(exprs) -> Optional[set]:
    """The names ``exprs`` read; None (all) when one reads by ordinal."""
    exprs = list(exprs)
    if any(_by_position(e) for e in exprs):
        return None
    return set().union(*(e.references() for e in exprs))


def _union(need: Optional[set], *more: Optional[set]) -> Optional[set]:
    if need is None or any(m is None for m in more):
        return None
    return need.union(*more)


def _kept(schema: T.Schema, need: Optional[set]) -> list[int]:
    return [i for i, f in enumerate(schema.fields)
            if need is None or f.name in need]


_INNER_NODES = (L.Project, L.Filter, L.Expand, L.Aggregate, L.Sort,
                L.Limit, L.Union, L.Join, L.Window, L.Generate)


def _run(plan: L.LogicalPlan, need: Optional[set]) -> pa.Table:
    if isinstance(plan, (L.InMemoryRelation, L.FileRelation, L.RangeRel)):
        return _leaf(plan, need)
    if isinstance(plan, (L.Cached, L.MapInArrow, L.GroupedPandas,
                         L.CoGroupedPandas)):
        return _python_node(plan)
    if not isinstance(plan, _INNER_NODES):
        raise NotImplementedError(f"CPU engine: {type(plan).__name__}")
    child = plan.children[0]
    cs = child.schema
    if isinstance(plan, L.Project):
        kept = _kept(plan.schema, need)
        t = _run(child, _reads(plan.exprs[i] for i in kept))
        return _assemble([cpu_eval(bind_references(e, cs), t)
                          if i in kept else None
                          for i, e in enumerate(plan.exprs)],
                         plan.schema, t.num_rows)
    if isinstance(plan, L.Filter):
        t = _run(child, _union(need, _reads([plan.condition])))
        mask = cpu_eval(bind_references(plan.condition, cs), t)
        return t.filter(pc.fill_null(mask.cast(pa.bool_()), False))
    if isinstance(plan, L.Expand):
        kept = _kept(plan.schema, need)
        t = _run(child, _reads(proj[i] for proj in plan.projections
                               for i in kept))
        return pa.concat_tables(
            _assemble([cpu_eval(bind_references(e, cs), t)
                       if i in kept else None
                       for i, e in enumerate(proj)], plan.schema,
                      t.num_rows)
            for proj in plan.projections)
    if isinstance(plan, L.Aggregate):
        return _aggregate(plan, _run(child, _reads(
            list(plan.groups) + [e for na in plan.aggs
                                 for e in na.fn.inputs()])))
    if isinstance(plan, L.Sort):
        return _sort(plan, _run(child, _union(
            need, _reads(k.expr for k in plan.keys))))
    if isinstance(plan, L.Limit):
        return _run(child, need).slice(0, plan.n)
    if isinstance(plan, L.Union):
        kept = _kept(plan.schema, need)
        tables = []
        for c in plan.children:  # members read by position
            names = c.schema.names
            unique = len(set(names)) == len(names)
            t = _run(c, {names[i] for i in kept} if unique and need
                     is not None else None)
            tables.append(_assemble(
                [t.column(i) if i in kept else None
                 for i in range(t.num_columns)], plan.schema, t.num_rows))
        return pa.concat_tables(tables)
    if isinstance(plan, L.Join):
        return _join(plan, need)
    if isinstance(plan, L.Generate):
        keep = None if need is None else need - {plan.out_name, "pos"}
        return _generate(plan, _run(child, _union(
            keep, _reads([plan.generator.child]))), keep)
    if isinstance(plan, L.Window):
        made = {name for _, name in plan.window_exprs}
        reads = _reads(e for we, _ in plan.window_exprs for e in (
            list(we.fn.inputs()) + list(we.spec.partition_by)
            + [k.expr for k in we.spec.order_by]))
        return _window(plan, _run(child, _union(
            None if need is None else need - made, reads)))


def _python_node(plan) -> pa.Table:
    """Cached (the slot's own CPU table, made once) and the Python nodes,
    run in-process over their whole children through the workers'
    wrappers (``python_worker/wrappers.py``), cast to the declared
    schema."""
    import functools

    from spark_rapids_tpu_torch.python_worker import wrappers as PW

    if isinstance(plan, L.Cached):
        with plan.slot.lock:
            if plan.slot.cpu_table is not None:
                return plan.slot.cpu_table
        t = _run(plan.children[0], None)
        with plan.slot.lock:
            if plan.slot.cpu_table is None:
                plan.slot.cpu_table = t
            return plan.slot.cpu_table
    aschema = arrow_schema(plan.schema)
    kids = [_run(c, None) for c in plan.children]
    if isinstance(plan, L.MapInArrow):
        fn = functools.partial(PW._map_in_pandas_wrapper, fn=plan.fn,
                               aschema=aschema) if plan.pandas else plan.fn
    elif isinstance(plan, L.CoGroupedPandas):
        lt, rt = kids
        kids = [PW.cogroup_table(lt, rt)]
        fn = functools.partial(
            PW._cogroup_wrapper, fn=plan.fn, left_keys=plan.left_key_names,
            right_keys=plan.right_key_names, aschema=aschema,
            n_left_cols=lt.num_columns, left_names=lt.column_names,
            right_names=rt.column_names)
    else:
        wrapper, arg = {
            "flatmap": (PW._grouped_apply_wrapper, "fn"),
            "agg": (PW._grouped_agg_wrapper, "aggs"),
            "window": (PW._window_in_pandas_wrapper, "fns")}[plan.kind]
        fn = functools.partial(wrapper, key_names=plan.key_names,
                               aschema=aschema, **{arg: plan.payload})
    out = fn(kids[0])
    if isinstance(out, pa.RecordBatch):
        out = pa.Table.from_batches([out])
    return out.cast(aschema)


def _leaf(plan, need: Optional[set]) -> pa.Table:
    kept = _kept(plan.schema, need)
    names = [plan.schema.fields[i].name for i in kept]
    if isinstance(plan, L.RangeRel):
        total = max(0, -(-(plan.end - plan.start) // plan.step))
        t = pa.table({"id": plan.start + np.arange(total, dtype=np.int64)
                      * plan.step})
    elif isinstance(plan, L.FileRelation):
        t = pa.concat_tables(_scan_file(plan, fi, names)
                             for fi in range(len(plan.paths)))
    else:
        t = plan.table.select(names)
    cols = dict(zip(names, t.columns))
    return _assemble([cols.get(f.name) if i in kept else None
                      for i, f in enumerate(plan.schema.fields)],
                     plan.schema, t.num_rows)


def _read_file(plan, path: str, columns: list) -> pa.Table:
    """One file's ``columns`` (file columns only); its rows even for
    none (JAX ``_read_scan_file``)."""
    if isinstance(plan, L.OrcRelation):
        import pyarrow.orc as paorc

        f = paorc.ORCFile(path)
        if not columns:
            # ORC's read(columns=[]) loses the row count: read one
            return f.read(columns=f.schema.names[:1]).select([])
        return f.read(columns=columns)
    if isinstance(plan, L.CsvRelation):
        return L.read_csv_file(path, plan.file_fields).select(columns)
    # the file alone: read_table would parse a key=value directory too
    return pq.ParquetFile(path).read(columns=columns)


def _scan_file(plan, fi: int, names: list) -> pa.Table:
    """File ``fi``'s columns ``names``: its partition values (JAX
    ``_scan_cpu``), and the hidden input-file columns: the file's path,
    0 and its size."""
    from spark_rapids_tpu_torch.io.pushdown import typed_partition_value

    path = plan.paths[fi]
    parts = {f.name: f for f in plan.partition_fields}
    hidden = {f.name for f in ND.INPUT_FILE_FIELDS}
    t = _read_file(plan, path, [c for c in names
                                if c not in hidden and c not in parts])
    n = t.num_rows
    pv = plan.partition_values[fi] if fi < len(plan.partition_values) \
        else {}
    for c in names:
        if c in parts:
            t = t.append_column(c, pa.array(
                [typed_partition_value(pv, parts[c])] * n,
                T.to_arrow_type(parts[c].dtype)))
        elif c == ND.InputFileName.HIDDEN:
            t = t.append_column(c, pa.array([path] * n, pa.string()))
        elif c in hidden:
            v = os.path.getsize(path) \
                if c == ND.InputFileBlockLength.HIDDEN else 0
            t = t.append_column(c, pa.array(np.full(n, v, np.int64)))
    return t.select(names)


# -- sort --------------------------------------------------------------- #


def _sortable(arr: pa.Array) -> pa.Array:
    """pyarrow sorts NaN beside NULLs; Spark sorts NaN as the greatest
    value.  Doubles become their IEEE total-order int64 keys."""
    if not pa.types.is_floating(arr.type):
        return arr
    v, valid = _np_vals(arr, pa.float64())
    bits = np.where(np.isnan(v), np.int64(0x7FF8000000000000),
                    v.view(np.int64))
    keys = np.where(bits < 0, bits ^ np.int64(2**63 - 1), bits)
    return _from_np(keys, valid, pa.int64())


def _sort_indices(columns: list, orders: list, nulls_last: list) -> pa.Array:
    """Stable indices sorting by the key columns, most significant
    first, each with its own NULL placement (stable passes from the
    least significant key)."""
    n = len(columns[0]) if columns else 0
    idx = np.arange(n)
    for col, order, last in reversed(list(zip(columns, orders,
                                              nulls_last))):
        t = pa.table({"k": col.take(pa.array(idx, pa.int64()))})
        idx = idx[np.asarray(_sort_one(
            t, order, "at_end" if last else "at_start"))]
    return pa.array(idx, pa.int64())


_KEY_PLACEMENT: list = []  # [] unknown; [True] per-key placement works


def _sort_one(t: pa.Table, order: str, placement: str) -> pa.Array:
    """Stable sort indices of column ``k``.  Newer pyarrow takes the NULL
    placement per key (the options-level one is deprecated there);
    older pyarrow only the options-level one: probe once."""
    if not _KEY_PLACEMENT:
        try:
            pc.sort_indices(pa.table({"k": [1]}),
                            sort_keys=[("k", "ascending", "at_end")])
            _KEY_PLACEMENT.append(True)
        except Exception:
            _KEY_PLACEMENT.append(False)
    if _KEY_PLACEMENT[0]:
        return pc.sort_indices(t, sort_keys=[("k", order, placement)])
    return pc.sort_indices(t, sort_keys=[("k", order)],
                           null_placement=placement)


def _sort(plan: L.Sort, child: pa.Table) -> pa.Table:
    if not plan.keys or child.num_rows == 0:
        return child
    cs = plan.children[0].schema
    cols = [_sortable(cpu_eval(bind_references(k.expr, cs), child))
            for k in plan.keys]
    return child.take(_sort_indices(
        cols, ["descending" if k.descending else "ascending"
               for k in plan.keys], [k.nulls_last for k in plan.keys]))


# -- join --------------------------------------------------------------- #


_PA_JOIN = {"inner": "inner", "left_outer": "left outer",
            "right_outer": "right outer", "full_outer": "full outer",
            "left_semi": "left semi", "left_anti": "left anti"}


def _side(t: pa.Table, tag: str, keys: list) -> tuple[pa.Table, list]:
    """A join input: its live columns named ``<tag><position>`` (pyarrow
    joins no column of the NULL type), then the key columns; and the
    live positions."""
    live = [i for i, f in enumerate(t.schema) if not pa.types.is_null(f.type)]
    names = [f"{tag}{i}" for i in live] + [f"__k{j}" for j in range(len(keys))]
    return pa.Table.from_arrays([t.column(i) for i in live] + keys,
                                names=names), live


def _integral_key(a: pa.Array, dt) -> pa.Array:
    """A join key beside a DECIMAL / integral pair as int64: a decimal
    by its integer value where it has no fraction, else NULL."""
    if not isinstance(dt, T.DecimalType):
        return a.cast(pa.int64())
    v, ok = _unscaled(a, dt.scale)
    f = 10 ** dt.scale
    return _from_np(np.floor_divide(v, f), ok & (v % f == 0), pa.int64())


def _join(plan: L.Join, need: Optional[set]) -> pa.Table:
    lp, rp = plan.children
    cond = set() if plan.condition is None else _reads([plan.condition])
    lkeys, rkeys = _reads(plan.left_keys), _reads(plan.right_keys)

    def side_need(child, keys, keep):
        if need is None or cond is None or keys is None:
            return None
        names = set(child.schema.names)
        return keys | (cond & names) | ((need & names) if keep else set())

    jt = plan.join_type
    left = _run(lp, side_need(lp, lkeys, True))
    right = _run(rp, side_need(rp, rkeys,
                               jt not in ("left_semi", "left_anti")))
    if jt == "cross" or not plan.left_keys:  # pairs on a constant
        lk = [pa.array(np.ones(left.num_rows, np.int8))]
        rk = [pa.array(np.ones(right.num_rows, np.int8))]
    else:
        lk, rk = [], []
        for le, re_ in zip(plan.left_keys, plan.right_keys):
            a = cpu_eval(bind_references(le, lp.schema), left)
            b = cpu_eval(bind_references(re_, rp.schema), right)
            ta, tb = T.from_arrow_type(a.type), T.from_arrow_type(b.type)
            if T.decimal_beside_integral(ta, tb):
                # a DECIMAL equals an integer only when it has no
                # fraction: its integer value, else a NULL key
                a, b = _integral_key(a, ta), _integral_key(b, tb)
            elif a.type != b.type:  # compare in the keys' common type
                ct = T.to_arrow_type(T.common_type(ta, tb))
                a, b = a.cast(ct), b.cast(ct)
            lk.append(a)
            rk.append(b)
    lt, llive = _side(left, "l", lk)
    rt, rlive = _side(right, "r", rk)
    keys = [f"__k{j}" for j in range(len(lk))]
    semi = jt in ("left_semi", "left_anti")

    def out(pairs: pa.Table, lrows=None, rrows=None) -> pa.Table:
        """The joined table of ``pairs`` (a side's columns NULL where
        ``pairs`` lacks them), placeholders where a side had them."""
        n = pairs.num_rows
        arrays = []
        for t, live, tag in ((left, llive, "l"), (right, rlive, "r")):
            if semi and tag == "r":
                break
            for i, f in enumerate(t.schema):
                name = f"{tag}{i}"
                if i not in live:
                    arrays.append(None)
                elif name in pairs.column_names:
                    arrays.append(pairs.column(name))
                else:
                    arrays.append(_nulls(n, f.type))
        table = _assemble(arrays, plan.schema, n)
        return table

    if plan.condition is None and jt != "cross":
        res = lt.join(rt, keys=keys, join_type=_PA_JOIN[jt],
                      coalesce_keys=False, right_suffix="__r")
        return out(res)
    # the matching pairs: the keys equal and the condition true; then
    # the rows each join type keeps of the unmatched
    lt = lt.append_column("__lid", pa.array(np.arange(len(lt),
                                                      dtype=np.int64)))
    rt = rt.append_column("__rid", pa.array(np.arange(len(rt),
                                                      dtype=np.int64)))
    pairs = lt.join(rt, keys=keys, join_type="inner", coalesce_keys=False,
                    right_suffix="__r")
    if plan.condition is not None:
        both = T.Schema(list(lp.schema.fields) + list(rp.schema.fields))
        joined = _assemble(
            [pairs.column(f"l{i}") if i in llive else None
             for i in range(left.num_columns)]
            + [pairs.column(f"r{i}") if i in rlive else None
               for i in range(right.num_columns)], both, pairs.num_rows)
        mask = cpu_eval(bind_references(plan.condition, both),
                        joined).cast(pa.bool_())
        pairs = pairs.filter(pc.fill_null(mask, False))
    lhit = np.zeros(len(lt), bool)
    lhit[np.asarray(pairs.column("__lid"))] = True
    if semi:
        keep = lhit if jt == "left_semi" else ~lhit
        return left.filter(pa.array(keep))
    parts = [out(pairs)]
    if jt in ("left_outer", "full_outer"):
        parts.append(out(lt.filter(pa.array(~lhit))))
    if jt in ("right_outer", "full_outer"):
        rhit = np.zeros(len(rt), bool)
        rhit[np.asarray(pairs.column("__rid"))] = True
        parts.append(out(rt.filter(pa.array(~rhit))))
    return pa.concat_tables(parts)


# -- generate ----------------------------------------------------------- #


def _generate(plan: L.Generate, child: pa.Table,
              keep: Optional[set]) -> pa.Table:
    """explode / posexplode: each row once per element of its array (a
    NULL array's elements excluded); with ``outer`` once more for an
    empty or NULL array, its element and pos NULL.  Only the child's
    columns in ``keep`` (None: all) are repeated, the rest placeholders."""
    gen = plan.generator
    starts, lens, arr = _list_parts(cpu_eval(gen.child, child))
    rep = np.maximum(lens, 1) if gen.outer else lens
    parent = np.repeat(np.arange(len(lens)), rep)
    first = np.cumsum(rep) - rep
    pos = np.arange(len(parent)) - first[parent]
    real = pos < lens[parent]
    idx = pa.array(parent, pa.int64())
    arrays = [None if child.schema.field(i).metadata == _PRUNED or (
        keep is not None and child.schema.field(i).name not in keep)
              else child.column(i).take(idx)
              for i in range(child.num_columns)]
    if gen.pos:
        arrays.append(_from_np(pos.astype(np.int32), real, pa.int32()))
    arrays.append(_pick(arr.values, starts[parent] + pos, real,
                        T.to_arrow_type(gen.dtype)))
    return _assemble(arrays, plan.schema, len(parent))


# -- aggregate ---------------------------------------------------------- #


def _agg_input(fn, child: pa.Table) -> pa.Array:
    arr = cpu_eval(fn.inputs()[0], child)
    if isinstance(fn, AG.Sum):
        arr = arr.cast(T.to_arrow_type(fn.partial_dtypes()[0]))
    elif isinstance(fn, AG.Average):
        arr = arr.cast(pa.float64())
    return arr


def _aggregate(plan: L.Aggregate, child: pa.Table) -> pa.Table:
    cs = plan.children[0].schema
    keys = []
    for g in plan.groups:
        arr = cpu_eval(bind_references(g, cs), child)
        if pa.types.is_floating(arr.type):
            # Spark's NormalizeFloatingNumbers: -0.0 groups as 0.0, and
            # every NaN payload as the one NaN
            zero = pa.scalar(0.0, arr.type)
            arr = pc.if_else(pc.fill_null(pc.equal(arr, zero), False),
                             zero, arr)
            arr = pc.if_else(_nan_mask(arr), pa.scalar(float("nan"),
                                                       arr.type), arr)
        keys.append(arr)
    fns = [na.fn.bind(cs) for na in plan.aggs]
    inputs = {j: _agg_input(fn, child)
              for j, fn in enumerate(fns) if fn.inputs()}
    if not keys:
        out = [_grand(fn, inputs.get(j), child.num_rows)
               for j, fn in enumerate(fns)]
        return _assemble([pa.array([v.as_py()], v.type) for v in out],
                         plan.schema, 1)
    names = [f"__g{i}" for i in range(len(keys))]
    src = pa.Table.from_arrays(keys, names=names)
    aggs: list = []
    for j, fn in enumerate(fns):
        for name, arr in _grouped_inputs(fn, j, inputs.get(j), aggs):
            src = src.append_column(name, arr)
    res = src.group_by(names, use_threads=False).aggregate(aggs)
    out = [res.column(g) for g in names]
    out += [_grouped_result(fn, j, res) for j, fn in enumerate(fns)]
    return _assemble(out, plan.schema, res.num_rows)


def _grouped_inputs(fn, j: int, arr, aggs: list) -> list:
    """Append aggregate ``j``'s pyarrow aggregations to ``aggs``; the
    (name, column) inputs they read."""
    col = f"__a{j}"
    if isinstance(fn, AG.CountStar):
        aggs.append(([], "count_all"))
        return []
    if isinstance(fn, (AG.Min, AG.Max)) and pa.types.is_floating(arr.type):
        # Spark: NaN is the greatest double.  Aggregate the values
        # without NaN and a per-group any-NaN flag, then recompose
        nan = _nan_mask(arr)
        aggs += [(f"{col}c", fn.name), (f"{col}n", "any")]
        return [(f"{col}c", pc.if_else(nan, pa.scalar(None, arr.type), arr)),
                (f"{col}n", nan)]
    if isinstance(fn, AG.CollectList):  # CollectSet subclasses it
        aggs.append((col, "list"))
    elif isinstance(fn, AG.Count):
        aggs.append((col, "count"))
    elif isinstance(fn, AG.CountDistinct):
        aggs.append((col, "count_distinct",
                     pc.CountOptions(mode="only_valid")))
    elif isinstance(fn, AG.Average):
        aggs.append((col, "mean"))
    elif isinstance(fn, AG.First):  # Last subclasses First
        # Spark's default keeps NULLs; pyarrow's skips them
        aggs.append((col, _first_last(fn), pc.ScalarAggregateOptions(
            skip_nulls=fn.ignore_nulls, min_count=0)))
    elif isinstance(fn, (AG.Min, AG.Max, AG.Sum)):
        aggs.append((col, fn.name))
    else:
        raise NotImplementedError(f"CPU engine: aggregate {fn.name}")
    return [(col, arr)]


def _first_last(fn) -> str:
    return "last" if isinstance(fn, AG.Last) else "first"


def _grouped_result(fn, j: int, res: pa.Table) -> pa.Array:
    col = f"__a{j}"
    if isinstance(fn, AG.CountStar):
        return res.column("count_all")
    if f"{col}c_{fn.name}" in res.column_names:  # float min / max
        vals = res.column(f"{col}c_{fn.name}")
        anynan = pc.fill_null(res.column(f"{col}n_any"), False)
        nan = pa.scalar(float("nan"), vals.type)
        if isinstance(fn, AG.Max):
            return pc.if_else(anynan, nan, vals)
        return pc.if_else(pc.and_(pc.is_null(vals), anynan), nan, vals)
    if isinstance(fn, AG.CollectList):
        return pa.array([_collected(fn, xs)
                         for xs in res.column(f"{col}_list").to_pylist()],
                        T.to_arrow_type(fn.dtype))
    op = {AG.Count: "count", AG.CountDistinct: "count_distinct",
          AG.Average: "mean"}.get(type(fn))
    if op is None:
        op = _first_last(fn) if isinstance(fn, AG.First) else fn.name
    return res.column(f"{col}_{op}")


def _collected(fn, xs) -> list:
    """A group's collected values: NULLs dropped; a set keeps the first
    of equal values (NaN equals NaN, -0.0 equals 0.0)."""
    xs = [x for x in (xs or []) if x is not None]
    if not isinstance(fn, AG.CollectSet):
        return xs
    kept: list = []
    seen: set = set()
    for x in xs:
        k = _canon(x)
        if k not in seen:  # 0.0 and -0.0 hash and compare alike
            seen.add(k)
            kept.append(x)
    return kept


def _grand(fn, col, num_rows: int) -> pa.Scalar:
    if isinstance(fn, AG.CollectList):
        vals = [] if col is None else col.to_pylist()
        return pa.scalar(_collected(fn, vals), T.to_arrow_type(fn.dtype))
    if isinstance(fn, AG.CountStar):
        return pa.scalar(num_rows, pa.int64())
    if isinstance(fn, AG.Count):
        return pa.scalar(len(col) - col.null_count, pa.int64())
    if isinstance(fn, AG.CountDistinct):
        return pa.scalar(pc.count_distinct(col, mode="only_valid").as_py(),
                         pa.int64())
    if isinstance(fn, AG.Average):
        return pc.mean(col)
    if isinstance(fn, AG.Sum):
        return pc.sum(col)
    if isinstance(fn, AG.First):
        vals = col.drop_null() if fn.ignore_nulls else col
        if len(vals) == 0:
            return pa.scalar(None, col.type)
        return vals[-1] if isinstance(fn, AG.Last) else vals[0]
    if isinstance(fn, (AG.Min, AG.Max)):
        is_min = isinstance(fn, AG.Min)
        nan = _nan_mask(col)
        if nan is None:
            return pc.min(col) if is_min else pc.max(col)
        any_nan = pc.any(nan).as_py()
        clean = pc.if_else(nan, pa.scalar(None, col.type), col)
        v = pc.min(clean) if is_min else pc.max(clean)
        if any_nan and (not is_min or v.as_py() is None):
            return pa.scalar(float("nan"), col.type)
        return v
    raise NotImplementedError(f"CPU engine: aggregate {fn.name}")


# -- window ------------------------------------------------------------- #


def _canon(v):
    """A value as a group or peer key: NULL = NULL, NaN = NaN."""
    if isinstance(v, float) and v != v:
        return ("nan",)
    return v


def _window(plan: L.Window, child: pa.Table) -> pa.Table:
    """Windows by explicit loops over each partition in sorted order:
    slow, and independent of the GPU's segment scans."""
    n = child.num_rows
    named = [(we.bind(plan.children[0].schema), name)
             for we, name in plan.window_exprs]
    spec = named[0][0].spec
    pcols = [_sortable(cpu_eval(e, child)) for e in spec.partition_by]
    ocols = [_sortable(cpu_eval(k.expr, child)) for k in spec.order_by]
    if n and (pcols or ocols):
        order = np.asarray(_sort_indices(
            pcols + ocols,
            ["ascending"] * len(pcols)
            + ["descending" if k.descending else "ascending"
               for k in spec.order_by],
            [False] * len(pcols) + [k.nulls_last for k in spec.order_by]))
    else:
        order = np.arange(n)
    # peers compare raw values: -0.0 = 0.0, NaN = NaN, NULL = NULL
    raw_order = [cpu_eval(k.expr, child).to_pylist() for k in spec.order_by]
    pvals = [cpu_eval(e, child).to_pylist() for e in spec.partition_by]
    pkey = [tuple(_canon(c[i]) for c in pvals) for i in range(n)]
    okey = [tuple(_canon(c[i]) for c in raw_order) for i in range(n)]
    groups: list[list[int]] = []
    for pos, i in enumerate(order):
        if pos == 0 or pkey[i] != pkey[order[pos - 1]]:
            groups.append([])
        groups[-1].append(int(i))
    arrays = [None if f.metadata == _PRUNED else c
              for f, c in zip(child.schema, child.columns)]
    for we, _ in named:
        arrays.append(pa.array(_window_column(we, child, groups, okey,
                                              raw_order, spec, n),
                               T.to_arrow_type(we.dtype)))
    return _assemble(arrays, plan.schema, n)


def _window_column(we, child, groups, okey, raw_order, spec, n) -> list:
    fn = we.fn
    col: list = [None] * n
    vals = cpu_eval(fn.inputs()[0], child).to_pylist() if fn.inputs() \
        else None
    dvals = None
    if isinstance(fn, WX.Lead) and fn.default is not None:
        dvals = cpu_eval(fn.default, child).to_pylist()
    frame = we.spec.resolved_frame()
    for g in groups:
        m = len(g)
        gok = [okey[i] for i in g]
        # the first and last position of each row's peer group
        first = [0] * m
        last = [0] * m
        for p in range(m):
            first[p] = p if p == 0 or gok[p] != gok[p - 1] else first[p - 1]
        for p in range(m - 1, -1, -1):
            last[p] = p if p == m - 1 or gok[p] != gok[p + 1] else last[p + 1]
        dense = 0
        for pos, i in enumerate(g):
            if pos == 0 or gok[pos] != gok[pos - 1]:
                dense += 1
            if isinstance(fn, WX.RowNumber):
                col[i] = pos + 1
            elif isinstance(fn, WX.Rank):
                col[i] = first[pos] + 1
            elif isinstance(fn, WX.DenseRank):
                col[i] = dense
            elif isinstance(fn, WX.Lead):  # Lag subclasses Lead
                j = pos + fn.shift
                if 0 <= j < m:
                    col[i] = vals[g[j]]
                elif dvals is not None:
                    col[i] = dvals[i]
            elif isinstance(fn, WX.WindowAgg):
                lo, hi = _frame_bounds(frame, pos, m, first, last, g,
                                       raw_order, spec)
                col[i] = _frame_agg(fn.agg, vals, g, lo, hi)
            else:
                raise NotImplementedError(
                    f"CPU engine: window function {type(fn).__name__}")
    return col


def _frame_bounds(frame, pos, m, first, last, g, raw_order, spec):
    """The frame of row ``pos`` of a partition as positions [lo, hi]
    (hi < lo: empty)."""
    if frame.mode == "rows":
        lo = 0 if frame.start is None else max(0, pos + frame.start)
        hi = m - 1 if frame.end is None else min(m - 1, pos + frame.end)
        return (lo, hi) if hi >= lo else (0, -1)
    if frame.start is None and frame.end is None:
        return 0, m - 1
    if frame.start in (None, 0) and frame.end in (None, 0):
        lo = 0 if frame.start is None else first[pos]
        hi = m - 1 if frame.end is None else last[pos]
        return lo, hi
    # a bounded RANGE frame over one numeric or date order key: a row
    # is in it when its key is within the offsets of the current key
    # (descending measures the other way); NULL and NaN keys frame
    # their peers only
    key = raw_order[0]
    desc = spec.order_by[0].descending
    v = key[g[pos]]

    def num(x):
        return (x - _EPOCH).days if isinstance(x, _dt.date) else x

    def inside(q):
        u = key[g[q]]
        if v is None or u is None:
            return v is None and u is None
        v_nan = isinstance(v, float) and v != v
        u_nan = isinstance(u, float) and u != u
        if v_nan or u_nan:
            return v_nan and u_nan
        d = (num(u) - num(v)) if not desc else (num(v) - num(u))
        if frame.start is not None and d < frame.start:
            return False
        if frame.end is not None and d > frame.end:
            return False
        return True

    members = [q for q in range(m) if inside(q)]
    return (members[0], members[-1]) if members else (0, -1)


def _frame_agg(agg, vals, g, lo, hi):
    rows = g[lo:hi + 1] if hi >= lo >= 0 else []
    if isinstance(agg, AG.CountStar):
        return len(rows)
    xs = [vals[i] for i in rows if vals[i] is not None]
    if isinstance(agg, AG.Count):
        return len(xs)
    if not xs:
        return None

    def isnan(x):
        return isinstance(x, float) and x != x

    if isinstance(agg, AG.Sum):
        return sum(xs)
    if isinstance(agg, AG.Min):  # NaN counts only when all are NaN
        clean = [x for x in xs if not isnan(x)]
        return min(clean) if clean else float("nan")
    if isinstance(agg, AG.Max):
        return float("nan") if any(isnan(x) for x in xs) else max(xs)
    if isinstance(agg, AG.Average):
        return sum(float(x) for x in xs) / len(xs)
    raise NotImplementedError(f"CPU engine: window aggregate {agg.name}")
