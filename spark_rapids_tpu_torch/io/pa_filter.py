"""Host-side row masks over decoded Arrow columns.

Counterpart of ``spark_rapids_tpu/io/pa_filter.py``:

- ``compile_filter``: a pushed Filter's condition as a function of a
  decoded table, in ``pyarrow.compute`` (C++ kernels that release the
  GIL), for the scan's host prefilter (``io/scan.py``) and the
  decoder's per-dictionary evaluation (``io/fastpar.py``).  Column
  references (bound), literals, comparisons, AND / OR / NOT, IS NULL
  and IS NOT NULL compile; anything else returns None and the caller
  uses ``cpu/engine.py::cpu_eval``.  A comparison with a floating
  operand follows Spark's total order (``_float_cmp``): NaN equals NaN
  and sorts above every value, as the device Filter has it, so no NaN
  row is lost on the host.  Two TIMESTAMPs, or two DECIMALs of one
  type, compare their int64 values (``_int64_cmp``); a TIMESTAMP or a
  DECIMAL against another type does not compile.  NULL slots of a
  result count as false;
- application point 3 of ``plan/runtime_filter.py``: a runtime join
  filter's keep-mask over a decoded key column, computed before the
  batch is uploaded.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from spark_rapids_tpu_torch.columnar.arrow import US_PER_UNIT, fixed_view
from spark_rapids_tpu_torch.exprs import base as B


class _Unsupported(Exception):
    pass


def compile_filter(e) -> Optional[Callable]:
    """A bound expression -> (table -> pyarrow boolean array), or None
    when some part of it does not compile."""
    try:
        return _compile(e)
    except _Unsupported:
        return None


_CMP = {
    "GreaterThan": pc.greater,
    "GreaterThanOrEqual": pc.greater_equal,
    "LessThan": pc.less,
    "LessThanOrEqual": pc.less_equal,
    "EqualTo": pc.equal,
    "NotEqual": pc.not_equal,
}
_FLOATING = ("FloatType", "DoubleType")
#: types compared by their int64 physical values on the host
_INT64_BACKED = ("TimestampType", "DecimalType")


def _compile(e) -> Callable:  # noqa: C901 - one branch a class
    name = type(e).__name__
    if isinstance(e, B.BoundReference):
        i = e.ordinal
        return lambda t: t.column(i)
    if isinstance(e, B.Literal):
        v = e.value
        return lambda t: v
    kids = list(e.children)
    if name in _CMP:
        if len(kids) != 2:
            raise _Unsupported
        lf, rf = _compile(kids[0]), _compile(kids[1])
        if any(type(k.dtype).__name__ in _INT64_BACKED for k in kids):
            return _int64_cmp(name, kids)
        if any(type(k.dtype).__name__ in _FLOATING for k in kids):
            return _float_cmp(name, lf, rf)
        op = _CMP[name]
        return lambda t: op(lf(t), rf(t))
    if name in ("And", "Or"):
        lf, rf = _compile(kids[0]), _compile(kids[1])
        op = pc.and_kleene if name == "And" else pc.or_kleene
        return lambda t: op(lf(t), rf(t))
    if name == "Not":
        kf = _compile(kids[0])
        return lambda t: pc.invert(kf(t))
    if name in ("IsNull", "IsNotNull"):
        kf = _compile(kids[0])
        op = pc.is_null if name == "IsNull" else pc.is_valid
        return lambda t: op(kf(t))
    # ``In`` keeps its list as plain values, not Literal children: it
    # does not compile, as in the JAX package
    raise _Unsupported


def _int64_cmp(name: str, kids) -> Callable:
    """A comparison of TIMESTAMPs or of DECIMALs of one type, as the
    device compares them: their int64 values (microseconds, unscaled
    digits).  Operands of two types would compare in a common type,
    and do not compile."""
    if kids[0].dtype != kids[1].dtype or name not in _NP_CMP:
        raise _Unsupported

    def side(k):
        if isinstance(k, B.Literal):
            v = B.physical_value(k.value, k.dtype)
            return lambda t: (v, k.value is not None)
        if not isinstance(k, B.BoundReference):
            raise _Unsupported
        i = k.ordinal

        def fn(t):
            col = t.column(i)
            col = col.combine_chunks() if isinstance(
                col, pa.ChunkedArray) else col
            if pa.types.is_dictionary(col.type):
                col = col.dictionary_decode()
            vals, valid = _physical_int64(col)
            return vals, True if valid is None else valid
        return fn

    lf, rf = side(kids[0]), side(kids[1])
    op = _NP_CMP[name]

    def fn(t):
        (lv, lok), (rv, rok) = lf(t), rf(t)
        valid = np.logical_and(lok, rok)
        out = np.asarray(op(lv, rv), bool)
        out = np.broadcast_to(out, (t.num_rows,))
        valid = np.broadcast_to(valid, (t.num_rows,))
        return pa.array(out, pa.bool_(), mask=~valid)

    return fn


_NP_CMP = {
    "GreaterThan": np.greater,
    "GreaterThanOrEqual": np.greater_equal,
    "LessThan": np.less,
    "LessThanOrEqual": np.less_equal,
    "EqualTo": np.equal,
    "NotEqual": np.not_equal,
}


def _physical_int64(arr) -> tuple:
    """(int64 values, validity or None) of a TIMESTAMP (microseconds)
    or DECIMAL (unscaled) array."""
    if pa.types.is_decimal(arr.type):
        vals = np.array(fixed_view(arr), np.int64)
        valid = np.asarray(pc.is_valid(arr)) if arr.null_count else None
        return vals, valid
    return _int64_values(arr)


def _float_cmp(name: str, lf: Callable, rf: Callable) -> Callable:
    """A comparison in Spark's float order: NaN == NaN, NaN above all."""

    def nan(x):
        try:
            return pc.is_nan(x)
        except Exception:
            return False  # an integer operand is never NaN

    def fn(t):
        l, r = lf(t), rf(t)
        ln, rn = nan(l), nan(r)
        eq = pc.or_kleene(pc.equal(l, r), pc.and_kleene(ln, rn)) \
            if ln is not False and rn is not False else pc.equal(l, r)
        lt = pc.less(l, r)
        if rn is not False:
            not_ln = pc.invert(ln) if ln is not False else True
            lt = pc.or_kleene(lt, pc.and_kleene(not_ln, rn)
                              if not_ln is not True else rn)
        if name == "EqualTo":
            return eq
        if name == "NotEqual":
            return pc.invert(eq)
        if name == "LessThan":
            return lt
        if name == "LessThanOrEqual":
            return pc.or_kleene(lt, eq)
        if name == "GreaterThan":
            return pc.invert(pc.or_kleene(lt, eq))
        return pc.invert(lt)  # GreaterThanOrEqual

    return fn


def _int64_values(arr) -> Optional[tuple]:
    """An Arrow array -> (int64 values, bool validity, or None when it
    has no NULL) in the engine's integer key representation (epoch days
    for a date, microseconds for a timestamp); None for any other type.
    The values are read straight from the data buffer, so a NULL slot
    holds whatever is there: its validity drops it."""
    t = arr.type
    if pa.types.is_date32(t):
        t = pa.int32()
    elif pa.types.is_timestamp(t):
        t = pa.int64()
    elif not pa.types.is_signed_integer(t):
        return None
    width = t.bit_width // 8
    if len(arr) == 0:
        return np.zeros(0, np.int64), None
    vals = np.frombuffer(arr.buffers()[1], np.dtype(f"<i{width}"),
                         count=len(arr), offset=arr.offset * width)
    valid = np.asarray(pc.is_valid(arr)) if arr.null_count else None
    if pa.types.is_timestamp(arr.type):  # to microseconds
        if arr.type.unit == "ns":
            return np.floor_divide(vals, 1000), valid
        return vals * US_PER_UNIT[arr.type.unit], valid
    return vals.astype(np.int64, copy=False), valid


def runtime_filter_column_mask(col, rf) -> Optional[np.ndarray]:
    """The filter's bool keep-mask over one column, or None when the
    column is outside the probe's scope (the filter is then skipped:
    pruning never decides a result).  A dictionary column probes its
    dictionary once and gathers by code."""
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    if pa.types.is_dictionary(col.type):
        dv = _int64_values(col.dictionary)
        if dv is None:
            return None
        lut = rf.probe_host(dv[0], dv[1])
        if len(lut) == 0:  # no dictionary: every row is NULL
            return np.full(len(col), not rf.ready)
        codes = col.indices
        code_valid = np.asarray(pc.is_valid(codes))
        code_vals = np.asarray(codes.fill_null(0)).astype(np.int64)
        return np.where(code_valid, lut[code_vals], False)
    v = _int64_values(col)
    if v is None:
        return None
    return rf.probe_host(v[0], v[1])
