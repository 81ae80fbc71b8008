"""Row-group pruning by Parquet footer statistics.

Counterpart of ``spark_rapids_tpu/io/pushdown.py``.  Two questions a
row group's footer min/max and null counts can answer before a byte of
it is decoded:

- static pushdown: can any row satisfy every conjunct of the Filter
  pushed into the scan (``row_group_may_match``)?  A comparison of one
  column with a literal is checked against [min, max] (a NaN in the
  literal or the statistics keeps the group, and so does ``>`` / ``>=``
  on a FLOAT or DOUBLE column: NaN rows pass it and the statistics omit
  them, where the JAX function prunes), DATE, TIMESTAMP and DECIMAL
  statistics in the literal's terms (``_in_stat_terms``), IS NULL / IS
  NOT NULL against the null count, anything else keeps the group;
- the runtime filter's [min, max] against the group's key statistics,
  application point 1 of ``plan/runtime_filter.py``.

Pruning is conservative: a group goes only when the statistics prove
that no row of it can pass.  A scan takes only ``pushable_condition``
of a Filter: nothing of a nondeterministic condition (its rows must
reach the device Filter in their places, as Spark keeps such a Filter
above the scan), and, of any other, the conjuncts the planner does not
keep on the device (those reading the hidden input-file columns, and
with ANSI on those that could raise).

Hive partition pruning (``partition_may_match``): a file's partition
values are exact, so a conjunct they violate drops the whole file
before it is opened; a NULL value fails every comparison.
"""

from __future__ import annotations

import datetime
import decimal
import functools
import math
from typing import Callable, Optional, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs import predicates as P


def split_conjuncts(e: B.Expression) -> list[B.Expression]:
    if isinstance(e, P.And):
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def pushable_condition(condition: B.Expression,
                       keep_on_device: Callable[[B.Expression], bool]
                       ) -> Optional[B.Expression]:
    """The part of a Filter's condition a scan may take for footer
    pruning and the host prefilter: None for a nondeterministic
    condition, else the AND of the conjuncts ``keep_on_device`` does not
    keep (None when it keeps them all)."""
    from spark_rapids_tpu_torch.exprs.nondeterministic import (
        tree_is_partition_aware,
    )

    if tree_is_partition_aware(condition):
        return None
    conjuncts = split_conjuncts(condition)
    kept = [c for c in conjuncts if not keep_on_device(c)]
    if len(kept) == len(conjuncts):
        return condition
    return functools.reduce(P.And, kept) if kept else None


def _col_name(e: B.Expression, schema: T.Schema) -> Optional[str]:
    if isinstance(e, B.BoundReference):
        return schema.fields[e.ordinal].name
    if isinstance(e, B.ColumnReference):
        return e.col_name
    return None


def _lit_value(e: B.Expression):
    """A literal's value; a TIMESTAMP literal as ``_TsMicros``, so that
    only a timestamp column's statistics compare with it."""
    if isinstance(e, B.Literal) and e.value is not None:
        if isinstance(e.dtype, T.TimestampType):
            return _TsMicros(B.physical_value(e.value, e.dtype))
        return e.value
    return None


class _TsMicros(int):
    """A TIMESTAMP literal's microseconds since the epoch."""


_FLIP = {P.LessThan: P.GreaterThan, P.LessThanOrEqual: P.GreaterThanOrEqual,
         P.GreaterThan: P.LessThan, P.GreaterThanOrEqual: P.LessThanOrEqual,
         P.EqualTo: P.EqualTo}


def _as_col_op_lit(conj: B.Expression, schema: T.Schema):
    """A conjunct as (column name, comparison class, literal), the
    literal on the right, or None."""
    if type(conj) not in _FLIP:
        return None
    name = _col_name(conj.left, schema)
    v = _lit_value(conj.right)
    if name is not None and v is not None:
        return name, type(conj), v
    name = _col_name(conj.right, schema)
    v = _lit_value(conj.left)
    if name is not None and v is not None:
        return name, _FLIP[type(conj)], v
    return None


def _range_may_match(op, v, lo, hi) -> bool:
    """Whether some x in [lo, hi] may satisfy ``x op v``; True when a
    NaN is anywhere or the values do not compare."""
    try:
        for x in (v, lo, hi):
            if isinstance(x, float) and math.isnan(x):
                return True
        if op in (P.GreaterThan, P.GreaterThanOrEqual) \
                and isinstance(hi, float):
            # NaN sorts above every value (Spark), and Parquet footer
            # statistics leave NaN out: a NaN row may pass whatever the
            # max.  The JAX function prunes here and loses such rows.
            return True
        if op is P.LessThan:
            return lo < v
        if op is P.LessThanOrEqual:
            return lo <= v
        if op is P.GreaterThan:
            return hi > v
        if op is P.GreaterThanOrEqual:
            return hi >= v
        if op is P.EqualTo:
            return lo <= v <= hi
    except TypeError:
        return True
    return True


def row_group_may_match(conjuncts: Sequence[B.Expression],
                        schema: T.Schema, rg_meta) -> bool:
    """False only when the row group's footer statistics prove that no
    row passes every conjunct."""
    stats_by_name = {}
    nrows = rg_meta.num_rows
    for ci in range(rg_meta.num_columns):
        col = rg_meta.column(ci)
        stats_by_name[col.path_in_schema.split(".")[0]] = col.statistics
    for conj in conjuncts:
        if isinstance(conj, (P.IsNull, P.IsNotNull)):
            st = stats_by_name.get(_col_name(conj.child, schema))
            if st is None or st.null_count is None:
                continue
            if isinstance(conj, P.IsNull) and st.null_count == 0:
                return False
            if isinstance(conj, P.IsNotNull) and st.null_count >= nrows:
                return False
            continue
        norm = _as_col_op_lit(conj, schema)
        if norm is None:
            continue
        name, op, v = norm
        st = stats_by_name.get(name)
        if st is None or not st.has_min_max:
            continue
        coerced = _in_stat_terms(v, st.min, st.max)
        if coerced is None:
            continue
        if not _range_may_match(op, *coerced):
            return False
        # a comparison is never true of a NULL
        if st.null_count is not None and st.null_count >= nrows:
            return False
    return True


def _coerce_like(v, stat_sample):
    """A literal in the statistics' representation: pyarrow gives a
    DATE column's min/max as ``datetime.date``, the engine's date
    literals are epoch days."""
    if isinstance(stat_sample, datetime.date) \
            and not isinstance(stat_sample, datetime.datetime) \
            and isinstance(v, int) and not isinstance(v, _TsMicros):
        return datetime.date(1970, 1, 1) + datetime.timedelta(days=v)
    return v


def _in_stat_terms(v, lo, hi):
    """(literal, min, max) in one representation, as the device compares
    them; None when they do not compare (the group is kept):

    - a DATE column's statistics against epoch days (``_coerce_like``);
    - a TIMESTAMP column's come as ``datetime.datetime``: both sides in
      microseconds, and only against a TIMESTAMP literal;
    - a DECIMAL column's come as ``Decimal``: against a floating literal
      the device compares the decimal converted to double, a monotone
      rounding, so the statistics are rounded the same way; against an
      integer or a decimal literal the comparison is exact."""
    if isinstance(lo, datetime.datetime):
        if not isinstance(v, _TsMicros):
            return None
        return int(v), _stat_to_int(lo), _stat_to_int(hi)
    if isinstance(v, _TsMicros):
        return None
    if isinstance(lo, decimal.Decimal) and isinstance(v, float):
        return v, float(lo), float(hi)
    return _coerce_like(v, lo), lo, hi


def _stat_to_int(v) -> Optional[int]:
    """A footer statistic -> the engine's integer key (epoch days for a
    date); None when it does not convert (the row group is kept)."""
    if isinstance(v, bool):
        return None
    if isinstance(v, int):
        return v
    if isinstance(v, datetime.datetime):
        # exact integer microseconds: total_seconds() as a float rounds
        # at ~0.25 us, enough to shift a boundary and prune wrongly
        d = v - datetime.datetime(1970, 1, 1, tzinfo=v.tzinfo)
        return (d.days * 86_400_000_000 + d.seconds * 1_000_000
                + d.microseconds)
    if isinstance(v, datetime.date):
        return (v - datetime.date(1970, 1, 1)).days
    return None


def runtime_range_may_match(name: str, rf, rg_meta) -> bool:
    """False only when the row group's statistics prove that no key of
    column ``name`` falls in the filter's [min, max], or the build side
    was empty."""
    if not rf.range_may_match(None, None):
        return False  # the build side was empty
    st = None
    for ci in range(rg_meta.num_columns):
        col = rg_meta.column(ci)
        if col.path_in_schema.split(".")[0] == name:
            st = col.statistics
            break
    if st is None or not st.has_min_max:
        return True
    lo, hi = _stat_to_int(st.min), _stat_to_int(st.max)
    if lo is None or hi is None:
        return True
    return rf.range_may_match(lo, hi)


def partition_may_match(conjuncts: Sequence[B.Expression],
                        schema: T.Schema, part_values: dict,
                        part_fields: Sequence[T.Field]) -> bool:
    """False when the file's partition values (``part_values``, by
    name, as strings; None for NULL) violate a conjunct: IS NULL, IS
    NOT NULL, or a comparison of a partition column with a literal
    (JAX ``partition_may_match``)."""
    typed = {f.name: typed_partition_value(part_values, f)
             for f in part_fields}
    for conj in conjuncts:
        if isinstance(conj, (P.IsNull, P.IsNotNull)):
            name = _col_name(conj.child, schema)
            if name in typed and (typed[name] is None) \
                    != isinstance(conj, P.IsNull):
                return False
            continue
        norm = _as_col_op_lit(conj, schema)
        if norm is None or norm[0] not in typed:
            continue
        name, op, v = norm
        pv = typed[name]
        if pv is None:
            return False  # a comparison is never true of a NULL
        if not _range_may_match(op, v, pv, pv):
            return False
    return True


def typed_partition_value(part_values: dict, f: T.Field):
    """The value of partition field ``f`` in a file's ``part_values``
    (strings by name): an int for a LONG field, a str, or None."""
    v = part_values.get(f.name)
    if v is not None and isinstance(f.dtype, T.LongType):
        v = int(v)
    return v
