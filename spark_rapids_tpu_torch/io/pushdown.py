"""Row-group pruning by Parquet footer statistics.

Counterpart of ``spark_rapids_tpu/io/pushdown.py``.  Two questions a
row group's footer min/max and null counts can answer before a byte of
it is decoded:

- static pushdown: can any row satisfy every conjunct of the Filter
  pushed into the scan (``row_group_may_match``)?  A comparison of one
  column with a literal is checked against [min, max] (a NaN in the
  literal or the statistics keeps the group, and so does ``>`` / ``>=``
  on a floating column: NaN rows pass it and the statistics omit them,
  where the JAX function prunes), IS NULL / IS NOT NULL against the
  null count, anything else keeps the group;
- the runtime filter's [min, max] against the group's key statistics,
  application point 1 of ``plan/runtime_filter.py``.

Pruning is conservative: a group goes only when the statistics prove
that no row of it can pass.  Hive partition pruning
(``partition_may_match``) is not ported: the port reads no partitioned
directories.
"""

from __future__ import annotations

import datetime
import math
from typing import Optional, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs import predicates as P


def split_conjuncts(e: B.Expression) -> list[B.Expression]:
    if isinstance(e, P.And):
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def _col_name(e: B.Expression, schema: T.Schema) -> Optional[str]:
    if isinstance(e, B.BoundReference):
        return schema.fields[e.ordinal].name
    if isinstance(e, B.ColumnReference):
        return e.col_name
    return None


def _lit_value(e: B.Expression):
    if isinstance(e, B.Literal) and e.value is not None:
        return e.value
    return None


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
        v = _coerce_like(v, st.min)
        if not _range_may_match(op, v, st.min, st.max):
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
            and isinstance(v, int):
        return datetime.date(1970, 1, 1) + datetime.timedelta(days=v)
    return v


def _stat_to_int(v) -> Optional[int]:
    """A footer statistic -> the engine's integer key (epoch days for a
    date); None when it does not convert (the row group is kept)."""
    if isinstance(v, bool):
        return None
    if isinstance(v, int):
        return v
    if isinstance(v, datetime.datetime):
        return None  # the port has no timestamp type
    if isinstance(v, datetime.date):
        return (v - datetime.date(1970, 1, 1)).days
    return None


def runtime_range_may_match(name: str, rf, rg_meta) -> bool:
    """False only when the row group's statistics prove that no key of
    column ``name`` falls in the filter's [min, max], or the build side
    was empty."""
    if not rf.ready:
        return True
    if rf.n_keys == 0:
        return False
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
