"""Row-group pruning by Parquet footer statistics.

Counterpart of the runtime-filter part of
``spark_rapids_tpu/io/pushdown.py``: a runtime filter's [min, max]
against a row group's footer min/max, application point 1 of
``plan/runtime_filter.py`` (a pruned row group is never decoded).  The
JAX module's static predicate pushdown (a Filter's conjuncts against
the same statistics) is not ported.
"""

from __future__ import annotations

import datetime
from typing import Optional


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
