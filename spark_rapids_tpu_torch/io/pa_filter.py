"""Host-side row masks over decoded Arrow columns.

Counterpart of the runtime-filter part of
``spark_rapids_tpu/io/pa_filter.py``: application point 3 of
``plan/runtime_filter.py``, a keep-mask over a decoded key column,
computed before the batch is uploaded.  The JAX module's compiled
pushed-predicate prefilter is not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc


def _int64_values(arr) -> Optional[tuple]:
    """An Arrow array -> (int64 values, bool validity, or None when it
    has no NULL) in the engine's integer key representation (epoch days
    for a date); None for any other type.  The values are read straight
    from the data buffer, so a NULL slot holds whatever is there: its
    validity drops it."""
    t = arr.type
    if pa.types.is_date32(t):
        t = pa.int32()
    elif not pa.types.is_signed_integer(t):
        return None
    width = t.bit_width // 8
    if len(arr) == 0:
        return np.zeros(0, np.int64), None
    vals = np.frombuffer(arr.buffers()[1], np.dtype(f"<i{width}"),
                         count=len(arr), offset=arr.offset * width)
    valid = np.asarray(pc.is_valid(arr)) if arr.null_count else None
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
