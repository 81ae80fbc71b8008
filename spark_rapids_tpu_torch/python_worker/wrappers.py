"""The pandas functions' worker-side wrappers.

Counterparts of the wrappers in ``spark_rapids_tpu/execs/python_exec.py``
(``execs/python_exec.py`` re-exports them under the same names).  Each
takes the batch the worker received as a pyarrow Table, converts it to
pandas inside the worker, calls the user's function and returns a Table
of the declared Arrow schema ``aschema`` (pandas 3 makes Arrow-backed
strings: ``from_pandas(schema=...)`` casts every column).  They live
here, apart from the execs, so that unpickling one in the worker
imports pandas and pyarrow and no torch.
"""

from __future__ import annotations


def _map_in_pandas_wrapper(tbl, fn=None, aschema=None):
    import pyarrow as pa

    out = fn(tbl.to_pandas())
    return pa.Table.from_pandas(out, schema=aschema, preserve_index=False)


def _grouped_apply_wrapper(tbl, fn=None, key_names=None, aschema=None):
    """applyInPandas: ``fn(group frame) -> frame``, concatenated; no key
    makes the whole table one group."""
    import pandas as pd
    import pyarrow as pa

    df = tbl.to_pandas()
    if df.empty:
        return aschema.empty_table()
    groups = [g for _, g in df.groupby(key_names, dropna=False, sort=False)] \
        if key_names else [df]
    outs = [fn(g.reset_index(drop=True)) for g in groups]
    out = pd.concat(outs, ignore_index=True) if outs else None
    if out is None or out.empty:
        return aschema.empty_table()
    return pa.Table.from_pandas(out, schema=aschema, preserve_index=False)


def _grouped_agg_wrapper(tbl, aggs=None, key_names=None, aschema=None):
    """AggregateInPandas: per group each (output name, fn, input column)
    makes one scalar; the row is the keys and the scalars.  No key: one
    row even over no input (each fn sees an empty Series), as Spark's
    global aggregate."""
    import pandas as pd
    import pyarrow as pa

    df = tbl.to_pandas()
    names = [f.name for f in aschema]
    if not key_names:
        out = pd.DataFrame([{name: fn(df[c]) for name, fn, c in aggs}],
                           columns=names)
        return pa.Table.from_pandas(out, schema=aschema, preserve_index=False)
    if df.empty:
        return aschema.empty_table()
    rows = []
    for key, g in df.groupby(key_names, dropna=False, sort=False):
        row = dict(zip(key_names, key if isinstance(key, tuple) else (key,)))
        for name, fn, c in aggs:
            row[name] = fn(g[c])
        rows.append(row)
    return pa.Table.from_pandas(pd.DataFrame(rows, columns=names),
                                schema=aschema, preserve_index=False)


def _window_in_pandas_wrapper(tbl, fns=None, key_names=None, aschema=None):
    """WindowInPandas over unbounded frames: ``fn(Series) -> scalar``
    given to every row of its group."""
    import pyarrow as pa

    df = tbl.to_pandas()
    if df.empty:
        return aschema.empty_table()
    for name, fn, c in fns:
        df[name] = df.groupby(key_names, dropna=False)[c].transform(fn) \
            if key_names else fn(df[c])
    return pa.Table.from_pandas(df, schema=aschema, preserve_index=False)


def _cogroup_wrapper(tbl, fn=None, left_keys=None, right_keys=None,
                     aschema=None, n_left_cols=None, left_names=None,
                     right_names=None):
    """flatMapCoGroupsInPandas: ``tbl`` holds both sides of a partition
    (``__side`` 0 rows, then 1 rows; the left's columns, then the
    right's), split by slicing in Arrow before ``to_pandas`` so the NULL
    padding never changes a dtype; ``fn(left group, right group)`` for
    each key either side holds, in order of appearance."""
    import pandas as pd
    import pyarrow as pa
    import pyarrow.compute as pc

    n_l = int(pc.sum(pc.equal(tbl["__side"], 0)).as_py() or 0)
    left = tbl.slice(0, n_l).select(
        list(range(1, 1 + n_left_cols))).rename_columns(left_names) \
        .to_pandas()
    right = tbl.slice(n_l).select(
        list(range(1 + n_left_cols, tbl.num_columns))).rename_columns(
            right_names).to_pandas()
    lgroups = dict(iter(left.groupby(left_keys, dropna=False, sort=False)))
    rgroups = dict(iter(right.groupby(right_keys, dropna=False, sort=False)))
    empty_l, empty_r = left.iloc[0:0], right.iloc[0:0]
    outs = [fn(lgroups.get(k, empty_l).reset_index(drop=True),
               rgroups.get(k, empty_r).reset_index(drop=True))
            for k in dict.fromkeys(list(lgroups) + list(rgroups))]
    out = pd.concat(outs, ignore_index=True) if outs else None
    if out is None or out.empty:
        return aschema.empty_table()
    return pa.Table.from_pandas(out, schema=aschema, preserve_index=False)


def cogroup_table(lt, rt):
    """Both sides of a partition in one table: ``__side`` (0 left, 1
    right), then the left's columns as ``__l_<name>``, then the right's
    as ``__r_<name>``, each NULL on the other side's rows."""
    import numpy as np
    import pyarrow as pa

    n_l, n_r = lt.num_rows, rt.num_rows
    arrays = [pa.array(np.concatenate([np.zeros(n_l, np.int8),
                                       np.ones(n_r, np.int8)]))]
    names = ["__side"]
    for i, f in enumerate(lt.schema):
        arrays.append(pa.concat_arrays([lt.column(i).combine_chunks(),
                                        pa.nulls(n_r, f.type)]))
        names.append(f"__l_{f.name}")
    for i, f in enumerate(rt.schema):
        arrays.append(pa.concat_arrays([pa.nulls(n_l, f.type),
                                        rt.column(i).combine_chunks()]))
        names.append(f"__r_{f.name}")
    return pa.Table.from_arrays(arrays, names)
