"""User functions for the Python exec tests of both packages.

They are pickled by reference into the worker children, which import
this module: it imports neither torch nor JAX, so a child that runs one
of them shows what the worker itself imports.
"""

import os
import sys

import pyarrow as pa
import pyarrow.compute as pc


def double_v(tbl: pa.Table) -> pa.Table:
    return tbl.set_column(tbl.schema.get_field_index("v"), "v",
                          pc.multiply(tbl.column("v"), 2.0))


def raises_on_negative(tbl: pa.Table) -> pa.Table:
    if pc.min(tbl.column("v")).as_py() < 0:
        raise ValueError("negative input")
    return tbl


def grow_rows(tbl: pa.Table) -> pa.Table:
    return pa.concat_tables([tbl, tbl])


def child_facts(tbl: pa.Table) -> pa.Table:
    """What the worker child imported and sees."""
    return pa.table({
        "torch": [any(m == "torch" or m.startswith("torch.")
                      for m in sys.modules)],
        "jax": [any(m == "jax" or m.startswith("jax.")
                    for m in sys.modules)],
        "cuda_visible": [os.environ.get("CUDA_VISIBLE_DEVICES")],
        "pid": [os.getpid()]})


def double_frame(df):
    df = df.copy()
    df["v"] = df["v"] * 2
    return df


def group_summary(g):
    import pandas as pd

    return pd.DataFrame({"k": [g["k"].iloc[0]], "total": [g["v"].sum()],
                         "n": [len(g)]})


def span(s):
    return float(s.max() - s.min())


def mean(s):
    return float(s.mean())


def failing(df):
    raise ValueError("user code exploded")


def cogroup_merge(gl, gr):
    import pandas as pd

    k = gl["k"].iloc[0] if len(gl) else gr["k"].iloc[0]
    return pd.DataFrame({
        "k": [k], "nl": [len(gl)], "nr": [len(gr)],
        "sum_both": [float((gl["v"].sum() if len(gl) else 0)
                           + (gr["w"].sum() if len(gr) else 0))]})


def cg_diffkeys(gl, gr):
    import pandas as pd

    k = gl["id"].iloc[0] if len(gl) else gr["rid"].iloc[0]
    return pd.DataFrame({"id": [k], "nl": [len(gl)], "nr": [len(gr)]})


def double_w(tbl: pa.Table) -> pa.Table:
    return tbl.set_column(tbl.schema.get_field_index("w"), "w",
                          pc.multiply(tbl.column("w"), 2.0))


def count_sides(left, right):
    """A cogroup's key (each side's first column) and its rows a side."""
    import pandas as pd

    k = left.iloc[0, 0] if len(left) else right.iloc[0, 0]
    return pd.DataFrame({"k": [k], "nl": [len(left)], "nr": [len(right)]})
