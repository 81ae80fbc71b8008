"""TPC-H lineitem data and the q1/q6 DataFrames.

The port's own copy of ``bench.py``'s ``make_lineitem`` (same seed 42,
columns, distributions and row-group layout), ``q1_dataframe`` and
``q6_dataframe``.  6 files of 2^20 rows is about TPC-H SF1 lineitem.
"""

from __future__ import annotations

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from spark_rapids_tpu_torch.session import (
    avg,
    col,
    count_star,
    lit,
    sum_,
)

ROWS_PER_FILE = 1 << 20
N_FILES = 6


def make_lineitem(dirpath: str, n_files: int = N_FILES,
                  with_q1_cols: bool = False,
                  rows_per_file: int = ROWS_PER_FILE) -> list[str]:
    rng = np.random.default_rng(42)
    paths = []
    for i in range(n_files):
        n = rows_per_file
        cols = {
            "l_quantity": rng.integers(1, 51, n).astype(np.float64),
            # TPC-H spec: l_extendedprice is a 2-decimal money value
            "l_extendedprice": np.round(rng.uniform(900, 105000, n), 2),
            "l_discount": rng.integers(0, 11, n) / 100.0,
            "l_shipdate": rng.integers(8766, 10957, n).astype(np.int32),
        }
        if with_q1_cols:
            cols["l_tax"] = rng.integers(0, 9, n) / 100.0
            cols["l_returnflag"] = np.array(["A", "N", "R"])[
                rng.integers(0, 3, n)]
            cols["l_linestatus"] = np.array(["F", "O"])[
                rng.integers(0, 2, n)]
        p = os.path.join(dirpath, f"lineitem-{i}.parquet")
        pq.write_table(pa.table(cols), p, row_group_size=n)
        paths.append(p)
    return paths


def q6_dataframe(session, paths):
    ship, disc, qty = col("l_shipdate"), col("l_discount"), col("l_quantity")
    price = col("l_extendedprice")
    cond = ((ship >= lit(8766)) & (ship < lit(9131))
            & (disc >= lit(0.05)) & (disc <= lit(0.07))
            & (qty < lit(24.0)))
    return (session.read_parquet(*paths)
            .where(cond)
            .agg((sum_(price * disc), "revenue")))


def q1_dataframe(session, paths):
    qty, price = col("l_quantity"), col("l_extendedprice")
    disc, tax = col("l_discount"), col("l_tax")
    return (session.read_parquet(*paths)
            .where(col("l_shipdate") <= lit(10471))
            .group_by(col("l_returnflag"), col("l_linestatus"))
            .agg((sum_(qty), "sum_qty"),
                 (sum_(price), "sum_base_price"),
                 (sum_(price * (lit(1.0) - disc)), "sum_disc_price"),
                 (sum_(price * (lit(1.0) - disc) * (lit(1.0) + tax)),
                  "sum_charge"),
                 (avg(qty), "avg_qty"),
                 (avg(price), "avg_price"),
                 (avg(disc), "avg_disc"),
                 (count_star(), "count_order")))
