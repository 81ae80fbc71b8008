"""TPC-H lineitem and orders data and the q1, q6 and q3 DataFrames.

The port's own copy of ``bench.py``'s ``make_lineitem`` (same seed 42,
columns, distributions, draw order and row-group layout),
``make_orders`` (seed 7), ``q1_dataframe``, ``q6_dataframe`` and
``q3_dataframe``.  6 files of 2^20 rows is about TPC-H SF1 lineitem;
2^20 orders is about SF1's 1.5 M.
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
N_ORDERS = 1 << 20


def make_lineitem(dirpath: str, n_files: int = N_FILES,
                  with_q1_cols: bool = False, with_orderkey: bool = False,
                  n_orders: int = N_ORDERS,
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
        if with_orderkey:
            cols["l_orderkey"] = rng.integers(0, n_orders, n).astype(
                np.int64)
        p = os.path.join(dirpath, f"lineitem-{i}.parquet")
        pq.write_table(pa.table(cols), p, row_group_size=n)
        paths.append(p)
    return paths


def make_orders(dirpath: str, n_orders: int = N_ORDERS) -> str:
    rng = np.random.default_rng(7)
    t = pa.table({
        "o_orderkey": np.arange(n_orders, dtype=np.int64),
        "o_orderdate": rng.integers(8766, 10957, n_orders).astype(np.int32),
        "o_shippriority": rng.integers(0, 5, n_orders).astype(np.int32),
    })
    p = os.path.join(dirpath, "orders.parquet")
    pq.write_table(t, p, row_group_size=n_orders)
    return p


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


def q3_dataframe(session, li_paths, orders_path):
    """TPC-H q3's shape on two tables: lineitem JOIN orders on the order
    key, a date filter on each side, revenue per order, the top 10 by
    revenue."""
    li = (session.read_parquet(*li_paths)
          .where(col("l_shipdate") > lit(9500)))
    orders = (session.read_parquet(orders_path)
              .where(col("o_orderdate") < lit(9500)))
    joined = li.join(orders, left_on=[col("l_orderkey")],
                     right_on=[col("o_orderkey")])
    rev = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    return (joined
            .group_by(col("l_orderkey"), col("o_orderdate"),
                      col("o_shippriority"))
            .agg((sum_(rev), "revenue"))
            .order_by(col("revenue"), desc=True)
            .limit(10))
