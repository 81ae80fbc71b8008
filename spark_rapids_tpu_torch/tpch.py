"""TPC-H lineitem and orders data and the q1, q6 and q3 DataFrames.

The port's own copy of ``bench.py``'s ``make_lineitem`` (same seed 42,
columns, distributions, draw order and row-group layout),
``make_orders`` (seed 7), ``q1_dataframe``, ``q6_dataframe`` and
``q3_dataframe``.  6 files of 2^20 rows is about TPC-H SF1 lineitem;
2^20 orders is about SF1's 1.5 M.  ``q6_substrait`` and
``q1_substrait`` are q6 and q1 as Substrait plans over a table named
``lineitem`` of ``make_lineitem(with_q1_cols=True)``'s columns, for
``frontends/substrait.py``: the same expressions as the DataFrames',
q1's ``count_order`` a count of ``l_quantity`` (never NULL here).
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


def _sel(i: int) -> dict:
    return {"selection": {"directReference": {"structField": {"field": i}}}}


def _fn(anchor: int, *args) -> dict:
    return {"scalarFunction": {"functionReference": anchor,
                               "arguments": [{"value": a} for a in args]}}


def _plan(fns: list[str], names: list[str], rel: dict) -> dict:
    return {"extensions": [{"extensionFunction": {"functionAnchor": i,
                                                  "name": n}}
                           for i, n in enumerate(fns, start=1)],
            "relations": [{"root": {"names": names, "input": rel}}]}


#: lineitem's columns as ``make_lineitem(with_q1_cols=True)`` writes them
_QTY, _PRICE, _DISC, _SHIP, _TAX, _FLAG, _STATUS = range(7)
_READ = {"read": {"namedTable": {"names": ["lineitem"]}}}


def q6_substrait() -> dict:
    """q6: filter, ``l_extendedprice * l_discount``, its sum."""
    gte, lt, lte, and_, mul, sum_fn = range(1, 7)
    cond = _fn(and_,
               _fn(gte, _sel(_SHIP), {"literal": {"i32": 8766}}),
               _fn(lt, _sel(_SHIP), {"literal": {"i32": 9131}}),
               _fn(gte, _sel(_DISC), {"literal": {"fp64": 0.05}}),
               _fn(lte, _sel(_DISC), {"literal": {"fp64": 0.07}}),
               _fn(lt, _sel(_QTY), {"literal": {"fp64": 24.0}}))
    return _plan(
        ["gte:i32_i32", "lt:i32_i32", "lte:fp64_fp64", "and:bool",
         "multiply:fp64_fp64", "sum:fp64"], ["revenue"],
        {"aggregate": {
            "input": {"project": {
                "common": {"emit": {"outputMapping": [7]}},
                "input": {"filter": {"input": _READ, "condition": cond}},
                "expressions": [_fn(mul, _sel(_PRICE), _sel(_DISC))]}},
            "groupings": [],
            "measures": [{"measure": {"functionReference": sum_fn,
                                      "arguments": [{"value": _sel(0)}]}}],
        }})


def q1_substrait() -> dict:
    """q1: the ship-date filter, the discounted price and the charge,
    then eight measures by (``l_returnflag``, ``l_linestatus``)."""
    lte, mul, sub, add, sum_fn, avg_fn, count_fn = range(1, 8)
    one = {"literal": {"fp64": 1.0}}
    disc_price = _fn(mul, _sel(_PRICE), _fn(sub, one, _sel(_DISC)))
    charge = _fn(mul, disc_price, _fn(add, one, _sel(_TAX)))
    # the project's output: the 7 columns, disc_price (7), charge (8)
    emit = [_FLAG, _STATUS, _QTY, _PRICE, 7, 8, _DISC]
    measures = [(sum_fn, 2), (sum_fn, 3), (sum_fn, 4), (sum_fn, 5),
                (avg_fn, 2), (avg_fn, 3), (avg_fn, 6), (count_fn, 2)]
    return _plan(
        ["lte:i32_i32", "multiply:fp64_fp64", "subtract:fp64_fp64",
         "add:fp64_fp64", "sum:fp64", "avg:fp64", "count:any"],
        ["l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
         "sum_disc_price", "sum_charge", "avg_qty", "avg_price", "avg_disc",
         "count_order"],
        {"aggregate": {
            "input": {"project": {
                "common": {"emit": {"outputMapping": emit}},
                "input": {"filter": {"input": _READ, "condition": _fn(
                    lte, _sel(_SHIP), {"literal": {"i32": 10471}})}},
                "expressions": [disc_price, charge]}},
            "groupings": [{"groupingExpressions": [_sel(0), _sel(1)]}],
            "measures": [{"measure": {"functionReference": f,
                                      "arguments": [{"value": _sel(i)}]}}
                         for f, i in measures],
        }})
