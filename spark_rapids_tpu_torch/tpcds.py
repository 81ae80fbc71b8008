"""TPC-DS store_sales data and the q67 DataFrame.

The port's own copy of ``bench.py``'s ``make_store_sales`` (the same
``default_rng(67)`` stream, columns, draw order and row-group layout,
so the tables come out identical) and ``q67_dataframe``: BASELINE
config #4, a grouped aggregate, a rank window partitioned by store, a
rank filter and an ordered output.  6 files of 2^20 rows (~6.3 M rows)
is about TPC-DS SF2's 5.76 M store_sales rows.
"""

from __future__ import annotations

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from spark_rapids_tpu_torch.exprs.window import Window, rank
from spark_rapids_tpu_torch.session import col, lit, sum_


def make_store_sales(dirpath: str, n_rows: int = 1 << 21,
                     n_files: int = 2) -> list[str]:
    rng = np.random.default_rng(67)
    per = n_rows // n_files
    paths = []
    for i in range(n_files):
        t = pa.table({
            "ss_store_sk": rng.integers(1, 9, per),
            "ss_item_sk": rng.integers(1, 2000, per),
            "ss_quantity": rng.integers(1, 20, per).astype(np.float64),
            "ss_sales_price": np.round(rng.uniform(1, 300, per), 2),
        })
        p = os.path.join(dirpath, f"ss-{i}.parquet")
        pq.write_table(t, p, row_group_size=per)
        paths.append(p)
    return paths


def q67_dataframe(session, paths):
    """Sales per (store, item), ranked within each store by sales,
    descending; the top 10 of every store, ordered by (store, rank,
    item)."""
    agg = (session.read_parquet(*paths)
           .group_by(col("ss_store_sk"), col("ss_item_sk"))
           .agg((sum_(col("ss_sales_price") * col("ss_quantity")),
                 "sumsales")))
    spec = Window.partition_by("ss_store_sk").order_by(
        "sumsales", desc=True)
    ranked = agg.select(col("ss_store_sk"), col("ss_item_sk"),
                        col("sumsales"),
                        rank().over(spec).alias("rk"))
    return (ranked.where(col("rk") <= lit(10))
            .order_by(col("ss_store_sk"), col("rk"), col("ss_item_sk")))
