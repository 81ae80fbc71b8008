"""TPC-DS data and the q67, q3, q42, q52, q55, q93, q5 and q27
DataFrames.

- q67: the port's own copy of ``bench.py``'s ``make_store_sales`` (the
  same ``default_rng(67)`` stream, columns, draw order and row-group
  layout, so the tables come out identical) and ``q67_dataframe``:
  BASELINE config #4, a grouped aggregate, a rank window partitioned
  by store, a rank filter and an ordered output.
- q3: the star join of TPC-DS q3 over date_dim, store_sales and item,
  from the port's own copy of the column formulas of the JAX package's
  mini catalog (``tools/tpcds_schema.py``), written with numpy
  vectorised over the rows.  ``make_date_dim(first, last)`` and
  ``make_item(rng, n)`` reproduce that catalog's ``_date_dim()`` and
  ``_item(rng, n)`` exactly (over 1998-2003, and for the same rng
  state); ``make_catalog_store_sales`` writes its 23 store_sales columns
  with foreign keys in the ranges of the spec's SF1 dimension counts
  (``SF1_ROWS``).  ``write_q3_tables`` lays out the spec's whole
  calendar (1900-01-02 to 2100-01-01), 18 000 items and the given
  store_sales files.
- q42, q52, q55: the same star join over the same three tables, with
  other filters, group keys (``i_category``, ``i_brand``: STRING keys
  of the aggregate's exchange) and orders.
- q93: store_sales LEFT OUTER JOIN store_returns on (item, ticket),
  joined to the return reason "Did not like the model", the CASE of the
  net sale per row summed by customer.  ``make_reason(n)`` copies the
  catalog's ``_reason(n)``; ``store_returns_table`` its store_returns
  formulas (each return copies the keys of a store_sales row drawn with
  replacement), gathered by one vectorised take; ``write_q93_tables``
  derives store_returns from store_sales files already written, at the
  spec's SF1 ratio of returns to sales.

- q67 as written (``q67_rollup_dataframe``, the text of the JAX
  package's ``QUERIES[67]``): store_sales x date_dim x store x item,
  one year of months, the sales ROLLUP over eight keys (nine grouping
  sets), ranked within each category; the first 100 rows in the text's
  order.  ``q67_dataframe`` stays the bench shape.
- q5 (``q5_dataframe``): UNION ALL of store_sales and store_returns,
  two weeks of dates and the stores, summed by store.
- q27 (``q27_dataframe``): store_sales x customer_demographics x
  date_dim x store x item, averaged over the GROUPING SETS ((item,
  state), (item), ()).  Its states and demographic values are
  parameters: the text's ('TN') matches none of the catalog's stores,
  whose states are the first eight of ``_STATES``.
- ``make_store(rng, n)`` and ``make_customer_demographics(rng, n)``
  copy the catalog's ``_store`` and ``_customer_demographics``, drawing
  in their order.

6 files of 2^20 store_sales rows (~6.3 M rows) is about TPC-DS SF2's
5.76 M.
"""

from __future__ import annotations

import datetime as dt
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.execs.sort import SortKey
from spark_rapids_tpu_torch.exprs.base import Literal
from spark_rapids_tpu_torch.exprs.predicates import CaseWhen, Coalesce, In
from spark_rapids_tpu_torch.exprs.window import Window, rank
from spark_rapids_tpu_torch.session import avg, col, lit, sum_

#: 1998-01-01 as a date_dim surrogate key: its Julian day number
DATE_SK_EPOCH = 2450815
_D0 = dt.date(1998, 1, 1)
_EPOCH = dt.date(1970, 1, 1)
#: the spec's date_dim: every day from 1900-01-02 to 2100-01-01
CALENDAR = (dt.date(1900, 1, 2), dt.date(2100, 1, 1))
#: the spec's SF1 row counts of the dimensions store_sales points into
SF1_ROWS = {"item": 18_000, "customer": 100_000,
            "customer_demographics": 1_920_800,
            "household_demographics": 7_200, "customer_address": 50_000,
            "store": 12, "promotion": 300, "time_dim": 86_400}

_CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
               "Men", "Music", "Shoes", "Sports", "Women"]
_CLASSES = ["accent", "bedding", "classical", "dresses", "fiction",
            "fragrances", "mens watch", "pants", "pop", "romance",
            "school-uniforms", "shirts"]
_COLORS = ["aquamarine", "azure", "beige", "black", "blue", "brown",
           "chocolate", "coral", "cream", "cyan", "gold", "green",
           "indigo", "ivory", "khaki", "lime", "magenta", "maroon",
           "navy", "olive", "orange", "pink", "plum", "purple", "red",
           "rose", "salmon", "silver", "snow", "tan", "violet", "white"]
_UNITS = ["Box", "Bunch", "Bundle", "Carton", "Case", "Dozen", "Each",
          "Gram", "Lb", "N/A", "Oz", "Pallet", "Pound", "Tbl", "Ton",
          "Unknown"]
_SIZES = ["economy", "extra large", "large", "medium", "N/A", "petite",
          "small"]
#: the catalog's return reasons
_REASONS = ["Package was damaged", "Stopped working",
            "Did not get it on time", "Not the product that was ordred",
            "Parts missing", "Does not work with a product that I have",
            "Gift exchange", "Did not like the color",
            "Did not like the model", "Did not fit"]
#: the reason q93 asks for: key 9
Q93_REASON = _REASONS[8]
#: the spec's SF1 store_returns rows over its store_sales rows
RETURNS_PER_SALE = 287_514 / 2_880_404
#: sales dates span 1998-2002 in the catalog (its ``dsk``)
_SALES_DAYS = 365 * 5
_DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
              "Friday", "Saturday"]
_STATES = ["AL", "CA", "GA", "IL", "IN", "KS", "KY", "LA", "MI", "MN",
           "MO", "MS", "NC", "NY", "OH", "OK", "SD", "TN", "TX", "VA",
           "WA", "WI"]
_CITIES = ["Antioch", "Bethel", "Centerville", "Fairview", "Five Points",
           "Friendship"]
_COUNTIES = ["Barrow County", "Daviess County", "Fairfield County",
             "Franklin Parish", "Luce County", "Mobile County",
             "Richland County", "Walker County", "Williamson County",
             "Ziebach County"]
_EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
              "4 yr Degree", "Advanced Degree", "Unknown"]
_MARITAL = ["M", "S", "D", "W", "U"]
_CREDIT = ["Good", "High Risk", "Low Risk", "Unknown"]
_STORE_NAMES = ["ought", "able", "pri", "ese", "anti", "cally",
                "ation", "eing", "n st", "bar"]
_FIRST = ["James", "John", "Robert", "Michael", "William", "David",
          "Mary", "Patricia", "Linda", "Barbara", "Elizabeth",
          "Jennifer", "Maria", "Susan", "Margaret", "Dorothy"]
#: q27's text: its states and demographic values
Q27_STATES = ("TN",) * 6
Q27_DEMOGRAPHICS = ("M", "S", "College")


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


# --------------------------------------------------------------------- #
# q3: date_dim x store_sales x item
# --------------------------------------------------------------------- #


def _money(rng, n, lo=1.0, hi=300.0):
    return np.round(rng.uniform(lo, hi, n), 2)


def _pick(rng, pool, n):
    return np.array(pool)[rng.integers(0, len(pool), n)]


def _fmt(prefix: str, values, width: int = 0, suffix: str = ""):
    """``f"{prefix}{v:0{width}d}{suffix}"`` over an integer array."""
    digits = np.asarray(values).astype(str)
    if width:
        digits = np.char.zfill(digits, width)
    return np.char.add(np.char.add(prefix, digits), suffix)


def _flag(mask):
    return np.where(mask, "Y", "N")


def make_date_dim(first: dt.date = CALENDAR[0],
                  last: dt.date = CALENDAR[1]) -> pa.Table:
    """date_dim, one row a day from ``first`` to ``last``: ``d_date_sk``
    the Julian day number, ``d_month_seq`` months and ``d_week_seq``
    weeks since 1900-01-01, ``d_date_id`` counting from ``first``."""
    n = (last - first).days + 1
    days = (first - _EPOCH).days + np.arange(n, dtype=np.int64)
    d = days.astype("datetime64[D]")
    year = d.astype("datetime64[Y]").astype(np.int64) + 1970
    moy = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
    dom = (d - d.astype("datetime64[M]")).astype(np.int64) + 1
    dow = (days + 4) % 7  # 1970-01-01 was a Thursday; Sunday is 0
    sk = days - (_D0 - _EPOCH).days + DATE_SK_EPOCH
    week_seq = (days - (dt.date(1900, 1, 1) - _EPOCH).days) // 7 + 1
    qoy = (moy - 1) // 3 + 1
    quarter_seq = (year - 1900) * 4 + (qoy - 1)
    md = moy * 100 + dom
    no = np.full(n, "N")
    return pa.table({
        "d_date_sk": sk,
        "d_date_id": pa.array(_fmt("AAAAAAAA", np.arange(n), 8)),
        "d_date": pa.array(days.astype(np.int32), type=pa.date32()),
        "d_month_seq": (year - 1900) * 12 + (moy - 1),
        "d_week_seq": week_seq,
        "d_quarter_seq": quarter_seq,
        "d_year": year,
        "d_dow": dow,
        "d_moy": moy,
        "d_dom": dom,
        "d_qoy": qoy,
        "d_fy_year": year,
        "d_fy_quarter_seq": quarter_seq,
        "d_fy_week_seq": week_seq,
        "d_day_name": pa.array(np.array(_DAY_NAMES)[dow]),
        "d_quarter_name": pa.array(np.char.add(
            np.char.add(year.astype(str), "Q"), qoy.astype(str))),
        "d_holiday": pa.array(_flag(np.isin(md, (704, 1225, 101)))),
        "d_weekend": pa.array(_flag(np.isin(dow, (0, 6)))),
        "d_following_holiday": pa.array(
            _flag(np.isin(md, (705, 1226, 102)))),
        "d_first_dom": sk - (dom - 1),
        "d_last_dom": sk + 27,
        "d_same_day_ly": sk - 365,
        "d_same_day_lq": sk - 91,
        "d_current_day": pa.array(no),
        "d_current_week": pa.array(no),
        "d_current_month": pa.array(no),
        "d_current_quarter": pa.array(no),
        "d_current_year": pa.array(no),
    })


def make_item(rng: np.random.Generator, n: int) -> pa.Table:
    """item, ``n`` rows, drawing from ``rng`` in the mini catalog's
    order: ``i_manufact_id`` in 1..199, ``i_brand_id`` built from it."""
    sk = np.arange(1, n + 1, dtype=np.int64)
    manu_id = rng.integers(1, 200, n)
    brand_id = (rng.integers(1, 10, n) * 1000000
                + rng.integers(1, 10, n) * 10000 + manu_id)
    cat_idx = rng.integers(0, len(_CATEGORIES), n)
    cols = {
        "i_item_sk": sk,
        # two sks share one item_id (the spec's SCD pairing)
        "i_item_id": pa.array(_fmt("AAAAAAAA", sk // 2, 8)),
        "i_rec_start_date": pa.array(np.full(n, 9131, np.int32),
                                     type=pa.date32()),
        "i_rec_end_date": pa.nulls(n, pa.date32()),
        "i_item_desc": pa.array(_fmt("the promise of item ", sk,
                                     suffix=" landed")),
    }
    cols["i_current_price"] = _money(rng, n, 0.5, 100.0)
    cols["i_wholesale_cost"] = _money(rng, n, 0.2, 80.0)
    cols["i_brand_id"] = brand_id.astype(np.int64)
    cols["i_brand"] = pa.array(_fmt("brand#", brand_id % 100))
    cols["i_class_id"] = rng.integers(1, 17, n).astype(np.int64)
    cols["i_class"] = pa.array(_pick(rng, _CLASSES, n))
    cols["i_category_id"] = (cat_idx + 1).astype(np.int64)
    cols["i_category"] = pa.array(np.array(_CATEGORIES)[cat_idx])
    cols["i_manufact_id"] = manu_id.astype(np.int64)
    cols["i_manufact"] = pa.array(_fmt("manufact#", manu_id))
    cols["i_size"] = pa.array(_pick(rng, _SIZES, n))
    cols["i_formulation"] = pa.array(
        _fmt("form", rng.integers(0, 1000, n), 5))
    cols["i_color"] = pa.array(_pick(rng, _COLORS, n))
    cols["i_units"] = pa.array(_pick(rng, _UNITS, n))
    cols["i_container"] = pa.array(np.full(n, "Unknown"))
    cols["i_manager_id"] = rng.integers(1, 100, n).astype(np.int64)
    cols["i_product_name"] = pa.array(_fmt("product", sk))
    return pa.table(cols)


def _nullable(rng, values, frac: float):
    """``values`` with about ``frac`` of them NULL."""
    return pa.array(values, mask=rng.random(len(values)) < frac)


def store_sales_table(rng: np.random.Generator, n: int, first_row: int = 0,
                      rows: dict = SF1_ROWS) -> pa.Table:
    """``n`` store_sales rows by the mini catalog's formulas: sale dates
    over 1998-2002 with 2 % NULL, 3 % NULL customers, foreign keys in
    1..``rows[dimension]``, prices and amounts in cents; ticket numbers
    continue from row ``first_row``."""
    def fk(dim):
        return rng.integers(1, rows[dim] + 1, n).astype(np.int64)

    sold = _nullable(rng, (DATE_SK_EPOCH + rng.integers(0, 365 * 5, n))
                     .astype(np.int64), 0.02)
    n_time = rows["time_dim"]
    cols = {"ss_sold_date_sk": sold,
            "ss_sold_time_sk": (rng.integers(0, n_time, n)
                                * (86400 // n_time)).astype(np.int64),
            "ss_item_sk": fk("item")}
    cols["ss_customer_sk"] = _nullable(rng, fk("customer"), 0.03)
    for name, dim in (("ss_cdemo_sk", "customer_demographics"),
                      ("ss_hdemo_sk", "household_demographics"),
                      ("ss_addr_sk", "customer_address"),
                      ("ss_store_sk", "store"),
                      ("ss_promo_sk", "promotion")):
        cols[name] = fk(dim)
    cols["ss_ticket_number"] = (first_row + np.arange(n, dtype=np.int64)) \
        // 4 + 1
    qty = rng.integers(1, 101, n).astype(np.int64)
    wcost = _money(rng, n, 1, 100)
    lprice = np.round(wcost * rng.uniform(1.0, 2.0, n), 2)
    sprice = np.round(lprice * rng.uniform(0.3, 1.0, n), 2)
    ext_sales = np.round(sprice * qty, 2)
    ext_wcost = np.round(wcost * qty, 2)
    ext_list = np.round(lprice * qty, 2)
    tax = np.round(ext_sales * 0.05, 2)
    coupon = np.round(ext_sales * (rng.random(n) < 0.1)
                      * rng.uniform(0, 0.5, n), 2)
    net_paid = np.round(ext_sales - coupon, 2)
    cols.update({
        "ss_quantity": qty,
        "ss_wholesale_cost": wcost,
        "ss_list_price": lprice,
        "ss_sales_price": sprice,
        "ss_ext_discount_amt": np.round(ext_list - ext_sales, 2),
        "ss_ext_sales_price": ext_sales,
        "ss_ext_wholesale_cost": ext_wcost,
        "ss_ext_list_price": ext_list,
        "ss_ext_tax": tax,
        "ss_coupon_amt": coupon,
        "ss_net_paid": net_paid,
        "ss_net_paid_inc_tax": np.round(net_paid + tax, 2),
        "ss_net_profit": np.round(net_paid - ext_wcost, 2),
    })
    return pa.table(cols)


def make_catalog_store_sales(dirpath: str, n_files: int,
                             rows_per_file: int, seed: int = 3,
                             rows: dict = SF1_ROWS) -> list[str]:
    """store_sales in ``n_files`` Parquet files of ``rows_per_file``
    rows (one row group each)."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_files):
        t = store_sales_table(rng, rows_per_file, i * rows_per_file, rows)
        p = os.path.join(dirpath, f"store_sales-{i}.parquet")
        pq.write_table(t, p, row_group_size=rows_per_file)
        paths.append(p)
    return paths


def write_q3_tables(dirpath: str, n_files: int = 6,
                    rows_per_file: int = 1 << 20,
                    seed: int = 3) -> tuple[str, list[str], str]:
    """q3's three tables as Parquet: the whole calendar, SF1's 18 000
    items and the store_sales files.  Returns (date_dim path,
    store_sales paths, item path)."""
    dd = os.path.join(dirpath, "date_dim.parquet")
    pq.write_table(make_date_dim(), dd)
    item = os.path.join(dirpath, "item.parquet")
    pq.write_table(make_item(np.random.default_rng(seed), SF1_ROWS["item"]),
                   item)
    ss = make_catalog_store_sales(dirpath, n_files, rows_per_file, seed + 1)
    return dd, ss, item


def _star_join(session, date_dim_path: str, store_sales_paths,
               item_path: str, date_cond, item_cond, item_cols: list[str]):
    """date_dim JOIN store_sales JOIN item in the texts' FROM order.  The
    dimension sides are narrow projections of the rows ``date_cond`` and
    ``item_cond`` keep (so each estimates small enough to broadcast);
    the fact side stays a bare scan, so the runtime filter on
    ``ss_sold_date_sk`` reaches it."""
    dt_ = (session.read_parquet(date_dim_path).where(date_cond)
           .select(col("d_date_sk"), col("d_year")))
    ss = session.read_parquet(*store_sales_paths)
    it = (session.read_parquet(item_path).where(item_cond)
          .select(col("i_item_sk"), *[col(c) for c in item_cols]))
    return (dt_.join(ss, left_on=[col("d_date_sk")],
                     right_on=[col("ss_sold_date_sk")])
            .join(it, left_on=[col("ss_item_sk")],
                  right_on=[col("i_item_sk")]))


def _november(year: int):
    return col("d_moy").eq(lit(11)) & col("d_year").eq(lit(year))


def q3_dataframe(session, date_dim_path: str, store_sales_paths,
                 item_path: str):
    """TPC-DS q3: November sales of manufacturer 128's brands by year,
    ordered by year, sales descending and brand, the first 100 rows."""
    return (_star_join(session, date_dim_path, store_sales_paths, item_path,
                       col("d_moy").eq(lit(11)),
                       col("i_manufact_id").eq(lit(128)),
                       ["i_brand_id", "i_brand"])
            .group_by(col("d_year"), col("i_brand_id"), col("i_brand"))
            .agg((sum_(col("ss_ext_sales_price")), "sum_agg"))
            .order_by(SortKey(col("d_year")),
                      SortKey(col("sum_agg"), descending=True,
                              nulls_last=True),
                      SortKey(col("i_brand_id")))
            .limit(100))


def q42_dataframe(session, date_dim_path: str, store_sales_paths,
                  item_path: str):
    """TPC-DS q42: November 2000 sales of manager 1's items by year and
    category, sales descending, then year, category id and category,
    the first 100 rows."""
    return (_star_join(session, date_dim_path, store_sales_paths, item_path,
                       _november(2000), col("i_manager_id").eq(lit(1)),
                       ["i_category_id", "i_category"])
            .group_by(col("d_year"), col("i_category_id"), col("i_category"))
            .agg((sum_(col("ss_ext_sales_price")), "sum_agg"))
            .order_by(SortKey(col("sum_agg"), descending=True,
                              nulls_last=True),
                      SortKey(col("d_year")), SortKey(col("i_category_id")),
                      SortKey(col("i_category")))
            .limit(100))


def q52_dataframe(session, date_dim_path: str, store_sales_paths,
                  item_path: str):
    """TPC-DS q52: November 2000 sales of manager 1's items by year and
    brand, ordered by year, sales descending and brand id, the first 100
    rows."""
    return (_star_join(session, date_dim_path, store_sales_paths, item_path,
                       _november(2000), col("i_manager_id").eq(lit(1)),
                       ["i_brand_id", "i_brand"])
            .group_by(col("d_year"), col("i_brand"), col("i_brand_id"))
            .agg((sum_(col("ss_ext_sales_price")), "ext_price"))
            .select(col("d_year"), col("i_brand_id").alias("brand_id"),
                    col("i_brand").alias("brand"), col("ext_price"))
            .order_by(SortKey(col("d_year")),
                      SortKey(col("ext_price"), descending=True,
                              nulls_last=True),
                      SortKey(col("brand_id")))
            .limit(100))


def q55_dataframe(session, date_dim_path: str, store_sales_paths,
                  item_path: str):
    """TPC-DS q55: November 1999 sales of manager 28's items by brand,
    sales descending, then brand id, the first 100 rows."""
    return (_star_join(session, date_dim_path, store_sales_paths, item_path,
                       _november(1999), col("i_manager_id").eq(lit(28)),
                       ["i_brand_id", "i_brand"])
            .group_by(col("i_brand"), col("i_brand_id"))
            .agg((sum_(col("ss_ext_sales_price")), "ext_price"))
            .select(col("i_brand_id").alias("brand_id"),
                    col("i_brand").alias("brand"), col("ext_price"))
            .order_by(SortKey(col("ext_price"), descending=True,
                              nulls_last=True),
                      SortKey(col("brand_id")))
            .limit(100))


# --------------------------------------------------------------------- #
# q93: store_sales LEFT OUTER JOIN store_returns, and reason
# --------------------------------------------------------------------- #


def make_reason(n: int = len(_REASONS)) -> pa.Table:
    """reason, the catalog's first ``n`` rows."""
    sk = np.arange(1, n + 1, dtype=np.int64)
    return pa.table({
        "r_reason_sk": sk,
        "r_reason_id": pa.array(_fmt("AAAAAAAA", sk, 8)),
        "r_reason_desc": pa.array(_REASONS[:n]),
    })


def store_returns_table(rng: np.random.Generator, sales: pa.Table, n: int,
                        rows: dict | None = None) -> pa.Table:
    """``n`` store_returns rows by the mini catalog's formulas, drawing
    from ``rng`` in its order: the sampled sales rows, the return
    amount, then the columns in order.  Each return copies the item,
    customer, store and ticket of a ``sales`` row drawn with replacement
    (that table needs only those four columns); ``rows`` holds the
    dimension counts, ``reason`` included (the catalog's ten by
    default)."""
    rows = rows or {**SF1_ROWS, "reason": len(_REASONS)}
    ridx = rng.integers(0, sales.num_rows, n)
    ret_amt = _money(rng, n, 1, 300)
    take = pa.array(ridx)

    def copied(name):
        return sales.column(name).take(take).combine_chunks()

    def fk(dim):
        return rng.integers(1, rows[dim] + 1, n).astype(np.int64)

    cols = {"sr_returned_date_sk": (DATE_SK_EPOCH + rng.integers(
        0, _SALES_DAYS, n)).astype(np.int64)}
    n_time = rows["time_dim"]
    cols["sr_return_time_sk"] = (rng.integers(0, n_time, n)
                                 * (86400 // n_time)).astype(np.int64)
    cols["sr_item_sk"] = copied("ss_item_sk")
    cols["sr_customer_sk"] = copied("ss_customer_sk")
    cols["sr_cdemo_sk"] = fk("customer_demographics")
    cols["sr_hdemo_sk"] = fk("household_demographics")
    cols["sr_addr_sk"] = fk("customer_address")
    cols["sr_store_sk"] = copied("ss_store_sk")
    cols["sr_reason_sk"] = fk("reason")
    cols["sr_ticket_number"] = copied("ss_ticket_number")
    cols["sr_return_quantity"] = rng.integers(1, 20, n).astype(np.int64)
    cols["sr_return_amt"] = ret_amt
    cols["sr_return_tax"] = np.round(ret_amt * 0.05, 2)
    cols["sr_return_amt_inc_tax"] = np.round(ret_amt * 1.05, 2)
    cols["sr_fee"] = _money(rng, n, 0.5, 100)
    cols["sr_return_ship_cost"] = _money(rng, n, 0, 50)
    cols["sr_refunded_cash"] = np.round(ret_amt * 0.7, 2)
    cols["sr_reversed_charge"] = np.round(ret_amt * 0.2, 2)
    cols["sr_store_credit"] = np.round(ret_amt * 0.1, 2)
    cols["sr_net_loss"] = _money(rng, n, 0.5, 200)
    return pa.table(cols)


def write_q93_tables(dirpath: str, store_sales_paths,
                     seed: int = 93) -> tuple[str, str]:
    """store_returns, from the store_sales files already written (their
    four key columns read back), at the spec's SF1 ratio of returns to
    sales, as one file of one row group; and the catalog's ten
    reasons.  Returns (store_returns path, reason path)."""
    sales = pa.concat_tables([pq.read_table(p, columns=[
        "ss_item_sk", "ss_customer_sk", "ss_store_sk", "ss_ticket_number"])
        for p in store_sales_paths])
    n = round(sales.num_rows * RETURNS_PER_SALE)
    sr = os.path.join(dirpath, "store_returns.parquet")
    pq.write_table(store_returns_table(np.random.default_rng(seed), sales,
                                       n), sr, row_group_size=max(n, 1))
    reason = os.path.join(dirpath, "reason.parquet")
    pq.write_table(make_reason(), reason)
    return sr, reason


def q93_dataframe(session, store_sales_paths, store_returns_path: str,
                  reason_path: str):
    """TPC-DS q93 as its text reads: store_sales LEFT OUTER JOIN
    store_returns on (item, ticket), joined to the reason "Did not like
    the model"; each row's sale net of its return (the whole sale when
    no return matched) summed by customer, ordered by the sum and the
    customer (NULLs first), the first 100 rows.  store_returns is the
    narrow projection of the columns the query reads."""
    ss = session.read_parquet(*store_sales_paths)
    sr = session.read_parquet(store_returns_path).select(
        col("sr_item_sk"), col("sr_ticket_number"), col("sr_reason_sk"),
        col("sr_return_quantity"))
    reason = (session.read_parquet(reason_path)
              .where(col("r_reason_desc").eq(lit(Q93_REASON)))
              .select(col("r_reason_sk")))
    joined = (ss.join(sr, left_on=[col("ss_item_sk"),
                                   col("ss_ticket_number")],
                      right_on=[col("sr_item_sk"), col("sr_ticket_number")],
                      how="left_outer")
              .join(reason, left_on=[col("sr_reason_sk")],
                    right_on=[col("r_reason_sk")]))
    qty, price = col("ss_quantity"), col("ss_sales_price")
    act_sales = CaseWhen(
        ((col("sr_return_quantity").is_not_null(),
          (qty - col("sr_return_quantity")) * price),), qty * price)
    return (joined.select(col("ss_customer_sk"),
                          act_sales.alias("act_sales"))
            .group_by(col("ss_customer_sk"))
            .agg((sum_(col("act_sales")), "sumsales"))
            .order_by(col("sumsales"), col("ss_customer_sk"))
            .limit(100))


# --------------------------------------------------------------------- #
# store and customer_demographics; q67 as written, q5, q27
# --------------------------------------------------------------------- #


def make_store(rng: np.random.Generator, n: int) -> pa.Table:
    """store, ``n`` rows, drawing from ``rng`` in the catalog's order;
    ``s_state`` from the first eight of ``_STATES``."""
    sk = np.arange(1, n + 1, dtype=np.int64)
    cols = {
        "s_store_sk": sk,
        "s_store_id": pa.array(_fmt("AAAAAAAA", sk, 8)),
        "s_rec_start_date": pa.array(np.full(n, 9131, np.int32),
                                     type=pa.date32()),
        "s_rec_end_date": pa.nulls(n, pa.date32()),
        "s_closed_date_sk": pa.nulls(n, pa.int64()),
        "s_store_name": pa.array(np.array(_STORE_NAMES)[sk % 10]),
    }
    cols["s_number_employees"] = rng.integers(200, 300, n).astype(np.int64)
    cols["s_floor_space"] = rng.integers(5000000, 9000000, n).astype(
        np.int64)
    cols["s_hours"] = pa.array(_pick(rng, ["8AM-8AM", "8AM-4PM",
                                           "8AM-12AM"], n))
    cols["s_manager"] = pa.array(_pick(rng, _FIRST, n))
    cols["s_market_id"] = rng.integers(1, 11, n).astype(np.int64)
    cols["s_geography_class"] = pa.array(np.full(n, "Unknown"))
    cols["s_market_desc"] = pa.array(_fmt("market description ", sk))
    cols["s_market_manager"] = pa.array(_pick(rng, _FIRST, n))
    cols["s_division_id"] = np.ones(n, np.int64)
    cols["s_division_name"] = pa.array(np.full(n, "Unknown"))
    cols["s_company_id"] = np.ones(n, np.int64)
    cols["s_company_name"] = pa.array(np.full(n, "Unknown"))
    cols["s_street_number"] = pa.array(
        rng.integers(1, 1000, n).astype(str))
    cols["s_street_name"] = pa.array(_pick(rng, ["Main", "Oak", "Park"], n))
    cols["s_street_type"] = pa.array(_pick(rng, ["Street", "Ave", "Blvd"],
                                           n))
    cols["s_suite_number"] = pa.array(_fmt("Suite ",
                                           rng.integers(0, 100, n)))
    cols["s_city"] = pa.array(_pick(rng, _CITIES, n))
    cols["s_county"] = pa.array(_pick(rng, _COUNTIES, n))
    cols["s_state"] = pa.array(_pick(rng, _STATES[:8], n))
    cols["s_zip"] = pa.array(_fmt("", rng.integers(10000, 99999, n), 5))
    cols["s_country"] = pa.array(np.full(n, "United States"))
    cols["s_gmt_offset"] = rng.choice([-5.0, -6.0], n)
    cols["s_tax_precentage"] = np.round(rng.uniform(0.0, 0.11, n), 2)
    return pa.table(cols)


def make_customer_demographics(rng: np.random.Generator,
                               n: int) -> pa.Table:
    """customer_demographics, ``n`` rows, drawing from ``rng`` in the
    catalog's order (SF1 has 1 920 800)."""
    return pa.table({
        "cd_demo_sk": np.arange(1, n + 1, dtype=np.int64),
        "cd_gender": pa.array(_pick(rng, ["M", "F"], n)),
        "cd_marital_status": pa.array(_pick(rng, _MARITAL, n)),
        "cd_education_status": pa.array(_pick(rng, _EDUCATION, n)),
        "cd_purchase_estimate": (rng.integers(1, 20, n) * 500).astype(
            np.int64),
        "cd_credit_rating": pa.array(_pick(rng, _CREDIT, n)),
        "cd_dep_count": rng.integers(0, 7, n).astype(np.int64),
        "cd_dep_employed_count": rng.integers(0, 7, n).astype(np.int64),
        "cd_dep_college_count": rng.integers(0, 7, n).astype(np.int64),
    })


def write_store(dirpath: str, n: int = SF1_ROWS["store"],
                seed: int = 12) -> str:
    """store as one Parquet file; its path."""
    path = os.path.join(dirpath, "store.parquet")
    pq.write_table(make_store(np.random.default_rng(seed), n), path)
    return path


def write_customer_demographics(
        dirpath: str, n: int = SF1_ROWS["customer_demographics"],
        seed: int = 27) -> str:
    """customer_demographics as one Parquet file; its path."""
    path = os.path.join(dirpath, "customer_demographics.parquet")
    pq.write_table(make_customer_demographics(np.random.default_rng(seed),
                                              n), path)
    return path


#: q67's ROLLUP keys, most significant first
Q67_KEYS = ("i_category", "i_class", "i_brand", "i_product_name", "d_year",
            "d_qoy", "d_moy", "s_store_id")


def q67_rollup_dataframe(session, date_dim_path: str, store_sales_paths,
                         item_path: str, store_path: str):
    """TPC-DS q67 as its text reads: the year of months 1200-1211, sales
    (price x quantity, 0 when NULL) rolled up over ``Q67_KEYS``, ranked
    within each category by sales descending (the grand total's NULL
    category its own partition), ranks 1-100, ordered by every key,
    the sales and the rank (NULLs first), the first 100 rows.  The
    dimension sides are narrow projections, so each broadcasts and the
    date filter reaches the store_sales scan."""
    ss = session.read_parquet(*store_sales_paths)
    dd = (session.read_parquet(date_dim_path)
          .where((col("d_month_seq") >= lit(1200))
                 & (col("d_month_seq") <= lit(1200 + 11)))
          .select(col("d_date_sk"), col("d_year"), col("d_qoy"),
                  col("d_moy")))
    st = session.read_parquet(store_path).select(col("s_store_sk"),
                                                 col("s_store_id"))
    it = session.read_parquet(item_path).select(
        col("i_item_sk"), col("i_category"), col("i_class"), col("i_brand"),
        col("i_product_name"))
    sales = (ss.join(dd, left_on=[col("ss_sold_date_sk")],
                     right_on=[col("d_date_sk")])
             .join(st, left_on=[col("ss_store_sk")],
                   right_on=[col("s_store_sk")])
             .join(it, left_on=[col("ss_item_sk")],
                   right_on=[col("i_item_sk")])
             .select(*[col(k) for k in Q67_KEYS],
                     Coalesce(col("ss_sales_price") * col("ss_quantity"),
                              lit(0.0)).alias("sales")))
    dw1 = sales.rollup(*Q67_KEYS).agg((sum_(col("sales")), "sumsales"))
    spec = Window.partition_by("i_category").order_by("sumsales", desc=True)
    dw2 = dw1.select(*[col(k) for k in Q67_KEYS], col("sumsales"),
                     rank().over(spec).alias("rk"))
    return (dw2.where(col("rk") <= lit(100))
            .order_by(*[col(k) for k in Q67_KEYS], col("sumsales"),
                      col("rk"))
            .limit(100))


#: q5's dates: 2000-08-23 and 14 days on, as days since the epoch
Q5_DATES = ((dt.date(2000, 8, 23) - _EPOCH).days,
            (dt.date(2000, 9, 6) - _EPOCH).days)


def q5_dataframe(session, date_dim_path: str, store_sales_paths,
                 store_returns_path: str, store_path: str):
    """TPC-DS q5's store channel: store_sales and store_returns UNION ALL
    (sales and profit from one, return amount and net loss from the
    other, 0 in the columns a member lacks), joined to two weeks of
    dates and to the stores, summed by store id; the first 100 by id.
    The returns member keeps its own column names: the union names its
    columns by the first member's, by position."""
    sales = session.read_parquet(*store_sales_paths).select(
        col("ss_store_sk").alias("store_sk"),
        col("ss_sold_date_sk").alias("date_sk"),
        col("ss_ext_sales_price").alias("sales_price"),
        col("ss_net_profit").alias("profit"),
        lit(0.0).alias("return_amt"), lit(0.0).alias("net_loss"))
    returns = session.read_parquet(store_returns_path).select(
        col("sr_store_sk"), col("sr_returned_date_sk"),
        lit(0.0).alias("sales_price"), lit(0.0).alias("profit"),
        col("sr_return_amt"), col("sr_net_loss"))
    dd = (session.read_parquet(date_dim_path)
          .where((col("d_date") >= Literal(Q5_DATES[0], T.DATE))
                 & (col("d_date") <= Literal(Q5_DATES[1], T.DATE)))
          .select(col("d_date_sk")))
    st = session.read_parquet(store_path).select(col("s_store_sk"),
                                                 col("s_store_id"))
    ssr = (sales.union(returns)
           .join(dd, left_on=[col("date_sk")], right_on=[col("d_date_sk")])
           .join(st, left_on=[col("store_sk")],
                 right_on=[col("s_store_sk")])
           .group_by(col("s_store_id"))
           .agg((sum_(col("sales_price")), "sales"),
                (sum_(col("profit")), "profit"),
                (sum_(col("return_amt")), "returns_amt"),
                (sum_(col("net_loss")), "profit_loss")))
    return (ssr.select(col("s_store_id"), col("sales"), col("returns_amt"),
                       (col("profit") - col("profit_loss")).alias("profit"))
            .order_by(col("s_store_id"))
            .limit(100))


def q27_dataframe(session, date_dim_path: str, store_sales_paths,
                  item_path: str, store_path: str, cdemo_path: str,
                  states=Q27_STATES, demographics=Q27_DEMOGRAPHICS):
    """TPC-DS q27: 2002's sales to one (gender, marital status,
    education) in the stores of ``states``, the averages of quantity,
    list price, coupon and sales price over GROUPING SETS ((item id,
    state), (item id), ()), ordered by item id and state (NULLs last),
    the first 100 rows."""
    gender, marital, education = demographics
    ss = session.read_parquet(*store_sales_paths)
    cd = (session.read_parquet(cdemo_path)
          .where(col("cd_gender").eq(lit(gender))
                 & col("cd_marital_status").eq(lit(marital))
                 & col("cd_education_status").eq(lit(education)))
          .select(col("cd_demo_sk")))
    dd = (session.read_parquet(date_dim_path)
          .where(col("d_year").eq(lit(2002))).select(col("d_date_sk")))
    st = (session.read_parquet(store_path)
          .where(In(col("s_state"), tuple(states)))
          .select(col("s_store_sk"), col("s_state")))
    it = session.read_parquet(item_path).select(col("i_item_sk"),
                                                col("i_item_id"))
    joined = (ss.join(cd, left_on=[col("ss_cdemo_sk")],
                      right_on=[col("cd_demo_sk")])
              .join(dd, left_on=[col("ss_sold_date_sk")],
                    right_on=[col("d_date_sk")])
              .join(st, left_on=[col("ss_store_sk")],
                    right_on=[col("s_store_sk")])
              .join(it, left_on=[col("ss_item_sk")],
                    right_on=[col("i_item_sk")]))
    keys = ("i_item_id", "s_state")
    return (joined.grouping_sets([keys, keys[:1], ()], keys)
            .agg((avg(col("ss_quantity")), "agg1"),
                 (avg(col("ss_list_price")), "agg2"),
                 (avg(col("ss_coupon_amt")), "agg3"),
                 (avg(col("ss_sales_price")), "agg4"))
            .order_by(SortKey(col("i_item_id"), nulls_last=True),
                      SortKey(col("s_state"), nulls_last=True))
            .limit(100))
