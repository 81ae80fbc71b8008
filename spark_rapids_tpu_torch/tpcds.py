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
            "store": 12, "promotion": 300, "time_dim": 86_400,
            "income_band": 20}

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
           "Friendship", "Glendale", "Greenville", "Liberty", "Midway",
           "Mount Olive", "Mount Zion", "Oak Grove", "Oak Ridge",
           "Oakland", "Pleasant Grove", "Pleasant Hill", "Riverdale",
           "Riverside", "Salem", "Shiloh", "Springfield", "Union",
           "Walnut Grove", "Wilson"]
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
_LAST = ["Smith", "Johnson", "Williams", "Jones", "Brown", "Davis",
         "Miller", "Wilson", "Moore", "Taylor", "Anderson", "Thomas",
         "Jackson", "White", "Harris", "Martin"]
_COUNTRIES = ["United States", "Canada", "Mexico", "Germany", "Japan",
              "United Kingdom", "France", "Brazil", "India", "China"]
_BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000",
                  "0-500", "Unknown"]
#: the catalog's dimension dates (its ``n_days``): 1998-2003
_CATALOG_DAYS = (dt.date(2003, 12, 31) - _D0).days + 1
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


#: store_sales' twelve money columns, DECIMAL(7,2) in the spec
MONEY_COLUMNS = ("ss_wholesale_cost", "ss_list_price", "ss_sales_price",
                 "ss_ext_discount_amt", "ss_ext_sales_price",
                 "ss_ext_wholesale_cost", "ss_ext_list_price", "ss_ext_tax",
                 "ss_coupon_amt", "ss_net_paid", "ss_net_paid_inc_tax",
                 "ss_net_profit")
MONEY_TYPE = pa.decimal128(7, 2)


def cents(values, dtype=MONEY_TYPE) -> pa.Array:
    """Amounts the generators round to whole cents as ``dtype``, exactly:
    each value's unscaled digits are its cents, from which the decimal128
    slots are built (the high word the sign)."""
    arr = values if isinstance(values, (pa.Array, pa.ChunkedArray)) \
        else pa.array(values)
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    f = arr.to_numpy(zero_copy_only=False)
    ok = np.asarray(arr.is_valid())
    unscaled = np.round(np.where(ok, f, 0.0) * 10 ** dtype.scale).astype(
        np.int64)
    if np.abs(unscaled).max(initial=0) >= 10 ** dtype.precision:
        raise ValueError(f"an amount does not fit {dtype}")
    words = np.empty((len(f), 2), np.int64)
    words[:, 0] = unscaled
    words[:, 1] = unscaled >> 63
    bitmap = None if ok.all() else pa.py_buffer(
        np.packbits(ok, bitorder="little"))
    return pa.Array.from_buffers(dtype, len(f),
                                 [bitmap, pa.py_buffer(words)])


def write_decimal_store_sales(dirpath: str,
                              store_sales_paths) -> list[str]:
    """Each store_sales file again as the spec types it and Spark writes
    it: the twelve money columns DECIMAL(7,2) (exact: the generator
    rounds every amount to cents), stored as INT32 (Parquet's layout for
    a precision up to 9, ``store_decimal_as_integer``).  Test data for
    the scalar types, not an engine feature."""
    paths = []
    for src in store_sales_paths:
        t = pq.read_table(src)
        for name in MONEY_COLUMNS:
            i = t.schema.get_field_index(name)
            t = t.set_column(i, pa.field(name, MONEY_TYPE),
                             cents(t.column(name)))
        p = os.path.join(dirpath, "decimal-" + os.path.basename(src))
        pq.write_table(t, p, row_group_size=t.num_rows,
                       store_decimal_as_integer=True)
        paths.append(p)
    return paths


def write_scalar_types_sales(dirpath: str, store_sales_paths) -> list[str]:
    """Each store_sales file's rows with the other four scalar types:
    ``ss_sold_at`` TIMESTAMP (the ``d_date`` of ``ss_sold_date_sk`` at
    00:00 UTC plus ``ss_sold_time_sk`` seconds; NULL with the date),
    ``ss_quantity`` as TINYINT (1-100), ``ss_store_sk`` as SMALLINT,
    ``ss_sales_price`` as FLOAT, beside ``ss_sold_date_sk``,
    ``ss_sold_time_sk`` and ``ss_ext_sales_price`` DECIMAL(7,2).  Test
    data, not an engine feature."""
    day0 = (_D0 - _EPOCH).days - DATE_SK_EPOCH
    paths = []
    for src in store_sales_paths:
        t = pq.read_table(src, columns=[
            "ss_sold_date_sk", "ss_sold_time_sk", "ss_store_sk",
            "ss_quantity", "ss_sales_price", "ss_ext_sales_price"])
        sk = t.column("ss_sold_date_sk").combine_chunks()
        ok = np.asarray(sk.is_valid())
        days = np.where(ok, sk.fill_null(0).to_numpy(), 0) + day0
        secs = t.column("ss_sold_time_sk").to_numpy()
        at = (days * 86_400 + secs) * 1_000_000
        out = pa.table({
            "ss_sold_date_sk": sk,
            "ss_sold_time_sk": t.column("ss_sold_time_sk"),
            "ss_sold_at": pa.array(at, pa.timestamp("us", tz="UTC"),
                                   mask=~ok),
            "ss_quantity": t.column("ss_quantity").cast(pa.int8()),
            "ss_store_sk": t.column("ss_store_sk").cast(pa.int16()),
            "ss_sales_price": t.column("ss_sales_price").cast(pa.float32()),
            "ss_ext_sales_price": cents(t.column("ss_ext_sales_price")),
        })
        p = os.path.join(dirpath, "types-" + os.path.basename(src))
        pq.write_table(out, p, row_group_size=out.num_rows)
        paths.append(p)
    return paths


#: the nested store_sales columns' NULL shares: the pricing struct's
#: rows, the extras map's rows (the JAX tests' ``_map_table`` shape)
PRICING_NULLS, EXTRAS_NULLS = 0.05, 0.12


def nested_store_sales_table(t: pa.Table, rng: np.random.Generator
                             ) -> pa.Table:
    """One store_sales table's keys with two nested columns:
    ``ss_pricing``, a struct of ``ss_list_price``, ``ss_sales_price``
    and ``ss_net_profit`` (PRICING_NULLS of its rows NULL), and
    ``ss_extras``, a map<bigint, double> of 0-3 entries with distinct
    keys in 0-5 and values in cents (EXTRAS_NULLS of its rows NULL).
    Test data, not an engine feature."""
    n = t.num_rows
    pricing = pa.StructArray.from_arrays(
        [t.column(c).combine_chunks() for c in (
            "ss_list_price", "ss_sales_price", "ss_net_profit")],
        names=["ss_list_price", "ss_sales_price", "ss_net_profit"],
        mask=pa.array(rng.random(n) < PRICING_NULLS))
    null = rng.random(n) < EXTRAS_NULLS
    counts = np.where(null, 0, rng.integers(0, 4, n))
    keys = np.argsort(rng.random((n, 6)), axis=1)[:, :3]
    flat = keys[np.arange(3)[None, :] < counts[:, None]].astype(np.int64)
    values = np.round(rng.uniform(0, 100, len(flat)), 2)
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(counts, out=offsets[1:])
    mt = pa.map_(pa.int64(), pa.float64())
    entries = pa.StructArray.from_arrays(
        [pa.array(flat), pa.array(values)], fields=[mt.key_field,
                                                     mt.item_field])
    extras = pa.Array.from_buffers(
        mt, n, [pa.py_buffer(np.packbits(~null, bitorder="little")),
                pa.py_buffer(offsets)], children=[entries])
    return pa.table({"ss_sold_date_sk": t.column("ss_sold_date_sk"),
                     "ss_item_sk": t.column("ss_item_sk"),
                     "ss_customer_sk": t.column("ss_customer_sk"),
                     "ss_store_sk": t.column("ss_store_sk"),
                     "ss_pricing": pricing, "ss_extras": extras})


def write_nested_store_sales(dirpath: str, store_sales_paths,
                             seed: int = 14) -> list[str]:
    """Each store_sales file again with ``nested_store_sales_table``'s
    columns, one row group a file; the i-th file draws from
    ``default_rng(seed + i)`` (a caller writing files one call each, in
    parallel, passes each its own seed)."""
    paths = []
    for i, src in enumerate(store_sales_paths):
        t = nested_store_sales_table(pq.read_table(src),
                                     np.random.default_rng(seed + i))
        p = os.path.join(dirpath, "nested-" + os.path.basename(src))
        pq.write_table(t, p, row_group_size=t.num_rows)
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
               item_path: str, date_cond, item_cond, item_cols: list[str],
               fmt: str = "parquet"):
    """date_dim JOIN store_sales JOIN item in the texts' FROM order.  The
    dimension sides are narrow projections of the rows ``date_cond`` and
    ``item_cond`` keep (so each estimates small enough to broadcast);
    the fact side stays a bare scan, so the runtime filter on
    ``ss_sold_date_sk`` reaches it.  ``fmt``: the store_sales files'
    format, ``parquet`` or ``orc`` (files or directories)."""
    dt_ = (session.read_parquet(date_dim_path).where(date_cond)
           .select(col("d_date_sk"), col("d_year")))
    ss = getattr(session, f"read_{fmt}")(*store_sales_paths)
    it = (session.read_parquet(item_path).where(item_cond)
          .select(col("i_item_sk"), *[col(c) for c in item_cols]))
    return (dt_.join(ss, left_on=[col("d_date_sk")],
                     right_on=[col("ss_sold_date_sk")])
            .join(it, left_on=[col("ss_item_sk")],
                  right_on=[col("i_item_sk")]))


def _november(year: int):
    return col("d_moy").eq(lit(11)) & col("d_year").eq(lit(year))


def q3_dataframe(session, date_dim_path: str, store_sales_paths,
                 item_path: str, fmt: str = "parquet"):
    """TPC-DS q3: November sales of manufacturer 128's brands by year,
    ordered by year, sales descending and brand, the first 100 rows
    (``fmt``: store_sales' file format)."""
    return (_star_join(session, date_dim_path, store_sales_paths, item_path,
                       col("d_moy").eq(lit(11)),
                       col("i_manufact_id").eq(lit(128)),
                       ["i_brand_id", "i_brand"], fmt)
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
    cols["s_city"] = pa.array(_pick(rng, _CITIES[:6], n))
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


# --------------------------------------------------------------------- #
# The rest of the store channel's dimensions, and all 13 tables on disk
# --------------------------------------------------------------------- #


def _flags(rng, n):
    return np.array(["Y", "N"])[rng.integers(0, 2, n)]


def make_time_dim(n: int = SF1_ROWS["time_dim"]) -> pa.Table:
    """time_dim, ``n`` rows spread evenly over the day (SF1: one a
    second): ``t_time_sk`` = ``t_time`` the second of the day; no rng."""
    mins = np.arange(n, dtype=np.int64)
    secs = mins * (86400 // max(n, 1))
    hour = secs // 3600
    meal = np.select([(hour >= 6) & (hour < 9), (hour >= 11) & (hour < 13),
                      (hour >= 17) & (hour < 20)],
                     ["breakfast", "lunch", "dinner"], "")
    return pa.table({
        "t_time_sk": secs,
        "t_time_id": pa.array(_fmt("AAAAAAAA", mins, 8)),
        "t_time": secs,
        "t_hour": hour,
        "t_minute": (secs % 3600) // 60,
        "t_second": secs % 60,
        "t_am_pm": pa.array(np.where(hour < 12, "AM", "PM")),
        "t_shift": pa.array(np.where(hour < 8, "first",
                                     np.where(hour < 16, "second", "third"))),
        "t_sub_shift": pa.array(np.where(
            hour < 12, "morning", np.where(hour < 18, "afternoon",
                                           "evening"))),
        "t_meal_time": pa.array(meal, mask=meal == ""),
    })


def make_customer(rng: np.random.Generator, n: int, n_addr: int, n_cd: int,
                  n_hd: int, n_days: int = _CATALOG_DAYS) -> pa.Table:
    """customer, ``n`` rows, drawing from ``rng`` in the catalog's order:
    4 % of the current demographics NULL, keys in 1..the dimensions'
    counts."""
    sk = np.arange(1, n + 1, dtype=np.int64)

    def date_sk():
        return (DATE_SK_EPOCH + rng.integers(0, n_days, n)).astype(np.int64)

    cols = {"c_customer_sk": sk,
            "c_customer_id": pa.array(_fmt("AAAAAAAA", sk, 8))}
    cols["c_current_cdemo_sk"] = _nullable(
        rng, rng.integers(1, n_cd + 1, n).astype(np.int64), 0.04)
    cols["c_current_hdemo_sk"] = _nullable(
        rng, rng.integers(1, n_hd + 1, n).astype(np.int64), 0.04)
    cols["c_current_addr_sk"] = rng.integers(1, n_addr + 1, n).astype(
        np.int64)
    cols["c_first_shipto_date_sk"] = date_sk()
    cols["c_first_sales_date_sk"] = date_sk()
    cols["c_salutation"] = pa.array(_pick(
        rng, ["Mr.", "Mrs.", "Ms.", "Dr.", "Sir"], n))
    cols["c_first_name"] = pa.array(_pick(rng, _FIRST, n))
    cols["c_last_name"] = pa.array(_pick(rng, _LAST, n))
    cols["c_preferred_cust_flag"] = pa.array(_flags(rng, n))
    cols["c_birth_day"] = rng.integers(1, 29, n).astype(np.int64)
    cols["c_birth_month"] = rng.integers(1, 13, n).astype(np.int64)
    cols["c_birth_year"] = rng.integers(1930, 1995, n).astype(np.int64)
    cols["c_birth_country"] = pa.array(_pick(rng, _COUNTRIES, n))
    cols["c_login"] = pa.array(_fmt("login", sk))
    cols["c_email_address"] = pa.array(_fmt("c", sk, suffix="@example.com"))
    cols["c_last_review_date_sk"] = date_sk()
    return pa.table(cols)


def make_customer_address(rng: np.random.Generator, n: int) -> pa.Table:
    """customer_address, ``n`` rows, drawing from ``rng`` in the
    catalog's order."""
    sk = np.arange(1, n + 1, dtype=np.int64)
    cols = {"ca_address_sk": sk,
            "ca_address_id": pa.array(_fmt("AAAAAAAA", sk, 8))}
    cols["ca_street_number"] = pa.array(
        rng.integers(1, 1000, n).astype(str))
    cols["ca_street_name"] = pa.array(_pick(
        rng, ["Main", "Oak", "Park", "First", "Elm", "Cedar", "Maple",
              "Lake", "Hill", "Pine"], n))
    cols["ca_street_type"] = pa.array(_pick(
        rng, ["Street", "Ave", "Blvd", "Ct.", "Dr.", "Lane", "Pkwy", "Rd",
              "Way"], n))
    cols["ca_suite_number"] = pa.array(_fmt("Suite ",
                                            rng.integers(0, 100, n)))
    cols["ca_city"] = pa.array(_pick(rng, _CITIES, n))
    cols["ca_county"] = pa.array(_pick(rng, _COUNTIES, n))
    cols["ca_state"] = pa.array(_pick(rng, _STATES, n))
    cols["ca_zip"] = pa.array(_fmt("", rng.integers(10000, 99999, n), 5))
    cols["ca_country"] = pa.array(np.full(n, "United States"))
    cols["ca_gmt_offset"] = rng.choice([-5.0, -6.0, -7.0, -8.0], n)
    cols["ca_location_type"] = pa.array(_pick(
        rng, ["apartment", "condo", "single family"], n))
    return pa.table(cols)


def make_household_demographics(rng: np.random.Generator, n: int,
                                n_ib: int) -> pa.Table:
    """household_demographics, ``n`` rows, drawing from ``rng`` in the
    catalog's order; vehicle counts from -1 to 4."""
    cols = {"hd_demo_sk": np.arange(1, n + 1, dtype=np.int64)}
    cols["hd_income_band_sk"] = rng.integers(1, n_ib + 1, n).astype(np.int64)
    cols["hd_buy_potential"] = pa.array(_pick(rng, _BUY_POTENTIAL, n))
    cols["hd_dep_count"] = rng.integers(0, 10, n).astype(np.int64)
    cols["hd_vehicle_count"] = rng.integers(-1, 5, n).astype(np.int64)
    return pa.table(cols)


def make_income_band(n: int = SF1_ROWS["income_band"]) -> pa.Table:
    """income_band: ``n`` bands of 10 000 from 0; no rng."""
    sk = np.arange(1, n + 1, dtype=np.int64)
    return pa.table({"ib_income_band_sk": sk,
                     "ib_lower_bound": (sk - 1) * 10000,
                     "ib_upper_bound": sk * 10000})


def make_promotion(rng: np.random.Generator, n: int, n_item: int,
                   n_days: int = _CATALOG_DAYS) -> pa.Table:
    """promotion, ``n`` rows, drawing from ``rng`` in the catalog's
    order."""
    sk = np.arange(1, n + 1, dtype=np.int64)
    cols = {"p_promo_sk": sk, "p_promo_id": pa.array(_fmt("AAAAAAAA", sk, 8))}
    for name in ("p_start_date_sk", "p_end_date_sk"):
        cols[name] = (DATE_SK_EPOCH + rng.integers(0, n_days, n)).astype(
            np.int64)
    cols["p_item_sk"] = rng.integers(1, n_item + 1, n).astype(np.int64)
    cols["p_cost"] = np.round(rng.uniform(500.0, 2000.0, n), 2)
    cols["p_response_target"] = np.ones(n, np.int64)
    cols["p_promo_name"] = pa.array(_pick(
        rng, ["anti", "bar", "cally", "ese", "ought"], n))
    for ch in ("dmail", "email", "catalog", "tv", "radio", "press", "event",
               "demo"):
        cols[f"p_channel_{ch}"] = pa.array(_flags(rng, n))
    cols["p_channel_details"] = pa.array(_fmt("promo details ", sk))
    cols["p_purpose"] = pa.array(np.full(n, "Unknown"))
    cols["p_discount_active"] = pa.array(np.full(n, "N"))
    return pa.table(cols)


#: the store channel's 13 tables
STORE_CHANNEL_TABLES = (
    "store_sales", "store_returns", "date_dim", "time_dim", "item", "store",
    "customer", "customer_address", "customer_demographics",
    "household_demographics", "income_band", "promotion", "reason")


def write_store_channel(dirpath: str, n_files: int = 6,
                        rows_per_file: int = 1 << 20, seed: int = 3,
                        written: dict | None = None) -> dict:
    """The 13 store-channel tables as Parquet: store_sales in
    ``n_files`` files of ``rows_per_file`` rows and q93's store_returns
    (``write_q3_tables``, ``write_q93_tables``), the whole calendar, and
    every dimension at its SF1 count (``SF1_ROWS``; the ten reasons),
    each from its own seeded rng.  ``written`` (table -> paths) names
    tables already on disk, which are kept; ``dirpath`` is made if it is
    missing.  Returns table -> paths."""
    os.makedirs(dirpath, exist_ok=True)
    out = {k: list(v) for k, v in (written or {}).items()}
    if not {"date_dim", "store_sales", "item"} <= set(out):
        dd, ss, item = write_q3_tables(dirpath, n_files, rows_per_file, seed)
        out.update(date_dim=[dd], store_sales=ss, item=[item])
    if not {"store_returns", "reason"} <= set(out):
        sr, reason = write_q93_tables(dirpath, out["store_sales"])
        out.update(store_returns=[sr], reason=[reason])
    if "store" not in out:
        out["store"] = [write_store(dirpath)]
    if "customer_demographics" not in out:
        out["customer_demographics"] = [write_customer_demographics(dirpath)]
    r = SF1_ROWS
    makers = {
        "time_dim": lambda: make_time_dim(),
        "customer_address": lambda: make_customer_address(
            np.random.default_rng(50), r["customer_address"]),
        "household_demographics": lambda: make_household_demographics(
            np.random.default_rng(72), r["household_demographics"],
            r["income_band"]),
        "income_band": lambda: make_income_band(),
        "customer": lambda: make_customer(
            np.random.default_rng(100), r["customer"],
            r["customer_address"], r["customer_demographics"],
            r["household_demographics"]),
        "promotion": lambda: make_promotion(
            np.random.default_rng(300), r["promotion"], r["item"]),
    }
    for name, make in makers.items():
        if name not in out:
            path = os.path.join(dirpath, f"{name}.parquet")
            pq.write_table(make(), path)
            out[name] = [path]
    return {name: out[name] for name in STORE_CHANNEL_TABLES}


# --------------------------------------------------------------------- #
# The catalog and web channels: the 11 tables the other 29 texts read,
# and the whole catalog in its draw order
# --------------------------------------------------------------------- #

#: the spec's SF1 row counts of the channels' dimensions
SF1_CHANNEL_DIMS = {"warehouse": 5, "ship_mode": 20, "call_center": 6,
                    "web_site": 30, "web_page": 60, "catalog_page": 11_718}
#: the spec's SF1 rows of the channels' facts, and the files they are
#: written in
SF1_CHANNEL_FACTS = {"catalog_sales": (1_441_548, 3),
                     "web_sales": (719_384, 2),
                     "catalog_returns": (144_067, 1),
                     "web_returns": (71_763, 1),
                     "inventory": (11_745_000, 6)}
#: the 11 tables the catalog and web texts read beside the store
#: channel's
CHANNEL_TABLES = ("catalog_sales", "catalog_returns", "web_sales",
                  "web_returns", "inventory", "warehouse", "ship_mode",
                  "call_center", "web_site", "web_page", "catalog_page")
_SHIP_TYPES = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "LIBRARY"]
_SHIP_CODES = ["AIR", "SURFACE", "SEA", "AIR", "SURFACE"]
_CARRIERS = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL"]
#: the mini catalog's base rows at scale 1 (``generate``)
CATALOG_ROWS = {
    "store_sales": 20_000, "catalog_sales": 12_000, "web_sales": 12_000,
    "store_returns": 3_000, "catalog_returns": 2_000,
    "web_returns": 2_000, "inventory": 12_000,
    "customer": 1_000, "customer_address": 800,
    "customer_demographics": 1_920, "household_demographics": 720,
    "item": 1_000, "time_dim": 1_440, "income_band": 20,
    "store": 12, "warehouse": 6, "promotion": 30, "reason": 10,
    "ship_mode": 5, "call_center": 4, "web_site": 6, "web_page": 20,
    "catalog_page": 40,
}


def _sk(n: int) -> np.ndarray:
    return np.arange(1, n + 1, dtype=np.int64)


def _ids(sk) -> pa.Array:
    return pa.array(_fmt("AAAAAAAA", sk, 8))


def make_warehouse(rng: np.random.Generator, n: int) -> pa.Table:
    """warehouse, ``n`` rows, drawing from ``rng`` in the catalog's
    order."""
    sk = _sk(n)
    cols = {"w_warehouse_sk": sk, "w_warehouse_id": _ids(sk),
            "w_warehouse_name": pa.array(_fmt("Warehouse number ", sk))}
    cols["w_warehouse_sq_ft"] = rng.integers(50000, 1000000, n).astype(
        np.int64)
    cols["w_street_number"] = pa.array(rng.integers(1, 1000, n).astype(str))
    cols["w_street_name"] = pa.array(_pick(rng, ["Main", "Oak", "Park"], n))
    cols["w_street_type"] = pa.array(_pick(rng, ["Street", "Ave"], n))
    cols["w_suite_number"] = pa.array(_fmt("Suite ",
                                           rng.integers(0, 100, n)))
    cols["w_city"] = pa.array(_pick(rng, _CITIES[:6], n))
    cols["w_county"] = pa.array(_pick(rng, _COUNTIES, n))
    cols["w_state"] = pa.array(_pick(rng, _STATES[:8], n))
    cols["w_zip"] = pa.array(_fmt("", rng.integers(10000, 99999, n), 5))
    cols["w_country"] = pa.array(np.full(n, "United States"))
    cols["w_gmt_offset"] = rng.choice([-5.0, -6.0], n)
    return pa.table(cols)


def make_ship_mode(n: int) -> pa.Table:
    """ship_mode, ``n`` rows; no rng.  The catalog cuts its five codes
    and carriers to ``n`` (so it stops at 5 rows); here all three lists
    cycle, as its ``sm_type`` does, and the first 5 rows are its."""
    sk = _sk(n)
    cyc = (sk - 1) % 5
    return pa.table({
        "sm_ship_mode_sk": sk,
        "sm_ship_mode_id": _ids(sk),
        "sm_type": pa.array(np.array(_SHIP_TYPES)[cyc]),
        "sm_code": pa.array(np.array(_SHIP_CODES)[cyc]),
        "sm_carrier": pa.array(np.array(_CARRIERS)[cyc]),
        "sm_contract": pa.array(_fmt("contract", sk)),
    })


def make_call_center(rng: np.random.Generator, n: int) -> pa.Table:
    """call_center, ``n`` rows, drawing from ``rng`` in the catalog's
    order."""
    sk = _sk(n)
    cols = {
        "cc_call_center_sk": sk, "cc_call_center_id": _ids(sk),
        "cc_rec_start_date": pa.array(np.full(n, 9131, np.int32),
                                      type=pa.date32()),
        "cc_rec_end_date": pa.nulls(n, pa.date32()),
        "cc_name": pa.array(_fmt("call center ", sk)),
    }
    cols["cc_class"] = pa.array(_pick(rng, ["small", "medium", "large"], n))
    cols["cc_employees"] = rng.integers(100, 700, n).astype(np.int64)
    cols["cc_sq_ft"] = rng.integers(10000, 50000, n).astype(np.int64)
    cols["cc_hours"] = pa.array(_pick(rng, ["8AM-8AM", "8AM-4PM"], n))
    cols["cc_manager"] = pa.array(_pick(rng, _FIRST, n))
    cols["cc_mkt_id"] = rng.integers(1, 7, n).astype(np.int64)
    cols["cc_mkt_class"] = pa.array(_fmt("mkt class ", sk))
    cols["cc_mkt_desc"] = pa.array(_fmt("mkt desc ", sk))
    cols["cc_market_manager"] = pa.array(_pick(rng, _FIRST, n))
    cols["cc_division"] = np.ones(n, np.int64)
    cols["cc_division_name"] = pa.array(np.full(n, "Unknown"))
    cols["cc_company"] = np.ones(n, np.int64)
    cols["cc_company_name"] = pa.array(np.full(n, "Unknown"))
    cols["cc_county"] = pa.array(_pick(rng, _COUNTIES, n))
    cols["cc_state"] = pa.array(_pick(rng, _STATES[:8], n))
    cols["cc_country"] = pa.array(np.full(n, "United States"))
    cols["cc_gmt_offset"] = rng.choice([-5.0, -6.0], n)
    cols["cc_tax_percentage"] = np.round(rng.uniform(0.0, 0.12, n), 2)
    return pa.table(cols)


def make_web_site(rng: np.random.Generator, n: int) -> pa.Table:
    """web_site, ``n`` rows, drawing from ``rng`` in the catalog's
    order."""
    sk = _sk(n)
    cols = {"web_site_sk": sk, "web_site_id": _ids(sk),
            "web_name": pa.array(_fmt("site_", sk))}
    cols["web_mkt_id"] = rng.integers(1, 7, n).astype(np.int64)
    cols["web_company_name"] = pa.array(_pick(
        rng, ["pri", "able", "ought", "ese", "anti"], n))
    cols["web_manager"] = pa.array(_pick(rng, _FIRST, n))
    cols["web_county"] = pa.array(_pick(rng, _COUNTIES, n))
    cols["web_state"] = pa.array(_pick(rng, _STATES[:8], n))
    cols["web_country"] = pa.array(np.full(n, "United States"))
    cols["web_gmt_offset"] = rng.choice([-5.0, -6.0], n)
    cols["web_tax_percentage"] = np.round(rng.uniform(0.0, 0.12, n), 2)
    return pa.table(cols)


def make_web_page(rng: np.random.Generator, n: int,
                  n_days: int = _CATALOG_DAYS) -> pa.Table:
    """web_page, ``n`` rows, drawing from ``rng`` in the catalog's
    order; half the customers NULL."""
    sk = _sk(n)
    cols = {"wp_web_page_sk": sk, "wp_web_page_id": _ids(sk)}
    for name in ("wp_creation_date_sk", "wp_access_date_sk"):
        cols[name] = (DATE_SK_EPOCH + rng.integers(0, n_days, n)).astype(
            np.int64)
    cols["wp_autogen_flag"] = pa.array(_flags(rng, n))
    cols["wp_customer_sk"] = _nullable(
        rng, rng.integers(1, 100, n).astype(np.int64), 0.5)
    cols["wp_url"] = pa.array(np.full(n, "http://www.foo.com"))
    cols["wp_type"] = pa.array(_pick(
        rng, ["ad", "dynamic", "feedback", "general", "order", "protected",
              "welcome"], n))
    cols["wp_char_count"] = rng.integers(1000, 8000, n).astype(np.int64)
    cols["wp_link_count"] = rng.integers(2, 25, n).astype(np.int64)
    cols["wp_image_count"] = rng.integers(1, 7, n).astype(np.int64)
    cols["wp_max_ad_count"] = rng.integers(0, 5, n).astype(np.int64)
    return pa.table(cols)


def make_catalog_page(rng: np.random.Generator, n: int) -> pa.Table:
    """catalog_page, ``n`` rows (ten pages a catalog), drawing from
    ``rng`` in the catalog's order."""
    sk = _sk(n)
    return pa.table({
        "cp_catalog_page_sk": sk,
        "cp_catalog_page_id": _ids(sk),
        "cp_start_date_sk": np.full(n, DATE_SK_EPOCH, np.int64),
        "cp_end_date_sk": np.full(n, DATE_SK_EPOCH + 364, np.int64),
        "cp_department": pa.array(np.full(n, "DEPARTMENT")),
        "cp_catalog_number": (sk - 1) // 10 + 1,
        "cp_catalog_page_number": (sk - 1) % 10 + 1,
        "cp_description": pa.array(_fmt("catalog page ", sk)),
        "cp_type": pa.array(_pick(rng, ["bi-annual", "monthly",
                                        "quarterly"], n)),
    })


def _amounts(rng: np.random.Generator, n: int, ship: bool) -> dict:
    """A sales row's quantity and money columns, by the catalog's
    formulas and in its draw order (``ship``: the catalog and web sales'
    shipping cost, drawn before the coupon)."""
    qty = rng.integers(1, 101, n).astype(np.int64)
    wcost = _money(rng, n, 1, 100)
    lprice = np.round(wcost * rng.uniform(1.0, 2.0, n), 2)
    sprice = np.round(lprice * rng.uniform(0.3, 1.0, n), 2)
    ext_sales = np.round(sprice * qty, 2)
    ext_wcost = np.round(wcost * qty, 2)
    ext_list = np.round(lprice * qty, 2)
    tax = np.round(ext_sales * 0.05, 2)
    cost = _money(rng, n, 0, 150) if ship else None
    coupon = np.round(ext_sales * (rng.random(n) < 0.1)
                      * rng.uniform(0, 0.5, n), 2)
    net_paid = np.round(ext_sales - coupon, 2)
    out = {"quantity": qty, "wholesale_cost": wcost, "list_price": lprice,
           "sales_price": sprice,
           "ext_discount_amt": np.round(ext_list - ext_sales, 2),
           "ext_sales_price": ext_sales, "ext_wholesale_cost": ext_wcost,
           "ext_list_price": ext_list, "ext_tax": tax, "coupon_amt": coupon}
    if ship:
        out["ext_ship_cost"] = cost
    out["net_paid"] = net_paid
    out["net_paid_inc_tax"] = np.round(net_paid + tax, 2)
    if ship:
        out["net_paid_inc_ship"] = np.round(net_paid + cost, 2)
        out["net_paid_inc_ship_tax"] = np.round(net_paid + cost + tax, 2)
    out["net_profit"] = np.round(net_paid - ext_wcost, 2)
    return out


def _dates(rng: np.random.Generator, n: int) -> np.ndarray:
    """The catalog's ``dsk``: sale dates over 1998-2002."""
    return (DATE_SK_EPOCH + rng.integers(0, _SALES_DAYS, n)).astype(np.int64)


def _times(rng: np.random.Generator, n: int, n_time: int) -> np.ndarray:
    """The catalog's ``tsk``: a time_dim key of ``n_time`` spread over
    the day."""
    return (rng.integers(0, n_time, n) * (86400 // n_time)).astype(np.int64)


def _fks(rng: np.random.Generator, n: int, rows: dict, *dims) -> list:
    return [rng.integers(1, rows[d] + 1, n).astype(np.int64) for d in dims]


_SALES_KEYS = ("bill_customer", "bill_cdemo", "bill_hdemo", "bill_addr",
               "ship_customer", "ship_cdemo", "ship_hdemo", "ship_addr",
               "ship_mode", "warehouse", "item", "promo")
_SALES_DIMS = ("customer", "customer_demographics", "household_demographics",
               "customer_address", "customer", "customer_demographics",
               "household_demographics", "customer_address", "ship_mode",
               "warehouse", "item", "promotion")


def channel_sales_table(rng: np.random.Generator, prefix: str, n: int,
                        rows: dict, first_row: int = 0) -> pa.Table:
    """``n`` catalog_sales (``prefix`` "cs") or web_sales ("ws") rows by
    the catalog's ``_sales`` formulas, drawing from ``rng`` in its order;
    order numbers (three rows an order) continue from row ``first_row``;
    foreign keys in 1..``rows[dimension]``."""
    amounts = _amounts(rng, n, ship=True)
    sold = _dates(rng, n)
    times = _times(rng, n, rows["time_dim"])
    shipped = sold + rng.integers(2, 90, n)
    keys = dict(zip(_SALES_KEYS, _fks(rng, n, rows, *_SALES_DIMS)))
    p = prefix + "_"
    cols = {p + "sold_date_sk": _nullable(rng, sold, 0.02),
            p + "sold_time_sk": times, p + "ship_date_sk": shipped}
    if prefix == "cs":
        for k in _SALES_KEYS[:8]:
            cols[p + k + "_sk"] = keys[k]
        cols["cs_call_center_sk"], cols["cs_catalog_page_sk"] = _fks(
            rng, n, rows, "call_center", "catalog_page")
        for k in ("ship_mode", "warehouse", "item", "promo"):
            cols[p + k + "_sk"] = keys[k]
    else:
        cols["ws_item_sk"] = keys["item"]
        for k in _SALES_KEYS[:8]:
            cols[p + k + "_sk"] = keys[k]
        cols["ws_web_page_sk"], cols["ws_web_site_sk"] = _fks(
            rng, n, rows, "web_page", "web_site")
        for k in ("ship_mode", "warehouse", "promo"):
            cols[p + k + "_sk"] = keys[k]
    cols[p + "order_number"] = (first_row + np.arange(n, dtype=np.int64)) \
        // 3 + 1
    for k, v in amounts.items():
        cols[p + k] = v
    return pa.table(cols)


def channel_returns_table(rng: np.random.Generator, prefix: str,
                          sales: pa.Table, n: int,
                          rows: dict) -> pa.Table:
    """``n`` catalog_returns ("cr") or web_returns ("wr") rows by the
    catalog's ``_returns`` formulas, drawing from ``rng`` in its order:
    each copies the item, order number and bill customer of a ``sales``
    row drawn with replacement (one take), the rest drawn."""
    s = "cs_" if prefix == "cr" else "ws_"
    ridx = pa.array(rng.integers(0, sales.num_rows, n))
    amt = _money(rng, n, 1, 300)
    returned = _dates(rng, n)
    times = _times(rng, n, rows["time_dim"])
    qty = rng.integers(1, 20, n).astype(np.int64)
    fee = _money(rng, n, 0.5, 100)
    ship_cost = _money(rng, n, 0, 50)
    net_loss = _money(rng, n, 0.5, 200)

    def copied(name):
        return sales.column(s + name).take(ridx).combine_chunks()

    p = prefix + "_"
    cols = {p + "returned_date_sk": returned,
            p + "returned_time_sk": times,
            p + "item_sk": copied("item_sk"),
            p + "refunded_customer_sk": copied("bill_customer_sk")}
    dims = ["customer_demographics", "household_demographics",
            "customer_address", "customer", "customer_demographics",
            "household_demographics", "customer_address"]
    names = ["refunded_cdemo", "refunded_hdemo", "refunded_addr",
             "returning_customer", "returning_cdemo", "returning_hdemo",
             "returning_addr"]
    if prefix == "cr":
        dims += ["call_center", "catalog_page", "ship_mode", "warehouse",
                 "reason"]
        names += ["call_center", "catalog_page", "ship_mode", "warehouse",
                  "reason"]
    else:
        dims += ["web_page", "reason"]
        names += ["web_page", "reason"]
    for name, v in zip(names, _fks(rng, n, rows, *dims)):
        cols[p + name + "_sk"] = v
    cols[p + "order_number"] = copied("order_number")
    amount = "return_amount" if prefix == "cr" else "return_amt"
    credit = "store_credit" if prefix == "cr" else "account_credit"
    cols.update({
        p + "return_quantity": qty, p + amount: amt,
        p + "return_tax": np.round(amt * 0.05, 2),
        p + "return_amt_inc_tax": np.round(amt * 1.05, 2),
        p + "fee": fee, p + "return_ship_cost": ship_cost,
        p + "refunded_cash": np.round(amt * 0.7, 2),
        p + "reversed_charge": np.round(amt * 0.2, 2),
        p + credit: np.round(amt * 0.1, 2), p + "net_loss": net_loss})
    return pa.table(cols)


def inventory_table(rng: np.random.Generator, n: int,
                    rows: dict) -> pa.Table:
    """``n`` inventory rows by the catalog's formulas: a sale date, an
    item, a warehouse and 0-999 on hand."""
    return pa.table({
        "inv_date_sk": _dates(rng, n),
        "inv_item_sk": rng.integers(1, rows["item"] + 1, n).astype(np.int64),
        "inv_warehouse_sk": rng.integers(1, rows["warehouse"] + 1,
                                         n).astype(np.int64),
        "inv_quantity_on_hand": rng.integers(0, 1000, n).astype(np.int64),
    })


def _catalog_store_sales(rng: np.random.Generator, n: int,
                         rows: dict) -> pa.Table:
    """store_sales in the catalog's draw order (the amounts first)."""
    amounts = _amounts(rng, n, ship=False)
    cols = {"ss_sold_date_sk": _nullable(rng, _dates(rng, n), 0.02),
            "ss_sold_time_sk": _times(rng, n, rows["time_dim"])}
    cols["ss_item_sk"], = _fks(rng, n, rows, "item")
    cols["ss_customer_sk"] = _nullable(rng, *_fks(rng, n, rows, "customer"),
                                       0.03)
    for name, v in zip(("ss_cdemo_sk", "ss_hdemo_sk", "ss_addr_sk",
                        "ss_store_sk", "ss_promo_sk"),
                       _fks(rng, n, rows, "customer_demographics",
                            "household_demographics", "customer_address",
                            "store", "promotion")):
        cols[name] = v
    cols["ss_ticket_number"] = np.arange(n, dtype=np.int64) // 4 + 1
    for k, v in amounts.items():
        cols["ss_" + k] = v
    return pa.table(cols)


def generate(scale: float = 1.0, seed: int = 7) -> dict:
    """The JAX package's mini catalog (``tools/tpcds_schema.generate``),
    all 24 tables, from one ``default_rng(seed)`` in its draw order:
    equal to it table by table where it has at most 5 ship modes."""
    rng = np.random.default_rng(seed)
    rows = {k: max(4, int(v * scale)) for k, v in CATALOG_ROWS.items()}
    out = {"date_dim": make_date_dim(_D0, dt.date(2003, 12, 31)),
           "time_dim": make_time_dim(rows["time_dim"])}
    out["item"] = make_item(rng, rows["item"])
    out["customer_address"] = make_customer_address(
        rng, rows["customer_address"])
    out["customer_demographics"] = make_customer_demographics(
        rng, rows["customer_demographics"])
    out["income_band"] = make_income_band(rows["income_band"])
    out["household_demographics"] = make_household_demographics(
        rng, rows["household_demographics"], rows["income_band"])
    out["customer"] = make_customer(
        rng, rows["customer"], rows["customer_address"],
        rows["customer_demographics"], rows["household_demographics"])
    out["store"] = make_store(rng, rows["store"])
    out["warehouse"] = make_warehouse(rng, rows["warehouse"])
    out["ship_mode"] = make_ship_mode(rows["ship_mode"])
    out["reason"] = make_reason(rows["reason"])
    out["promotion"] = make_promotion(rng, rows["promotion"], rows["item"])
    out["call_center"] = make_call_center(rng, rows["call_center"])
    out["web_site"] = make_web_site(rng, rows["web_site"])
    out["web_page"] = make_web_page(rng, rows["web_page"])
    out["catalog_page"] = make_catalog_page(rng, rows["catalog_page"])
    out["store_sales"] = _catalog_store_sales(rng, rows["store_sales"], rows)
    out["store_returns"] = store_returns_table(
        rng, out["store_sales"], rows["store_returns"], rows)
    for prefix, name in (("cs", "catalog_sales"), ("ws", "web_sales")):
        out[name] = channel_sales_table(rng, prefix, rows[name], rows)
    for prefix, name, sales in (("cr", "catalog_returns", "catalog_sales"),
                                ("wr", "web_returns", "web_sales")):
        out[name] = channel_returns_table(rng, prefix, out[sales],
                                          rows[name], rows)
    out["inventory"] = inventory_table(rng, rows["inventory"], rows)
    return out


def write_channels(dirpath: str, scale: float = 1.0, seed: int = 5,
                   written: dict | None = None) -> dict:
    """The 11 tables as Parquet at ``scale`` times the spec's SF1 rows
    (``SF1_CHANNEL_DIMS``, ``SF1_CHANNEL_FACTS``), foreign keys inside
    the SF1 dimensions (``SF1_ROWS``; the store channel's ten reasons):
    each dimension one file, each fact table in its files, every file
    from its own seeded rng.  Order numbers continue across a fact's
    files; each returns row copies the keys of a sales row drawn from
    every file (read back).  ``written`` (table -> paths) names tables
    already on disk, which are kept.  Returns table -> paths."""
    os.makedirs(dirpath, exist_ok=True)
    out = {k: list(v) for k, v in (written or {}).items()}
    rows = {**SF1_ROWS, **SF1_CHANNEL_DIMS, "reason": len(_REASONS)}
    dims = {
        "warehouse": lambda r: make_warehouse(r, rows["warehouse"]),
        "ship_mode": lambda r: make_ship_mode(rows["ship_mode"]),
        "call_center": lambda r: make_call_center(r, rows["call_center"]),
        "web_site": lambda r: make_web_site(r, rows["web_site"]),
        "web_page": lambda r: make_web_page(r, rows["web_page"]),
        "catalog_page": lambda r: make_catalog_page(r, rows["catalog_page"]),
    }
    def rng(name, i=0):
        return np.random.default_rng([seed, CHANNEL_TABLES.index(name), i])

    for name, make in dims.items():
        if name not in out:
            path = os.path.join(dirpath, f"{name}.parquet")
            pq.write_table(make(rng(name)), path)
            out[name] = [path]

    def facts(name, make):
        if name in out:
            return
        total, n_files = SF1_CHANNEL_FACTS[name]
        total = max(n_files, round(total * scale))
        per = -(-total // n_files)
        paths = []
        for i in range(n_files):
            n = min(per, total - i * per)
            path = os.path.join(dirpath, f"{name}-{i}.parquet")
            pq.write_table(make(rng(name, i), n, i * per), path,
                           row_group_size=n)
            paths.append(path)
        out[name] = paths

    facts("catalog_sales", lambda r, n, first: channel_sales_table(
        r, "cs", n, rows, first))
    facts("web_sales", lambda r, n, first: channel_sales_table(
        r, "ws", n, rows, first))
    for name, prefix, sales, s in (
            ("catalog_returns", "cr", "catalog_sales", "cs"),
            ("web_returns", "wr", "web_sales", "ws")):
        keys = pa.concat_tables(pq.read_table(p, columns=[
            f"{s}_item_sk", f"{s}_order_number", f"{s}_bill_customer_sk"])
            for p in out[sales])
        facts(name, lambda r, n, first, p=prefix, k=keys:
              channel_returns_table(r, p, k, n, rows))
    facts("inventory", lambda r, n, first: inventory_table(r, n, rows))
    return {name: out[name] for name in CHANNEL_TABLES}
