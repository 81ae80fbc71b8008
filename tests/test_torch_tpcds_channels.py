"""The 29 catalog and web TPC-DS texts as written, through the port's
SQL frontend on the CPU, against the JAX package's CPU oracle; the
port's copy of the whole mini catalog and of its writer for the card.

As ``test_torch_tpcds_texts.py`` holds the 22 store-channel texts: the
data is the JAX sweep's (``tools/tpcds_schema.generate(1.0, seed=7)``),
which the port reads from Parquet with its fact tables in several files
(``scan.taskTargetBytes`` = 1: every file a scan task, so the
aggregates and joins plan their hash exchanges); the oracle is the JAX
frontend's plan of the same text run by ``cpu/engine.execute_cpu``.
Results compare under ``differential.assert_tables_equal``: integers,
strings and NULLs exact, floats after ``_significant``; rows as
multisets.

q37 filters date_dim by ``cast('2000-02-01' as date)``, a cast the
device path lacks: the Filter runs on the port's CPU engine, as the JAX
package runs it on its own.

q4, q11, q31, q74 and q97 read columns of two frames that expose the
same names in a CASE; the JAX frontend leaves the qualified references
in a CASE's branches unresolved, so each branch reads the first frame's
column: q4, q11, q31 and q74 give no rows there (``SWEEP_r01.json``),
and q97 counts every pair as in both channels.  The port resolves them,
as Spark does, so the oracle runs those texts with each CASE spelled as
``if(...)``, whose references it resolves (``case_as_if``).

Texts that give no rows on this catalog run their variants
(``tpcds_queries.VARIANT_EDITS``) too, against the same oracle.
"""

import re

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.tools import tpcds_schema
from spark_rapids_tpu.tools.sweep import build_session
from spark_rapids_tpu.tools.tpcds_queries import QUERIES as JQUERIES

from differential import assert_tables_equal
from spark_rapids_tpu_torch import tpcds
from spark_rapids_tpu_torch.frontends.sql import SqlSession
from spark_rapids_tpu_torch.tpcds_queries import (
    CATALOG_WEB,
    QUERIES,
    STORE_CHANNEL,
    VARIANT_EDITS,
    variant,
)
from test_torch_q1 import _significant

SCALE, SEED = 1.0, 7
TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
#: fact tables written in several files
FILES = {"store_sales": 3, "catalog_sales": 3, "web_sales": 2,
         "inventory": 2}
#: the sweep's row counts (SWEEP_r01.json)
SWEEP_ROWS = {2: 2513, 4: 0, 11: 0, 15: 52, 22: 100, 23: 1, 25: 0, 26: 20,
              29: 0, 31: 0, 33: 53, 37: 0, 40: 1, 49: 0, 56: 0, 58: 0,
              60: 27, 66: 6, 71: 1, 72: 0, 74: 0, 75: 31, 76: 0, 78: 14,
              80: 51, 82: 0, 83: 0, 91: 0, 97: 1}
#: the port's rows of the texts whose CASE the JAX frontend misreads
CASE_TEXTS = {4: 100, 11: 100, 31: 1, 74: 100, 97: 1}
_CASE = re.compile(r"case\s+when\s+(.+?)\s+then\s+(.+?)\s+else\s+(.+?)\s+end",
                   re.S)


def case_as_if(text: str) -> str:
    """Each ``case when c then a else b end`` of ``text`` as
    ``if(c, a, b)``."""
    return _CASE.sub(r"if(\1, \2, \3)", text)


@pytest.fixture(scope="module")
def catalog():
    return tpcds_schema.generate(SCALE, seed=SEED)


@pytest.fixture(scope="module")
def port(tmp_path_factory, catalog):
    d = tmp_path_factory.mktemp("tpcds_channels")
    fe = SqlSession({TTB: 1}, device="cpu")
    for name, t in catalog.items():
        n = FILES.get(name, 1)
        per = -(-t.num_rows // n)
        paths = [str(d / f"{name}-{i}.parquet") for i in range(n)]
        for i, p in enumerate(paths):
            pq.write_table(t.slice(i * per, per), p)
        fe.register_parquet(name, *paths)
    return fe


@pytest.fixture(scope="module")
def oracle():
    return build_session(SCALE, SEED)


def _check(port, oracle, q, text):
    got = port.sql(text).collect()
    want = oracle.sql(case_as_if(text) if q in CASE_TEXTS
                      else text).collect(engine="cpu")
    assert_tables_equal(_significant(got), _significant(want),
                        approx_float=True)
    return got


@pytest.mark.parametrize("q", CATALOG_WEB)
def test_text_equals_the_jax_cpu_oracle(q, port, oracle):
    got = _check(port, oracle, q, QUERIES[q])
    assert got.num_rows == CASE_TEXTS.get(q, SWEEP_ROWS[q])


@pytest.mark.parametrize("q", sorted(set(VARIANT_EDITS) & set(CATALOG_WEB)))
def test_variant_gives_rows_and_equals_the_jax_cpu_oracle(q, port, oracle):
    assert SWEEP_ROWS[q] == 0
    assert _check(port, oracle, q, variant(q)).num_rows > 0


def test_every_zero_row_text_has_a_variant():
    zero = {q for q in CATALOG_WEB if SWEEP_ROWS[q] == 0} - set(CASE_TEXTS)
    assert zero == set(VARIANT_EDITS) & set(CATALOG_WEB)


def test_queries_equal_the_jax_texts():
    assert QUERIES == JQUERIES
    assert set(CATALOG_WEB) <= set(QUERIES)
    assert not set(CATALOG_WEB) & set(STORE_CHANNEL)


def test_the_51_texts_are_the_sweeps_correct_ones():
    import json
    import os

    sweep = json.load(open(os.path.join(os.path.dirname(__file__), "..",
                                        "SWEEP_r01.json")))
    correct = {int(k[1:]) for k, v in sweep["queries"].items()
               if v["status"] == "correct"}
    assert correct == set(CATALOG_WEB) | set(STORE_CHANNEL)
    assert {q: sweep["queries"][f"q{q}"]["rows"] for q in CATALOG_WEB} \
        == SWEEP_ROWS


def test_case_branches_resolve_qualified_references(port):
    """The frontend resolves ``alias.col`` inside a CASE's branches to
    the self-join's renamed column, as it does elsewhere."""
    text = """
select a.d_date_sk x,
       case when a.d_date_sk > 0 then b.d_date_sk else 0 end y
from date_dim a, date_dim b
where a.d_date_sk = b.d_date_sk - 1 and a.d_date_sk < 2450820
order by x"""
    t = port.sql(text).collect()
    assert t["y"].to_pylist() == [x + 1 for x in t["x"].to_pylist()]


@pytest.mark.parametrize("scale,seed", [(1.0, 7), (0.3, 21)])
def test_catalog_equals_the_reference_table_by_table(scale, seed):
    """``tpcds.generate`` draws what ``tpcds_schema.generate`` draws, in
    its order, vectorised (at most 5 ship modes there)."""
    ours = tpcds.generate(scale, seed)
    ref = tpcds_schema.generate(scale, seed)
    assert set(ours) == set(ref)
    for name, table in ref.items():
        assert ours[name].equals(table), name


def test_ship_modes_cycle_past_the_references_five():
    ref = tpcds_schema._ship_mode(5)
    assert tpcds.make_ship_mode(5).equals(ref)
    sm = tpcds.make_ship_mode(20)
    for c in ("sm_type", "sm_code", "sm_carrier"):
        assert sm[c].to_pylist() == ref[c].to_pylist() * 4
    with pytest.raises(ValueError):
        tpcds_schema._ship_mode(6)


def test_write_channels_lays_out_every_table(tmp_path):
    scale = 0.01
    paths = tpcds.write_channels(str(tmp_path), scale=scale)
    assert tuple(paths) == tpcds.CHANNEL_TABLES
    rows = {k: sum(pq.read_metadata(p).num_rows for p in v)
            for k, v in paths.items()}
    for name, (n, files) in tpcds.SF1_CHANNEL_FACTS.items():
        assert len(paths[name]) == files, name
        assert rows[name] == round(n * scale), name
    for name, n in tpcds.SF1_CHANNEL_DIMS.items():
        assert rows[name] == n, name
    dims = {**tpcds.SF1_ROWS, **tpcds.SF1_CHANNEL_DIMS, "reason": 10}

    def read(name):
        return pa.concat_tables(pq.read_table(p) for p in paths[name])

    def inside(t, column, dim):
        c = t[column].drop_null()
        assert 1 <= pc.min(c).as_py() and pc.max(c).as_py() <= dims[dim], \
            column

    cs, ws = read("catalog_sales"), read("web_sales")
    for t, p in ((cs, "cs"), (ws, "ws")):
        for col, dim in (("bill_customer_sk", "customer"),
                         ("ship_cdemo_sk", "customer_demographics"),
                         ("bill_hdemo_sk", "household_demographics"),
                         ("ship_addr_sk", "customer_address"),
                         ("ship_mode_sk", "ship_mode"),
                         ("warehouse_sk", "warehouse"), ("item_sk", "item"),
                         ("promo_sk", "promotion")):
            inside(t, f"{p}_{col}", dim)
        # order numbers continue across files: three rows an order
        orders = t[f"{p}_order_number"].to_numpy()
        assert (orders == np.arange(len(orders)) // 3 + 1).all()
    inside(cs, "cs_call_center_sk", "call_center")
    inside(cs, "cs_catalog_page_sk", "catalog_page")
    inside(ws, "ws_web_page_sk", "web_page")
    inside(ws, "ws_web_site_sk", "web_site")
    for r, sales, p, s in (("catalog_returns", cs, "cr", "cs"),
                           ("web_returns", ws, "wr", "ws")):
        t = read(r)
        inside(t, f"{p}_reason_sk", "reason")
        inside(t, f"{p}_returning_customer_sk", "customer")
        # each return copies the keys of a sale
        sold = set(zip(sales[f"{s}_item_sk"].to_pylist(),
                       sales[f"{s}_order_number"].to_pylist()))
        assert set(zip(t[f"{p}_item_sk"].to_pylist(),
                       t[f"{p}_order_number"].to_pylist())) <= sold
    inv = read("inventory")
    inside(inv, "inv_item_sk", "item")
    inside(inv, "inv_warehouse_sk", "warehouse")


def test_in_over_dates_equals_the_jax_engine():
    """``In`` over a DATE column compares day numbers, as the JAX ``In``
    does (q83's ``d_date in (date '2000-06-30', ...)``, whose literals
    the frontend folds to day numbers), NULL rows and a NULL in the list
    included."""
    import datetime as dt

    from spark_rapids_tpu.exprs.predicates import In as JIn
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu.session import col as jcol

    from spark_rapids_tpu_torch import TorchSession, col
    from spark_rapids_tpu_torch.exprs.predicates import In

    rng = np.random.default_rng(83)
    days = rng.integers(11000, 11020, 64).astype(np.int32)
    t = pa.table({"d": pa.array(days, pa.int32(), mask=rng.random(64) < 0.2)
                  .cast(pa.date32())})
    lists = [(11005, 11010), (11005, None), (11019,), (None,),
             ((dt.date(2000, 2, 1) - dt.date(1970, 1, 1)).days,)]
    got = TorchSession(device="cpu").create_dataframe(t).select(
        col("d"), *[In(col("d"), v).alias(f"c{i}")
                    for i, v in enumerate(lists)]).collect()
    jdf = TpuSession().create_dataframe(t).select(
        jcol("d"), *[JIn(jcol("d"), v).alias(f"c{i}")
                     for i, v in enumerate(lists)])
    for engine in ("tpu", "cpu"):
        assert_tables_equal(got, jdf.collect(engine=engine),
                            ignore_order=False)
    assert got["c0"].null_count == t["d"].null_count
    assert got["c3"].null_count == 64


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
