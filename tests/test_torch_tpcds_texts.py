"""The 22 store-channel TPC-DS texts as written, through the port's SQL
frontend on the CPU, against the JAX package's CPU oracle; the port's
copies of the query texts and of the catalog's dimension generators.

The data is the JAX sweep's: ``tools/tpcds_schema.generate(1.0,
seed=7)``.  The port reads it from Parquet (store_sales in three files,
``scan.taskTargetBytes`` = 1, so every file is a scan task and the
aggregates and joins plan their hash exchanges); the oracle is the JAX
frontend's plan of the same text over the same tables run by
``cpu/engine.execute_cpu`` (``collect(engine="cpu")``), as
``tools/sweep.py::classify_query`` runs it.  Results compare under
``differential.assert_tables_equal``: column names, integers, strings
and NULLs exact; floats after rounding to 12 significant digits and
then 9 decimals (``_significant``, ``approx_float``: a relative 1e-12,
since sums add in another order).  Rows compare as multisets; a text's
ORDER BY and LIMIT are the same on both sides.

q24, q27, q34 and q84 give no rows on this catalog (SWEEP_r01.json);
their variants (``tpcds_queries.VARIANT_EDITS``) give rows and are held
the same way.
"""

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
    QUERIES,
    STORE_CHANNEL,
    VARIANT_EDITS,
    variant,
)
from test_torch_q1 import _significant

SCALE, SEED, SALES_FILES = 1.0, 7, 3
TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
#: the sweep's row counts of the texts that give rows (SWEEP_r01.json)
SWEEP_ROWS = {3: 12, 5: 12, 7: 43, 13: 1, 24: 0, 27: 0, 34: 0, 42: 4,
              43: 8, 46: 100, 48: 1, 50: 12, 52: 5, 55: 2, 59: 100, 67: 100,
              68: 26, 73: 2, 79: 100, 84: 0, 93: 100, 96: 1}


@pytest.fixture(scope="module")
def catalog():
    return tpcds_schema.generate(SCALE, seed=SEED)


@pytest.fixture(scope="module")
def port(tmp_path_factory, catalog):
    d = tmp_path_factory.mktemp("tpcds_texts")
    fe = SqlSession({TTB: 1}, device="cpu")
    for name in tpcds.STORE_CHANNEL_TABLES:
        t = catalog[name]
        if name == "store_sales":
            per = -(-t.num_rows // SALES_FILES)
            paths = [str(d / f"{name}-{i}.parquet") for i in range(SALES_FILES)]
            for i, p in enumerate(paths):
                pq.write_table(t.slice(i * per, per), p)
        else:
            paths = [str(d / f"{name}.parquet")]
            pq.write_table(t, paths[0])
        fe.register_parquet(name, *paths)
    return fe


@pytest.fixture(scope="module")
def oracle():
    return build_session(SCALE, SEED)


def _check(port, oracle, text):
    got = port.sql(text).collect()
    want = oracle.sql(text).collect(engine="cpu")
    assert_tables_equal(_significant(got), _significant(want),
                        approx_float=True)
    return got


@pytest.mark.parametrize("q", STORE_CHANNEL)
def test_text_equals_the_jax_cpu_oracle(q, port, oracle):
    got = _check(port, oracle, QUERIES[q])
    assert got.num_rows == SWEEP_ROWS[q]


@pytest.mark.parametrize("q", sorted(set(VARIANT_EDITS) & set(STORE_CHANNEL)))
def test_variant_gives_rows_and_equals_the_jax_cpu_oracle(q, port, oracle):
    assert SWEEP_ROWS[q] == 0
    assert _check(port, oracle, variant(q)).num_rows > 0


def test_queries_equal_the_jax_texts():
    assert QUERIES == JQUERIES
    assert set(STORE_CHANNEL) <= set(QUERIES)


def test_dimensions_equal_the_catalog_for_the_same_rng_state(catalog):
    """``generate``'s draws replayed: the port's generators (and the
    reference's ``_warehouse``, to draw what it draws) from
    ``default_rng(seed)`` in ``generate``'s order give its tables."""
    rows = {k: max(4, int(v * SCALE)) for k, v in tpcds_schema.ROWS.items()}
    rng = np.random.default_rng(SEED)
    ours = {"time_dim": tpcds.make_time_dim(rows["time_dim"])}
    ours["item"] = tpcds.make_item(rng, rows["item"])
    ours["customer_address"] = tpcds.make_customer_address(
        rng, rows["customer_address"])
    ours["customer_demographics"] = tpcds.make_customer_demographics(
        rng, rows["customer_demographics"])
    ours["income_band"] = tpcds.make_income_band(rows["income_band"])
    ours["household_demographics"] = tpcds.make_household_demographics(
        rng, rows["household_demographics"], rows["income_band"])
    ours["customer"] = tpcds.make_customer(
        rng, rows["customer"], rows["customer_address"],
        rows["customer_demographics"], rows["household_demographics"])
    ours["store"] = tpcds.make_store(rng, rows["store"])
    tpcds_schema._warehouse(rng, rows["warehouse"])
    ours["promotion"] = tpcds.make_promotion(rng, rows["promotion"],
                                             rows["item"])
    for name, table in ours.items():
        assert table.equals(catalog[name]), name


@pytest.mark.parametrize("seed", [0, 99])
def test_new_dimensions_equal_the_reference_generators(seed):
    def both(port_fn, ref_fn):
        return (port_fn(np.random.default_rng(seed)),
                ref_fn(np.random.default_rng(seed)))

    days = tpcds_schema._DAYS
    pairs = [
        both(lambda r: tpcds.make_customer(r, 300, 50, 70, 20),
             lambda r: tpcds_schema._customer(r, 300, 50, 70, 20, days)),
        both(lambda r: tpcds.make_customer_address(r, 200),
             lambda r: tpcds_schema._customer_address(r, 200)),
        both(lambda r: tpcds.make_household_demographics(r, 100, 7),
             lambda r: tpcds_schema._household_demographics(r, 100, 7)),
        both(lambda r: tpcds.make_promotion(r, 40, 90),
             lambda r: tpcds_schema._promotion(r, 40, 90, days)),
        (tpcds.make_time_dim(86400), tpcds_schema._time_dim(86400)),
        (tpcds.make_income_band(), tpcds_schema._income_band(20)),
    ]
    for ours, ref in pairs:
        assert ours.equals(ref)


def test_write_store_channel_lays_out_every_table(tmp_path):
    paths = tpcds.write_store_channel(str(tmp_path), n_files=2,
                                      rows_per_file=1 << 10)
    assert tuple(paths) == tpcds.STORE_CHANNEL_TABLES
    assert len(paths["store_sales"]) == 2
    rows = {k: sum(pq.read_metadata(p).num_rows for p in v)
            for k, v in paths.items()}
    sf1 = tpcds.SF1_ROWS
    assert rows["store_sales"] == 2 << 10
    for name in ("item", "customer", "customer_address",
                 "customer_demographics", "household_demographics",
                 "promotion", "store", "time_dim", "income_band"):
        assert rows[name] == sf1[name], name
    assert rows["date_dim"] == 73049 and rows["reason"] == 10
    # every store_sales key lands inside its dimension
    ss = pa.concat_tables(pq.read_table(p) for p in paths["store_sales"])
    for col, dim in (("ss_customer_sk", "customer"),
                     ("ss_hdemo_sk", "household_demographics"),
                     ("ss_addr_sk", "customer_address"),
                     ("ss_promo_sk", "promotion")):
        assert 1 <= pc.min(ss[col]).as_py()
        assert pc.max(ss[col]).as_py() <= sf1[dim]


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
