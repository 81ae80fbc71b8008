"""Store-channel TPC-DS texts through the port's SQL frontend against the
JAX engine (``collect(engine="tpu")``, on the JAX CPU backend here), as
a second reference beside the CPU oracle of ``test_torch_tpcds_texts``:
q7 (AVG over a five-way star join), q43 (CASE inside SUM), q79
(``substr`` of a group key, a derived table) and q84's variant
(``upper`` / ``lower`` are not in it; ``concat`` and ``coalesce`` of
customer names are).  Same data, tolerance and comparison as there:
the JAX sweep's catalog, names, integers, strings and NULLs exact,
floats to a relative 1e-12 (``_significant``, then ``approx_float``).
"""

import pytest

from differential import assert_tables_equal
from spark_rapids_tpu_torch.tpcds_queries import QUERIES, variant
from test_torch_q1 import _significant
from test_torch_tpcds_texts import catalog, oracle, port  # noqa: F401

TEXTS = {"q7": QUERIES[7], "q43": QUERIES[43], "q79": QUERIES[79],
         "q84": QUERIES[84], "q84_variant": variant(84)}


@pytest.mark.parametrize("name", list(TEXTS))
def test_text_equals_the_jax_engine(name, port, oracle):  # noqa: F811
    got = port.sql(TEXTS[name]).collect()
    want = oracle.sql(TEXTS[name]).collect(engine="tpu")
    assert_tables_equal(_significant(got), _significant(want),
                        approx_float=True)
    assert got.num_rows > 0 or name == "q84"
