"""The port's TPC-DS sweep (``spark_rapids_tpu_torch/tools/sweep.py``) on
the CPU, held against the JAX package's (``spark_rapids_tpu/tools/
sweep.py``) on the same texts and the same mini catalog.

Counterparts of ``tests/test_sweep.py``: every one of the 99 texts stops
at the same stage of parse and plan in both frontends (the corpus's
parse floor), with the same failure bucket; each grammar fix advances
the same texts in both (the fix probes, through
``frontends/sql.DISABLED_FEATURES``); the taxonomy classifier; and a
three-query slice end to end (the oracle and the connect wire subset)
classified as the JAX sweep classifies it.  The port's sweep writes no
file unless asked.
"""

from __future__ import annotations

import os

import pytest

from spark_rapids_tpu.frontends import sql as JSQL
from spark_rapids_tpu.tools import sweep as JS
from spark_rapids_tpu.tools.tpcds_queries import QUERIES as JQUERIES

from spark_rapids_tpu_torch.frontends import sql as PSQL
from spark_rapids_tpu_torch.tools import sweep as PS
from spark_rapids_tpu_torch.tpcds_queries import QUERIES
from torch_ops_isolation import ops_teardown

#: the card's slice: three texts of the wire subset
SLICE = (3, 42, 52)


@pytest.fixture(autouse=True)
def _clean():
    yield
    PSQL.DISABLED_FEATURES.clear()
    ops_teardown()


@pytest.fixture(scope="module")
def frontends():
    return JS.build_session(), PS.build_session(device="cpu")


def _parse_error(parser_cls, error_cls, text):
    try:
        parser_cls(text).parse_select()
    except error_cls as e:
        return str(e)
    return None


def test_the_corpus_is_the_jax_corpus():
    assert QUERIES == JQUERIES and len(QUERIES) == 99


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_parse_and_plan_stage_equals_jax(frontends, q):
    """Each text parses and plans (or stops) where the JAX sweep's does,
    and a parse error falls in the same taxonomy bucket."""
    jfe, pfe = frontends
    text = QUERIES[q]
    assert PS._parse_plan_stage(pfe, text) == JS._parse_plan_stage(jfe, text)
    got = _parse_error(PSQL._Parser, PSQL.SqlError, text)
    want = _parse_error(JSQL._Parser, JSQL.SqlError, text)
    assert (got is None) == (want is None)
    if got is not None:
        assert PS._classify_reason(got) == JS._classify_reason(want)


@pytest.mark.parametrize("feature", PS.FIX_FEATURES)
def test_fix_probes_equal_jax(frontends, monkeypatch, feature):
    """With one grammar fix disabled, the same texts fall back a stage in
    both frontends; the set is not empty, and the switch is cleared."""
    assert PS.FIX_FEATURES == JS.FIX_FEATURES
    jfe, pfe = frontends
    monkeypatch.setattr(PS, "FIX_FEATURES", (feature,))
    monkeypatch.setattr(JS, "FIX_FEATURES", (feature,))
    names = {0: "parse_error", 1: "plan_error", 2: "correct"}
    results = {f"q{q}": {"status": names[PS._parse_plan_stage(pfe, t)]}
               for q, t in QUERIES.items()}
    got = PS.fix_probes(pfe, dict(QUERIES), results)
    want = JS.fix_probes(jfe, dict(QUERIES), results)
    assert got == want and got[feature]
    assert PSQL.DISABLED_FEATURES == set()


@pytest.mark.parametrize("needle,bucket", PS._TAXONOMY)
def test_taxonomy_classifier(needle, bucket):
    msg = f"SqlError: at token 7: {needle.upper()} here"
    assert PS._classify_reason(msg) == JS._classify_reason(msg)
    # an earlier needle may claim the text first, in both alike
    assert PS._classify_reason(msg) in {b for _n, b in PS._TAXONOMY}


def test_taxonomy_is_the_jax_taxonomy():
    assert PS._TAXONOMY == JS._TAXONOMY
    assert PS._classify_reason("nothing known") == "other"


def test_slice_end_to_end_equals_jax():
    """Three texts through parse, plan, execution and the oracle, and
    through the connect server, classified as the JAX sweep classifies
    them: the same statuses and rows, every wire digest equal to the
    in-process collect."""
    got = PS.run_sweep(query_ids=list(SLICE), device="cpu")
    want = JS.run_sweep(query_ids=list(SLICE))
    for name, verdict in want["queries"].items():
        mine = got["queries"][name]
        assert (mine["status"], mine.get("rows")) \
            == (verdict["status"], verdict.get("rows")), name
    assert got["totals"]["correct"] == want["totals"]["correct"] == 3
    assert got["wire"] == want["wire"]
    assert all(v["digest_match"] for v in got["wire"].values())
    assert got["satellite_advances"] == want["satellite_advances"]
    md = PS.render_markdown(got)
    assert "**3/3 parsed · 3 planned · 3 executed · 3 correct" in md
    assert "| q42 | ok | True |" in md


def test_cli_writes_no_file_unless_asked(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert PS.main(["--queries", "52", "--device", "cpu", "--no-wire",
                    "--no-probes"]) == 0
    assert "parsed 1/1, planned 1, executed 1, correct 1" \
        in capsys.readouterr().out
    assert os.listdir(tmp_path) == []
