"""The port's operator tools on the CPU (``spark_rapids_tpu_torch/tools/``:
``qualification``, ``api_validation``, ``gen_docs``, ``top``, ``trace``),
held against the JAX package's.

Counterparts of ``tests/test_tools.py``'s ``test_qualification_*`` and
``test_api_validation_counts`` and of
``tests/test_lint.py::test_api_validation_drift_is_hard``: ``qualify``
over the 51 TPC-DS texts the card runs, against the JAX tool on the
same texts over the same mini catalog (operators, device and fallback
counts, reasons); the multi-query report; the port covering every
reference rule the JAX package covers; the generated documents;
``top --once`` against a live port ops plane with a query in flight; and
the trace tool over a small script.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.tools import api_validation as JA
from spark_rapids_tpu.tools import qualification as JQ
from spark_rapids_tpu.tools import sweep as JS

from spark_rapids_tpu_torch import TorchSession, col, lit, obs, sum_
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.exprs.strings import GetJsonObject
from spark_rapids_tpu_torch.tools import api_validation as PA
from spark_rapids_tpu_torch.tools import gen_docs, top
from spark_rapids_tpu_torch.tools import qualification as PQ
from spark_rapids_tpu_torch.tools import sweep as PS
from spark_rapids_tpu_torch.tools import trace as trace_tool
from spark_rapids_tpu_torch.tpcds_queries import (
    CATALOG_WEB,
    QUERIES,
    STORE_CHANNEL,
)
from torch_ops_isolation import ops_teardown

TEXTS = sorted(set(STORE_CHANNEL) | set(CATALOG_WEB))

#: the port planner's wording of a reason -> the JAX planner's
_WORDING = (("on the GPU", "on TPU"), ("is not ported", "not supported"))


@pytest.fixture(autouse=True)
def _clean():
    yield
    ops_teardown()


@pytest.fixture(scope="module")
def frontends():
    return JS.build_session(), PS.build_session(device="cpu")


def _jax_wording(reasons: dict) -> dict:
    out = {}
    for r, n in reasons.items():
        for port, jax in _WORDING:
            r = r.replace(port, jax)
        out[r] = n
    return out


# -- qualification ------------------------------------------------------ #

def test_the_texts_are_the_cards():
    assert len(TEXTS) == 51


@pytest.mark.parametrize("q", TEXTS)
def test_qualify_equals_the_jax_tool(frontends, q):
    """The tagging walk over the same text and catalog: the same
    operators, the same device and fallback split, the same reasons
    (in each planner's wording).  Both tag the plan as written, so a
    scalar subquery, which the planners run while planning, counts as a
    fallback in both."""
    jfe, pfe = frontends
    want = JQ.qualify(jfe.sql(QUERIES[q]))
    got = PQ.qualify(pfe.sql(QUERIES[q]))
    assert (got.total_ops, got.tpu_ops, got.fallback_ops) \
        == (want.total_ops, want.tpu_ops, want.fallback_ops)
    assert _jax_wording(got.reasons) == want.reasons
    assert got.eligible_fraction == want.eligible_fraction
    assert got.recommendation == want.recommendation
    assert got.explain.count("\n") == got.total_ops


def _table(n: int = 1024) -> pa.Table:
    rng = np.random.default_rng(11)
    return pa.table({
        "k": rng.integers(0, 8, n).astype(np.int64),
        "v": rng.integers(0, 100, n).astype(np.int64),
        "j": pa.array(['{"a": %d}' % i for i in range(n)]),
    })


def test_qualify_dataframe_fallback_and_report():
    """A projection the GPU cannot run (get_json_object) is the one
    fallback node of its plan, with its reason; the report sums the
    queries' reasons."""
    s = TorchSession(device="cpu")
    base = s.create_dataframe(_table())
    ok = base.group_by(col("k")).agg((sum_(col("v")), "sv"))
    bad = base.select(GetJsonObject(col("j"), lit("$.a")).alias("a"))
    r_ok, r_bad = PQ.qualify(ok), PQ.qualify(bad)
    assert (r_ok.total_ops, r_ok.fallback_ops) == (2, 0)
    assert r_ok.recommendation == "strongly recommended"
    assert (r_bad.total_ops, r_bad.tpu_ops, r_bad.fallback_ops) == (2, 1, 1)
    assert r_bad.recommendation == "recommended"
    (reason,) = r_bad.reasons
    assert "get_json_object" in reason and reason in r_bad.explain
    report = PQ.qualification_report([ok, bad], ["agg", "json"])
    assert "| agg | 2 | 2 | 0 | 100% | strongly recommended |" in report
    assert "| json | 2 | 1 | 1 | 50% | recommended |" in report
    assert f"- 1x {reason}" in report


# -- api validation ----------------------------------------------------- #

def test_api_validation_covers_what_the_jax_package_covers():
    """Every reference rule the JAX package covers, the port covers too,
    and its map resolves with no drift; a difference is named."""
    jv, pv = JA.validate(), PA.validate()
    assert PA.REFERENCE_EXPRESSIONS == JA.REFERENCE_EXPRESSIONS
    assert PA.REFERENCE_EXECS == JA.REFERENCE_EXECS
    missing_exprs = sorted(set(jv["expressions"][0])
                           - set(pv["expressions"][0]))
    missing_execs = sorted(set(jv["execs"][0]) - set(pv["execs"][0]))
    assert missing_exprs == [] and missing_execs == [], (
        f"the JAX package covers, the port does not: expressions "
        f"{missing_exprs}, execs {missing_execs}")
    assert pv["exec_drift"] == []
    PA.assert_no_drift()
    c = PA.counts()
    assert c["expressions"] == len(set(PA.REFERENCE_EXPRESSIONS))
    assert c["execs"] == len(PA.REFERENCE_EXECS)
    assert pv["scans"] == jv["scans"]
    assert pv["partitionings"] == jv["partitionings"]


def test_api_validation_drift_is_hard(monkeypatch):
    """A map entry whose class vanished is drift, and drift raises."""
    monkeypatch.setitem(PA._EXEC_MAP, "FilterExec", (
        "spark_rapids_tpu_torch.execs.basic", "TpuGoneExec", ""))
    assert PA.validate()["exec_drift"] == ["FilterExec"]
    with pytest.raises(AssertionError, match="FilterExec"):
        PA.assert_no_drift()


# -- gen_docs ----------------------------------------------------------- #

def test_gen_docs_into_a_directory(tmp_path):
    from spark_rapids_tpu_torch.plan import planner as PL

    out = gen_docs.main(str(tmp_path / "docs"))
    assert sorted(os.path.basename(p) for p in out) == [
        "api_coverage.md", "configs.md", "supported_ops.md"]
    ops = (tmp_path / "docs" / "supported_ops.md").read_text()
    for cls, key in PL.SUPPORTED_EXPRS.items():
        assert f"| {cls.__name__} |" in ops and f"`{key}`" in ops
    for key in PL.EXEC_SWITCHES.values():
        assert f"`{key}`" in ops
    configs = (tmp_path / "docs" / "configs.md").read_text()
    assert f"| `{C.PERSIST_MAX_BYTES}` | `{512 << 20}` |" in configs
    assert "spark.rapids.tpu.sql.expression." not in configs
    coverage = (tmp_path / "docs" / "api_coverage.md").read_text()
    assert coverage == PA.coverage_md()
    assert "**missing**" not in coverage


# -- top ---------------------------------------------------------------- #

def test_top_once_against_a_live_plane(capsys):
    """One frame of ``top --once`` against the port's plane with a query
    in flight (a stream drained halfway): the gauges, the query under
    its tenant, and after it ends the tenant's SLO line.  The tool
    imports no torch module of its own."""
    obs.start(port=0)
    url = f"http://127.0.0.1:{obs.plane().port}"
    s = TorchSession({C.BATCH_ROWS: 256}, device="cpu", tenant="topper")
    prepared = s.prepare(s.create_dataframe(_table()).group_by(col("k"))
                         .agg((sum_(col("v")), "sv")).order_by(col("k")))
    gen = prepared.execute_stream(batch_rows=2)
    next(gen)
    assert top.main(["--url", url, "--once"]) == 0
    frame = capsys.readouterr().out
    assert "in flight: 1" in frame and "in-flight queries (1):" in frame
    assert "topper" in frame
    rest = list(gen)
    assert rest
    assert top.main(["--url", url, "--once"]) == 0
    frame = capsys.readouterr().out
    assert "in-flight queries (0):" in frame
    slo = frame[frame.index("slo (window"):]
    assert "topper" in slo
    obs.stop()
    assert top.main(["--url", url, "--once"]) == 1


def test_top_imports_no_engine():
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; import spark_rapids_tpu_torch.tools.top; "
            "print(sorted(m for m in sys.modules if m.startswith("
            "('torch', 'spark_rapids_tpu_torch'))))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60,
                          env=dict(os.environ, PYTHONPATH=repo))
    assert proc.returncode == 0, proc.stderr
    mods = json.loads(proc.stdout.replace("'", '"'))
    assert not [m for m in mods if m == "torch" or m.startswith("torch.")]


# -- trace -------------------------------------------------------------- #

SCRIPT = """
import sys
import numpy as np, pyarrow as pa
from spark_rapids_tpu_torch import TorchSession, col, sum_
t = pa.table({"k": np.arange(512) % 4, "v": np.arange(512)})
s = TorchSession(device="cpu")
out = s.create_dataframe(t).group_by(col("k")).agg((sum_(col("v")), "sv"))
assert out.collect().num_rows == 4
assert sys.argv[1:] == ["--flag", "x"]
"""


def test_trace_tool_over_a_script(tmp_path, capsys):
    """The tool runs the script with tracing forced on (no key set) and
    writes a Chrome trace of its query's spans."""
    script = tmp_path / "work.py"
    script.write_text(SCRIPT)
    out = tmp_path / "trace.json"
    assert trace_tool.main(["-o", str(out), str(script), "--flag", "x"]) == 0
    assert f"wrote {out}" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"query.plan", "query.execute"} <= names
    failing = tmp_path / "fails.py"
    failing.write_text(SCRIPT + "raise SystemExit(3)\n")
    out.unlink()
    # the script's exit code, and the trace written all the same
    assert trace_tool.main(["-o", str(out), str(failing), "--flag",
                            "x"]) == 3
    assert json.loads(out.read_text())["traceEvents"]
