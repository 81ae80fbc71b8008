"""The fingerprints the serving tier keys by.

Copies of four functions of ``spark_rapids_tpu/eventlog/__init__.py``:
``conf_fingerprint`` (a conf epoch), ``plan_fingerprint`` (a plan text
with run-varying tokens normalized away), ``table_digest`` (the content
of an Arrow table) and ``render_plan_report`` (what
``DataFrame.explain()`` shows for a lowered plan).  The rest of the
JAX event log (writers, records, the history tools) is not ported.
"""

from __future__ import annotations

import hashlib
import json
import re

import pyarrow as pa

_PATH_RE = re.compile(r"(?:/[\w.\-]+){2,}")
_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")


def plan_fingerprint(plan_text: str) -> str:
    """A stable identity of a query template across runs: the plan
    text with temporary paths and object addresses normalized away,
    hashed."""
    norm = _ADDR_RE.sub("<addr>", plan_text)
    norm = _PATH_RE.sub("<path>", norm)
    return hashlib.sha256(norm.encode()).hexdigest()[:16]


def conf_fingerprint(conf) -> str:
    """Hash of the conf's explicitly set values: the conf epoch two
    lowered plans must share to be interchangeable."""
    payload = json.dumps(
        sorted((k, str(v)) for k, v in conf._values.items()))
    return hashlib.sha256(payload.encode()).hexdigest()[:12]


def table_digest(tbl: pa.Table) -> str:
    """Content digest of an Arrow table (its IPC stream bytes): two
    results are equal bit for bit when their digests are."""
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, tbl.schema) as w:
        for b in tbl.combine_chunks().to_batches():
            w.write_batch(b)
    return hashlib.sha256(memoryview(sink.getvalue())).hexdigest()[:16]


def render_plan_report(exec_, meta) -> str:
    """The tagged logical tree, the physical plan, the runtime-filter
    sites and the UDF tiers: exactly ``DataFrame.explain()``'s text for
    a lowered plan."""
    from spark_rapids_tpu_torch.plan.runtime_filter import (
        render_runtime_filters,
    )
    from spark_rapids_tpu_torch.session import render_udfs

    return "\n".join([meta.explain().rstrip("\n"), exec_.tree_string(),
                      *render_runtime_filters(exec_),
                      *render_udfs(meta.plan)])
