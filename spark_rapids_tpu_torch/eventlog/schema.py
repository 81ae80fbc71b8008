"""Versioned record schema for the persistent event log.

The reference's tooling (ProfileMain / ApplicationInfo) works because
Spark's event-log format is a stable, versioned contract that readers
from a different release can still parse.  This module is that
contract for the TPU engine: every record the writer emits validates
against the field specs below, and the reader deliberately IGNORES
unknown fields so a newer engine's logs stay loadable by older tools
(forward compatibility is tested in tests/test_eventlog.py).

Rules of evolution:
- adding an OPTIONAL field: allowed within a schema version (readers
  must tolerate unknown fields);
- adding a REQUIRED field, renaming, or retyping: bump
  ``SCHEMA_VERSION`` and teach :func:`validate_record` both shapes.
"""

from __future__ import annotations

from typing import Any

#: bump on any backward-incompatible record-shape change (see module doc)
SCHEMA_VERSION = 1

#: record types the writer emits
RECORD_TYPES = ("header", "query", "telemetry", "slo")

#: required fields per record type: name -> allowed python types.
#: Anything NOT listed here is optional-by-construction; readers must
#: not choke on extras (the forward-compat contract).
REQUIRED_FIELDS: dict[str, dict[str, tuple]] = {
    "header": {
        "type": (str,),
        "schema_version": (int,),
        "ts": (int, float),
        "session": (str,),
        "pid": (int,),
        "env": (dict,),
        "conf": (dict,),
        "conf_hash": (str,),
    },
    "query": {
        "type": (str,),
        "schema_version": (int,),
        "query_id": (int,),
        "plan": (str,),
        "plan_hash": (str,),
        "engine": (str,),
        "wall_s": (int, float),
        "start_ts": (int, float),
        "end_ts": (int, float),
        "start_ns": (int,),
        "end_ns": (int,),
        "conf_hash": (str,),
        "counters": (dict,),
    },
    # one live-telemetry gauge sample (trace/telemetry.py): appended
    # by the sampler thread between query records; `counters` is the
    # flat sample_now() dict (store tiers, semaphore, admission queue,
    # pipeline occupancy)
    "telemetry": {
        "type": (str,),
        "schema_version": (int,),
        "ts": (int, float),
        "session": (str,),
        "counters": (dict,),
    },
    # one SLO breach (obs/slo.py): a tenant's rolling percentile went
    # over its spark.rapids.tpu.obs.slo.* budget — appended by the
    # watchdog thread; the HC016 health rule's input (tools/history)
    "slo": {
        "type": (str,),
        "schema_version": (int,),
        "ts": (int, float),
        "session": (str,),
        "tenant": (str,),
        "metric": (str,),
        "observed_ms": (int, float),
        "budget_ms": (int, float),
        "window": (int,),
    },
}

#: optional fields we still type-check WHEN present
OPTIONAL_FIELDS: dict[str, dict[str, tuple]] = {
    "header": {
        "mesh": (dict, type(None)),
    },
    "query": {
        "operators": (dict, type(None)),
        "spans": (dict, type(None)),
        "pipeline": (dict, type(None)),
        "faults": (dict, type(None)),
        "serving": (dict, type(None)),
        # cross-tenant work sharing (serving/work_share.py): the
        # result-cache verdict for this query plus its share.*
        # counter deltas — None when the sharing tier never engaged
        "sharing": (dict, type(None)),
        # wire-ingress provenance (connect/server.py): peer address,
        # request wire bytes and plan-translate ms — present only for
        # queries that arrived over the connect front door
        "connect": (dict, type(None)),
        # device-ledger attribution for this query (trace/ledger.py):
        # {"programs": {key: {...}}, "totals": {...}} — present only
        # when the ledger was enabled for the query
        "programs": (dict, type(None)),
        "result_digest": (str, type(None)),
        "trace_file": (str, type(None)),
        "rows": (int, type(None)),
    },
    "telemetry": {},
    "slo": {},
}


class SchemaError(ValueError):
    """An emitted/loaded record violates the versioned contract."""


def _check_operator_node(node: Any, where: str) -> None:
    if not isinstance(node, dict):
        raise SchemaError(f"{where}: operator node must be an object")
    if not isinstance(node.get("desc"), str):
        raise SchemaError(f"{where}: operator node missing 'desc'")
    if not isinstance(node.get("metrics"), dict):
        raise SchemaError(f"{where}: operator node missing 'metrics'")
    kids = node.get("children", [])
    if not isinstance(kids, list):
        raise SchemaError(f"{where}: operator children must be a list")
    for i, c in enumerate(kids):
        _check_operator_node(c, f"{where}.children[{i}]")


def validate_record(rec: Any) -> dict:
    """Validate one decoded JSONL record against the versioned schema;
    returns the record (for chaining).  Unknown EXTRA fields are
    explicitly allowed — only missing/mistyped required fields (and
    mistyped known-optional fields) raise :class:`SchemaError`."""
    if not isinstance(rec, dict):
        raise SchemaError("record must be a JSON object")
    rtype = rec.get("type")
    if rtype not in RECORD_TYPES:
        raise SchemaError(f"unknown record type {rtype!r}")
    ver = rec.get("schema_version")
    if not isinstance(ver, int) or ver < 1:
        raise SchemaError(f"bad schema_version {ver!r}")
    for name, types in REQUIRED_FIELDS[rtype].items():
        if name not in rec:
            raise SchemaError(f"{rtype} record missing required "
                              f"field {name!r}")
        if not isinstance(rec[name], types):
            raise SchemaError(
                f"{rtype}.{name}: expected {'/'.join(t.__name__ for t in types)}, "
                f"got {type(rec[name]).__name__}")
    for name, types in OPTIONAL_FIELDS[rtype].items():
        if name in rec and not isinstance(rec[name], types):
            raise SchemaError(
                f"{rtype}.{name}: expected {'/'.join(t.__name__ for t in types)}, "
                f"got {type(rec[name]).__name__}")
    if rtype == "query" and rec.get("operators") is not None:
        _check_operator_node(rec["operators"], "query.operators")
    return rec
