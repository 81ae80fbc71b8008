"""Low-level event-log reading: JSONL (plain or gzip) -> records.

Forward-compat contract (see eventlog/schema.py): unknown fields are
preserved verbatim, records of unknown TYPE are skipped (a newer
writer may add record types), and a corrupt trailing line — a crash
mid-write — is dropped rather than failing the whole load.  Strict
schema validation is opt-in (the golden tests use it); operational
readers (tools/history) load permissively.
"""

from __future__ import annotations

import json
from typing import Iterator, Optional

from spark_rapids_tpu_torch.eventlog.schema import (
    RECORD_TYPES,
    SchemaError,
    validate_record,
)


def _gunzip_prefix(raw: bytes) -> str:
    """Decode a sequence of gzip members, keeping everything that
    decompresses cleanly.  zlib's incremental decompressor RETURNS the
    partial output of a truncated member (GzipFile.read would raise
    EOFError and discard it), so a process killed mid-append costs at
    most the torn trailing line, never the whole final member."""
    import zlib

    out = bytearray()
    pos = 0
    while pos < len(raw):
        d = zlib.decompressobj(wbits=31)  # gzip-wrapped member
        try:
            out += d.decompress(raw[pos:])
            out += d.flush()
        except zlib.error:
            break  # corrupt member: keep the decoded prefix
        if not d.eof or not d.unused_data:
            break  # truncated final member / end of file
        pos = len(raw) - len(d.unused_data)
    return out.decode("utf-8", errors="replace")


def _read_lines(path: str) -> list[str]:
    """Whole-file read with crash tolerance: a truncated compressed
    tail yields its decoded prefix (the partial trailing line, if any,
    is then handled like a plain torn tail)."""
    if path.endswith(".gz"):
        with open(path, "rb") as f:
            return _gunzip_prefix(f.read()).splitlines()
    with open(path, "r", encoding="utf-8") as f:
        return f.read().splitlines()


def iter_records(path: str, strict: bool = False,
                 errors: Optional[list] = None) -> Iterator[dict]:
    """Yield decoded records from one event-log file.

    - unknown record types are skipped (forward compat);
    - an undecodable line is dropped (appended to `errors` when given)
      unless `strict`, where it raises — ONLY a final partial line is
      ever tolerated silently (crash-mid-write);
    - with `strict`, every record must validate against the schema.
    """
    lines = _read_lines(path)
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as exc:
            if i == len(lines) - 1 and not strict:
                continue  # torn trailing write
            if strict:
                raise SchemaError(
                    f"{path}:{i + 1}: undecodable record: {exc}")
            if errors is not None:
                errors.append(f"{path}:{i + 1}: {exc}")
            continue
        if strict:
            validate_record(rec)
        elif not isinstance(rec, dict) \
                or rec.get("type") not in RECORD_TYPES:
            continue  # unknown record type: a newer writer's extension
        yield rec


def read_log(path: str, strict: bool = False
             ) -> tuple[Optional[dict], list[dict]]:
    """(header, query_records) for one log file."""
    header, queries, _telemetry, _slo = read_log_all(path,
                                                     strict=strict)
    return header, queries


def read_log_all(path: str, strict: bool = False
                 ) -> tuple[Optional[dict], list[dict], list[dict],
                            list[dict]]:
    """(header, query_records, telemetry_records, slo_records) for one
    log file — the full surface tools/history loads (telemetry records
    are the live sampler's gauge samples, trace/telemetry.py; slo
    records are the watchdog's budget breaches, obs/slo.py)."""
    header = None
    queries: list[dict] = []
    telemetry: list[dict] = []
    slo: list[dict] = []
    for rec in iter_records(path, strict=strict):
        if rec.get("type") == "header":
            header = rec
        elif rec.get("type") == "query":
            queries.append(rec)
        elif rec.get("type") == "telemetry":
            telemetry.append(rec)
        elif rec.get("type") == "slo":
            slo.append(rec)
    return header, queries, telemetry, slo
