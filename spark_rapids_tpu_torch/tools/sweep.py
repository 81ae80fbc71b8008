"""The 99-query TPC-DS sweep: classify every text's fate on the port.

Counterpart of ``spark_rapids_tpu/tools/sweep.py``.  It drives the 99
TPC-DS texts (``tpcds_queries.QUERIES``, equal to the JAX corpus)
through the port's SQL frontend against the deterministic mini catalog
(``tools/tpcds_schema.py``) and classifies each as

    parsed -> planned -> executed -> correct (against the CPU engine)

recording where each one stops and why (the failure taxonomy: which
grammar production or operator rejected it), so the port learns where
its SQL surface stops.  On top:

- **fix probes**: the parse and plan stages again with each of three
  grammar fixes disabled (``frontends/sql.DISABLED_FEATURES``),
  recording which texts each fix advances;
- **wire subset**: the texts expressible as Substrait plans also go
  through the connect front door (``connect/``), a real TCP round trip,
  their Arrow results digest-checked against the same plan collected
  in process.

Entry points run on ``cuda`` unless ``device="cpu"`` is given (the
tests); the oracle is the port's pyarrow engine, ``cpu/engine.py``.

CLI::

    python -m spark_rapids_tpu_torch.tools.sweep [--out FILE.json]
        [--md FILE.md] [--queries 3,27,37] [--scale 1.0] [--seed 7]
        [--device cuda|cpu] [--no-oracle] [--no-wire] [--no-probes]

Without ``--out`` it writes no file and prints the totals.
"""

from __future__ import annotations

import json
import time
from typing import Optional

#: sweep round: bump when the corpus or classification changes shape
SWEEP_ROUND = 1

#: failure-taxonomy buckets, matched in order against the error text
_TAXONOMY = [
    ("intersect", "set-op INTERSECT not supported"),
    ("except", "set-op EXCEPT not supported"),
    ("cannot tokenize", "tokenizer"),
    ("not in (subquery)", "NOT IN (subquery)"),
    ("month/year interval", "month/year interval on date column"),
    ("grouping sets", "GROUPING SETS"),
    ("unknown function", "unknown function"),
    ("full outer join", "FULL OUTER JOIN shape"),
    ("exists over an aggregating", "EXISTS over aggregate"),
    ("exists correlation", "non-equality EXISTS correlation"),
    ("exists subquery must correlate", "uncorrelated EXISTS"),
    ("in/exists (subquery) is only supported",
     "IN/EXISTS below top-level AND"),
    ("in (subquery) is only supported", "IN-subquery placement"),
    ("scalar subquery must", "scalar subquery shape"),
    ("cartesian", "cartesian product"),
    ("join on needs at least one equality", "non-equi JOIN ON"),
    ("no join condition links", "join graph (comma-join order)"),
    ("derived table requires an alias", "derived-table alias"),
    ("must appear in group by", "group-by binding"),
    ("expected", "grammar (unexpected token)"),
    ("unexpected trailing", "grammar (trailing tokens)"),
    ("mixing count_distinct", "count(distinct) mix"),
    ("distinct unsupported", "DISTINCT aggregate"),
    ("unsupported cast type", "cast type"),
    ("unsupported interval unit", "interval unit"),
    ("unknown table alias", "alias resolution"),
    ("is not registered", "catalog resolution"),
    ("keyerror", "unresolved column (correlated subquery)"),
]


def _classify_reason(msg: str) -> str:
    low = msg.lower()
    for needle, bucket in _TAXONOMY:
        if needle in low:
            return bucket
    return "other"


def _first_line(e: BaseException) -> str:
    return f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def build_session(scale: float = 1.0, seed: int = 7, conf=None,
                  device: str = "cuda"):
    """A SqlSession with the whole mini catalog registered."""
    from spark_rapids_tpu_torch.frontends.sql import SqlSession
    from spark_rapids_tpu_torch.tools.tpcds_schema import generate

    fe = SqlSession(conf, device=device)
    for name, tbl in generate(scale=scale, seed=seed).items():
        fe.register_table(name, tbl)
    return fe


def _row_key(row) -> str:
    """Order-insensitive matching key: floats round to fewer digits than
    the comparison's tolerance, so last-place differences cannot reorder
    near-equal rows into a false mismatch."""
    return repr(tuple(round(x, 3) if isinstance(x, float) else x
                      for x in row))


def _tables_equal(a, b, rel_tol: float = 1e-4) -> Optional[str]:
    """None when equal (unordered, float-tolerant); else a reason."""
    if a.num_columns != b.num_columns:
        return f"column count {a.num_columns} != {b.num_columns}"
    if a.num_rows != b.num_rows:
        return f"row count {a.num_rows} != {b.num_rows}"
    ra = sorted(zip(*[c.to_pylist() for c in a.columns]),
                key=_row_key) if a.num_columns else []
    rb = sorted(zip(*[c.to_pylist() for c in b.columns]),
                key=_row_key) if b.num_columns else []
    for x, y in zip(ra, rb):
        for u, v in zip(x, y):
            if isinstance(u, float) and isinstance(v, float):
                if abs(u - v) > rel_tol * max(1.0, abs(u), abs(v)):
                    return f"float mismatch {u} vs {v}"
            elif u != v:
                return f"value mismatch {u!r} vs {v!r}"
    return None


def classify_query(fe, text: str, oracle: bool = True) -> dict:
    """One text's verdict: {stage, status, reason?, rows?, wall_ms}."""
    from spark_rapids_tpu_torch.cpu.engine import execute_cpu
    from spark_rapids_tpu_torch.frontends.sql import SqlError, _Parser

    t0 = time.perf_counter()
    out: dict = {}

    def done(**kv) -> dict:
        out.update(kv)
        out["wall_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
        return out

    def failed(stage: str, status: str, e: BaseException) -> dict:
        return done(stage=stage, status=status, error=_first_line(e),
                    reason=_classify_reason(str(e)))

    try:
        _Parser(text).parse_select()
    except SqlError as e:
        return failed("parse", "parse_error", e)
    try:
        df = fe.sql(text)
    except Exception as e:  # noqa: BLE001 - the verdict is the product
        return failed("plan", "plan_error", e)
    try:
        got = df.collect()
    except Exception as e:  # noqa: BLE001
        return failed("execute", "exec_error", e)
    out.update(rows=got.num_rows)
    if not oracle:
        return done(stage="execute", status="executed")
    try:
        want = execute_cpu(df._plan)
    except Exception as e:  # noqa: BLE001
        return failed("oracle", "oracle_error", e)
    diff = _tables_equal(got, want)
    if diff is None:
        return done(stage="correct", status="correct")
    return done(stage="correct", status="mismatch", error=diff,
                reason="result mismatch vs CPU oracle")


# ------------------------------------------------------------------ #
# The fix probes
# ------------------------------------------------------------------ #

_STAGE_ORDER = {"parse_error": 0, "plan_error": 1, "exec_error": 2,
                "oracle_error": 3, "mismatch": 3, "executed": 3,
                "correct": 4}

FIX_FEATURES = ("not_in_subquery", "month_year_interval",
                "grouping_sets")


def _parse_plan_stage(fe, text: str) -> int:
    """The parse and plan stages only (nothing runs): 0, 1 or 2."""
    from spark_rapids_tpu_torch.frontends.sql import SqlError, _Parser

    try:
        _Parser(text).parse_select()
    except SqlError:
        return 0
    try:
        fe.sql(text)
    except Exception:  # noqa: BLE001
        return 1
    return 2


def fix_probes(fe, queries: dict, results: dict) -> dict:
    """For each grammar fix, the texts that stop earlier with it
    disabled (the parse and plan stages again)."""
    from spark_rapids_tpu_torch.frontends import sql as sql_mod

    out: dict = {}
    for feature in FIX_FEATURES:
        advanced = []
        sql_mod.DISABLED_FEATURES.add(feature)
        try:
            for qid, text in sorted(queries.items()):
                fixed_rank = min(
                    _STAGE_ORDER.get(results[f"q{qid}"]["status"], 0), 2)
                if _parse_plan_stage(fe, text) < fixed_rank:
                    advanced.append(f"q{qid}")
        finally:
            sql_mod.DISABLED_FEATURES.discard(feature)
        out[feature] = advanced
    return out


# ------------------------------------------------------------------ #
# The wire subset: Substrait plans through the connect front door
# ------------------------------------------------------------------ #


def _brand_sales_substrait(manager_id: int, moy: int,
                           year: Optional[int]) -> dict:
    """The q52/q55 family as a Substrait plan: date_dim x store_sales
    x item, filter (d_moy, i_manager_id [, d_year]), group by
    (i_brand_id, i_brand), sum(ss_ext_sales_price), sort by the sum
    desc, limit 100."""
    def field(i):
        return {"selection": {"directReference":
                              {"structField": {"field": i}}}}

    def fn(ref, *args):
        return {"scalarFunction": {"functionReference": ref,
                                   "arguments": [{"value": a}
                                                 for a in args]}}

    # store_sales(ss_sold_date_sk, ss_item_sk, ss_ext_sales_price) = 0..2
    # date_dim(d_date_sk, d_year, d_moy) = 3..5
    # item(i_item_sk, i_brand_id, i_brand, i_manager_id) = 6..9
    ss = {"read": {"namedTable": {"names": ["store_sales"]},
                   "baseSchema": {"names": ["ss_sold_date_sk",
                                            "ss_item_sk",
                                            "ss_ext_sales_price"]}}}
    dd = {"read": {"namedTable": {"names": ["date_dim"]},
                   "baseSchema": {"names": ["d_date_sk", "d_year",
                                            "d_moy"]}}}
    it = {"read": {"namedTable": {"names": ["item"]},
                   "baseSchema": {"names": ["i_item_sk", "i_brand_id",
                                            "i_brand",
                                            "i_manager_id"]}}}
    j1 = {"join": {"type": "JOIN_TYPE_INNER", "left": ss, "right": dd,
                   "expression": fn(1, field(0), field(3))}}
    j2 = {"join": {"type": "JOIN_TYPE_INNER", "left": j1, "right": it,
                   "expression": fn(1, field(1), field(6))}}
    conds = [fn(1, field(5), {"literal": {"i64": moy}}),
             fn(1, field(9), {"literal": {"i64": manager_id}})]
    if year is not None:
        conds.append(fn(1, field(4), {"literal": {"i64": year}}))
    cond = conds[0]
    for c in conds[1:]:
        cond = fn(2, cond, c)
    filt = {"filter": {"input": j2, "condition": cond}}
    agg = {"aggregate": {
        "input": filt,
        "groupings": [{"groupingExpressions": [field(7), field(8)]}],
        "measures": [{"measure": {"functionReference": 3,
                                  "arguments":
                                      [{"value": field(2)}]}}]}}
    # aggregate output: [i_brand_id, i_brand, m0]
    srt = {"sort": {"input": agg, "sorts": [
        {"expr": field(2),
         "direction": "SORT_DIRECTION_DESC_NULLS_LAST"},
        {"expr": field(0),
         "direction": "SORT_DIRECTION_ASC_NULLS_FIRST"}]}}
    fetch = {"fetch": {"input": srt, "count": 100}}
    return {
        "extensions": [
            {"extensionFunction": {"functionAnchor": 1,
                                   "name": "equal:any_any"}},
            {"extensionFunction": {"functionAnchor": 2,
                                   "name": "and:bool"}},
            {"extensionFunction": {"functionAnchor": 3,
                                   "name": "sum:fp64"}},
        ],
        "relations": [{"root": {
            "input": fetch,
            "names": ["brand_id", "brand", "ext_price"]}}],
    }


#: query id -> Substrait plan for the wire subset
WIRE_PLANS = {
    42: lambda: _brand_sales_substrait(1, 11, 2000),
    52: lambda: _brand_sales_substrait(1, 11, 2000),
    55: lambda: _brand_sales_substrait(28, 11, 1999),
    3: lambda: _brand_sales_substrait(1, 11, None),
}

_WIRE_TABLES = ("store_sales", "date_dim", "item")


def wire_sweep(scale: float = 1.0, seed: int = 7, query_ids=None,
               device: str = "cuda") -> dict:
    """The Substrait subset through a connect server in this process
    (a TCP round trip), each result's digest held against the same plan
    collected in process; ``query_ids`` restricts WIRE_PLANS (None:
    all)."""
    from spark_rapids_tpu_torch.connect.client import (
        ConnectClient,
        table_digest,
    )
    from spark_rapids_tpu_torch.connect.server import ConnectServer
    from spark_rapids_tpu_torch.frontends.substrait import SubstraitFrontend
    from spark_rapids_tpu_torch.tools.tpcds_schema import generate

    catalog = generate(scale=scale, seed=seed)
    srv = ConnectServer(device=device)
    local = SubstraitFrontend(device=device)
    for name in _WIRE_TABLES:
        srv.register_table(name, catalog[name])
        local.register_table(name, catalog[name])
    srv.start()
    out: dict = {}
    try:
        host, port = srv.address
        with ConnectClient(host, port, tenant="sweep") as cli:
            for qid, mk in sorted(WIRE_PLANS.items()):
                if query_ids is not None and qid not in query_ids:
                    continue
                plan = mk()
                try:
                    wire_tbl = cli.execute_plan(plan)
                    local_tbl = local.execute_plan(plan)
                    match = (table_digest(wire_tbl)
                             == table_digest(local_tbl.combine_chunks()))
                    out[f"q{qid}"] = {
                        "status": "ok" if match else "digest_mismatch",
                        "rows": wire_tbl.num_rows,
                        "digest_match": match}
                except Exception as e:  # noqa: BLE001
                    out[f"q{qid}"] = {"status": "error",
                                      "error": _first_line(e)}
    finally:
        srv.shutdown()
    return out


# ------------------------------------------------------------------ #
# The sweep
# ------------------------------------------------------------------ #


def run_sweep(query_ids=None, scale: float = 1.0, seed: int = 7,
              oracle: bool = True, wire: bool = True,
              probes: bool = True, verbose: bool = False,
              device: str = "cuda") -> dict:
    from spark_rapids_tpu_torch.tpcds_queries import QUERIES

    ids = sorted(query_ids) if query_ids else sorted(QUERIES)
    fe = build_session(scale=scale, seed=seed, device=device)
    results: dict = {}
    for qid in ids:
        verdict = classify_query(fe, QUERIES[qid], oracle=oracle)
        results[f"q{qid}"] = verdict
        if verbose:
            print(f"q{qid}: {verdict['status']}"
                  + (f" [{verdict.get('reason', '')}]"
                     if verdict.get("reason") else ""), flush=True)
    counts: dict = {}
    for v in results.values():
        counts[v["status"]] = counts.get(v["status"], 0) + 1
    rank = _STAGE_ORDER
    totals = {
        "queries": len(results),
        "parsed": sum(1 for v in results.values()
                      if rank.get(v["status"], 0) >= 1),
        "planned": sum(1 for v in results.values()
                       if rank.get(v["status"], 0) >= 2),
        "executed": sum(1 for v in results.values()
                        if rank.get(v["status"], 0) >= 3
                        and v["status"] != "oracle_error"),
        "correct": counts.get("correct", 0),
        "by_status": counts,
        # each verdict's wall covers its parse -> oracle chain
        "wall_ms": round(sum(v.get("wall_ms", 0.0)
                             for v in results.values()), 1),
    }
    taxonomy: dict = {}
    for v in results.values():
        r = v.get("reason")
        if r:
            taxonomy[r] = taxonomy.get(r, 0) + 1
    report = {
        "round": SWEEP_ROUND,
        "scale": scale,
        "seed": seed,
        "device": device,
        "totals": totals,
        "failure_taxonomy": dict(sorted(
            taxonomy.items(), key=lambda kv: -kv[1])),
        "queries": results,
    }
    if probes:
        qmap = {qid: QUERIES[qid] for qid in ids}
        report["satellite_advances"] = fix_probes(fe, qmap, results)
    if wire:
        wire_ids = [q for q in WIRE_PLANS
                    if query_ids is None or q in ids]
        if wire_ids:
            report["wire"] = wire_sweep(scale=scale, seed=seed,
                                        query_ids=set(wire_ids),
                                        device=device)
    return report


def render_markdown(report: dict) -> str:
    t = report["totals"]
    lines = [
        "# TPC-DS 99-query sweep coverage",
        "",
        f"Round r{report['round']:02d} — generated by "
        "`python -m spark_rapids_tpu_torch.tools.sweep` against the "
        "deterministic mini catalog (tools/tpcds_schema.py, scale "
        f"{report['scale']}).",
        "",
        f"**{t['parsed']}/{t['queries']} parsed · "
        f"{t['planned']} planned · {t['executed']} executed · "
        f"{t['correct']} correct vs the CPU oracle.**",
        "",
        "Stage semantics: *parsed* = the SQL grammar accepts the "
        "text; *planned* = it lowers onto the engine's logical plan; "
        "*executed* = `collect()` returns on the session's device "
        "(CPU-engine operators allowed, as in the reference plugin); "
        "*correct* = the result matches the port's CPU engine "
        "(`cpu/engine.execute_cpu`) on the same plan (float-tolerant, "
        "order-insensitive).",
        "",
        "## Failure taxonomy (the ranked backlog)",
        "",
        "| Reason | Queries |",
        "|---|---|",
    ]
    tax = report.get("failure_taxonomy", {})
    by_reason: dict = {}
    for name, v in sorted(report["queries"].items(),
                          key=lambda kv: int(kv[0][1:])):
        r = v.get("reason")
        if r:
            by_reason.setdefault(r, []).append(name)
    for reason, _n in sorted(tax.items(), key=lambda kv: -kv[1]):
        qs = ", ".join(by_reason.get(reason, []))
        lines.append(f"| {reason} | {qs} |")
    adv = report.get("satellite_advances")
    if adv:
        lines += ["", "## Grammar fixes", "",
                  "| Fix | Queries advanced |", "|---|---|"]
        for feature, qs in adv.items():
            lines.append(f"| {feature} | {', '.join(qs) or '-'} |")
    wire = report.get("wire")
    if wire:
        lines += ["", "## Wire path (Substrait over the connect "
                      "front door)", "",
                  "| Query | Status | Digest == in-process |",
                  "|---|---|---|"]
        for name, v in sorted(wire.items(),
                              key=lambda kv: int(kv[0][1:])):
            lines.append(
                f"| {name} | {v['status']} | "
                f"{v.get('digest_match', '-')} |")
    lines += ["", "## Per-query status", "",
              "| Query | Status | Reason |", "|---|---|---|"]
    for name, v in sorted(report["queries"].items(),
                          key=lambda kv: int(kv[0][1:])):
        lines.append(
            f"| {name} | {v['status']} | {v.get('reason', '')} |")
    lines += [
        "",
        "Corpus dialect notes (tpcds_queries.py): date "
        "arithmetic is spelled `interval 'N' day/month` (the Spark "
        "kit form of `+ N days`); q27 uses the spec-equivalent "
        "GROUPING SETS spelling of its rollup; q16's returns "
        "exclusion uses NOT IN (subquery) on the non-null order "
        "number; q37's 60-day window from 2000-02-01 is `+ interval "
        "'2' month` (identical dates for that anchor).",
        "",
    ]
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_tpu_torch.tools.sweep",
        description="Run the 99-query TPC-DS coverage sweep on the port.")
    ap.add_argument("--out", default=None,
                    help="write the JSON report here (default: no file)")
    ap.add_argument("--md", default=None,
                    help="write the markdown coverage table here")
    ap.add_argument("--queries", default=None,
                    help="comma-separated query numbers (default all)")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--no-oracle", action="store_true",
                    help="skip the CPU-engine comparison")
    ap.add_argument("--no-wire", action="store_true",
                    help="skip the connect wire subset")
    ap.add_argument("--no-probes", action="store_true",
                    help="skip the grammar-fix probes")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    ids = ([int(x) for x in args.queries.split(",")]
           if args.queries else None)
    report = run_sweep(query_ids=ids, scale=args.scale, seed=args.seed,
                       oracle=not args.no_oracle, wire=not args.no_wire,
                       probes=not args.no_probes, verbose=args.verbose,
                       device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(report, indent=1) + "\n")
        print(f"wrote {args.out}")
    if args.md:
        with open(args.md, "w") as f:
            f.write(render_markdown(report))
        print(f"wrote {args.md}")
    t = report["totals"]
    print(f"parsed {t['parsed']}/{t['queries']}, planned "
          f"{t['planned']}, executed {t['executed']}, correct "
          f"{t['correct']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
