"""The connect client as a command.

    python -m spark_rapids_tpu_torch.tools.connect_client \\
        --host 127.0.0.1 --port 15002 --plan plan.json [--tenant t1] \\
        [--deadline-ms 5000] [--conf k=v ...] [--digest-only]

    python -m spark_rapids_tpu_torch.tools.connect_client \\
        --port 15002 --sql "select count(*) as n from t"

Sends one Substrait plan (a JSON file, ``-`` for stdin) or one SQL text
to a connect server and prints the result.  It imports only
``connect/client.py`` (stdlib and pyarrow): no torch and no engine
module.  ``--digest-only`` prints the result's 16-hex Arrow IPC digest
(``eventlog.table_digest`` of an in-process collect gives the same).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="spark_rapids_tpu_torch.tools.connect_client",
        description="Submit a Substrait plan or SQL text to a "
                    "connect server.")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--plan", help="Substrait plan JSON file "
                                    "('-' reads stdin)")
    src.add_argument("--sql", help="SQL text")
    ap.add_argument("--tenant", default="default")
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--batch-rows", type=int, default=None)
    ap.add_argument("--conf", action="append", default=[],
                    metavar="K=V", help="session conf override "
                                        "(repeatable)")
    ap.add_argument("--params", default=None,
                    help="SQL :name bindings as a JSON object")
    ap.add_argument("--digest-only", action="store_true",
                    help="print only the Arrow IPC content digest")
    args = ap.parse_args(argv)

    from spark_rapids_tpu_torch.connect.client import (
        ConnectClient,
        ConnectError,
        table_digest,
    )

    conf = {}
    for item in args.conf:
        k, sep, v = item.partition("=")
        if not sep:
            ap.error(f"--conf needs K=V, got {item!r}")
        conf[k] = v
    plan = None
    if args.plan is not None:
        text = (sys.stdin.read() if args.plan == "-"
                else open(args.plan).read())
        plan = json.loads(text)
    params = json.loads(args.params) if args.params else None

    try:
        with ConnectClient(args.host, args.port,
                           tenant=args.tenant) as cli:
            tbl = cli.execute_plan(
                plan, sql=args.sql, conf=conf or None, params=params,
                deadline_ms=args.deadline_ms,
                batch_rows=args.batch_rows)
    except ConnectError as e:
        print(f"error [{e.kind}]: {e}", file=sys.stderr)
        return 1
    if args.digest_only:
        print(table_digest(tbl))
    else:
        print(tbl.to_pandas().to_string(index=False)
              if tbl.num_rows else "(0 rows)")
        print(f"-- {tbl.num_rows} rows, digest {table_digest(tbl)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
