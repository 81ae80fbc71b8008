"""Qualification: score queries for their fit on the card.

Counterpart of ``spark_rapids_tpu/tools/qualification.py`` (the
reference's qualification tool, which scores CPU event logs for GPU fit
without a GPU).  The input is a DataFrame or several; the tool runs only
the planner's tagging walk (``plan/planner.py::PlanMeta``), with no
execution and no device, and reports which operators would run on the
GPU, which would run on the CPU engine and why, and the share that runs
on the GPU.

Run it over SQL texts::

    python -m spark_rapids_tpu_torch.tools.qualification \
        --table NAME=FILE.parquet ... --sql TEXT [--sql TEXT ...]
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass
class QualReport:
    total_ops: int
    tpu_ops: int
    fallback_ops: int
    reasons: dict[str, int]          # reason -> occurrences
    explain: str

    @property
    def eligible_fraction(self) -> float:
        return self.tpu_ops / self.total_ops if self.total_ops else 0.0

    @property
    def recommendation(self) -> str:
        f = self.eligible_fraction
        if f >= 0.75:
            return "strongly recommended"
        if f >= 0.5:
            return "recommended"
        if f > 0.0:
            return "partial"
        return "not recommended"


def qualify(df, conf=None) -> QualReport:
    """Tag one DataFrame's plan and score it (the plan only, nothing
    runs); ``conf`` defaults to its session's."""
    from spark_rapids_tpu_torch.plan.planner import PlanMeta

    if conf is None:
        conf = df._session.conf
    meta = PlanMeta(df._plan, conf)
    meta.tag()
    total = tpu = fb = 0
    reasons: dict[str, int] = {}
    for m in meta.walk():
        total += 1
        if m.can_replace:
            tpu += 1
        else:
            fb += 1
            for r in m.reasons:
                reasons[r] = reasons.get(r, 0) + 1
    return QualReport(total, tpu, fb, reasons, meta.explain())


def qualification_report(dfs: Sequence, names: Optional[Sequence[str]]
                         = None) -> str:
    """The report over several queries (the per-application summary)."""
    names = list(names or [f"query-{i}" for i in range(len(dfs))])
    reports = [qualify(df) for df in dfs]
    lines = [
        "# Qualification report",
        "",
        "| query | operators | on TPU | fallback | eligible | "
        "recommendation |",
        "|---|---|---|---|---|---|",
    ]
    for name, r in zip(names, reports):
        lines.append(
            f"| {name} | {r.total_ops} | {r.tpu_ops} | {r.fallback_ops} "
            f"| {r.eligible_fraction:.0%} | {r.recommendation} |")
    all_reasons: dict[str, int] = {}
    for r in reports:
        for k, v in r.reasons.items():
            all_reasons[k] = all_reasons.get(k, 0) + v
    if all_reasons:
        lines += ["", "## Fallback reasons", ""]
        for k, v in sorted(all_reasons.items(), key=lambda kv: -kv[1]):
            lines.append(f"- {v}x {k}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    import argparse

    from spark_rapids_tpu_torch.frontends.sql import SqlSession

    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_tpu_torch.tools.qualification",
        description="score SQL texts for their fit on the card (plans "
                    "only; nothing runs)")
    ap.add_argument("--table", action="append", default=[],
                    metavar="NAME=PATH", help="a Parquet table to register")
    ap.add_argument("--sql", action="append", required=True,
                    help="a query text (repeatable)")
    args = ap.parse_args(argv)
    fe = SqlSession(device="cpu")
    for spec in args.table:
        name, _, path = spec.partition("=")
        fe.register_parquet(name, path)
    dfs = [fe.sql(text) for text in args.sql]
    print(qualification_report(dfs), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
