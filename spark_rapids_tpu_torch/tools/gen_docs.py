"""Generate documents from the port's live registries.

Counterpart of ``spark_rapids_tpu/tools/gen_docs.py`` (the reference's
generated ``supported_ops.md`` from TypeChecks, and ``configs.md`` from
RapidsConf.help):

- ``supported_ops.md``: the planner's exec switches, the expressions
  the GPU runs with the input types their device versions take, and
  the aggregates;
- ``configs.md``: every key of ``config.DEFAULTS`` with its default
  (the per-exec and per-expression switches are in the first);
- ``api_coverage.md``: ``tools/api_validation.coverage_md()``.

Run: python -m spark_rapids_tpu_torch.tools.gen_docs OUT_DIR
"""

from __future__ import annotations

import os
import sys

_SWITCH_PREFIXES = ("spark.rapids.tpu.sql.expression.",
                    "spark.rapids.tpu.sql.exec.")


def supported_ops_md() -> str:
    # importing the planner fills every registry
    from spark_rapids_tpu_torch.plan import planner as PL

    lines = [
        "# Supported operators and expressions",
        "",
        "Generated by `python -m spark_rapids_tpu_torch.tools.gen_docs` "
        "from the planner's registries — do not edit.",
        "",
        "An input type outside an operator's signature keeps that "
        "operator on the CPU engine, with its reason in explain().",
        "",
        "## Execs",
        "",
        "| Logical node | Enable conf (default on) |",
        "|---|---|",
    ]
    for cls, key in sorted(PL.EXEC_SWITCHES.items(),
                           key=lambda kv: kv[0].__name__):
        lines.append(f"| {cls.__name__} | `{key}` |")
    lines += [
        "",
        "## Expressions",
        "",
        "| Expression | Supported input types | Notes | Enable conf |",
        "|---|---|---|---|",
    ]
    for cls, key in sorted(PL.SUPPORTED_EXPRS.items(),
                           key=lambda kv: kv[0].__name__):
        sig = PL.EXPR_SIGS.get(cls)
        kinds = sig.inputs.describe() if sig else "(unchecked)"
        note = sig.note if sig else ""
        lines.append(f"| {cls.__name__} | {kinds} | {note} | `{key}` |")
    lines += [
        "",
        "## Aggregate functions",
        "",
        "| Aggregate | Supported input types | Notes |",
        "|---|---|---|",
    ]
    for cls in sorted(PL.SUPPORTED_AGGS, key=lambda c: c.__name__):
        sig = PL.AGG_SIGS.get(cls)
        kinds = sig.inputs.describe() if sig else "(any)"
        note = sig.note if sig else ""
        lines.append(f"| {cls.__name__} | {kinds} | {note} |")
    lines.append("")
    return "\n".join(lines)


def configs_md() -> str:
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.plan import planner  # noqa: F401

    lines = [
        "# Configuration",
        "",
        "Generated by `python -m spark_rapids_tpu_torch.tools.gen_docs` "
        "from `config.DEFAULTS` — do not edit.  Each key is described "
        "beside its name in `spark_rapids_tpu_torch/config.py`.",
        "",
        "| Key | Default |",
        "|---|---|",
    ]
    for key in sorted(C.DEFAULTS):
        if not key.startswith(_SWITCH_PREFIXES):
            lines.append(f"| `{key}` | `{C.DEFAULTS[key]}` |")
    lines.append("")
    return "\n".join(lines)


def main(out_dir: str) -> list[str]:
    """Write the three documents into ``out_dir``; their paths."""
    from spark_rapids_tpu_torch.tools.api_validation import coverage_md

    os.makedirs(out_dir, exist_ok=True)
    out = []
    for name, render in (("supported_ops.md", supported_ops_md),
                         ("configs.md", configs_md),
                         ("api_coverage.md", coverage_md)):
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            f.write(render())
        out.append(path)
    print("wrote " + ", ".join(out))
    return out


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print("usage: python -m spark_rapids_tpu_torch.tools.gen_docs "
              "OUT_DIR", file=sys.stderr)
        raise SystemExit(2)
    main(sys.argv[1])
