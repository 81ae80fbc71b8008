"""API validation: diff the port's registries against the reference's
operator checklist.

Counterpart of ``spark_rapids_tpu/tools/api_validation.py`` (the
reference's api_validation module, a reflection tool that diffs each
Gpu*Exec against its CPU counterpart to catch drift).  The checklist is
the reference's replacement-rule inventory (SURVEY.md Appendix A, from
GpuOverrides.scala), copied verbatim from the JAX tool; the diff runs
against the port's live registries: ``plan/planner.py``'s
``SUPPORTED_EXPRS`` and ``SUPPORTED_AGGS``, its exec switch table, and
the modules that implement the execs.  ``python -m
spark_rapids_tpu_torch.tools.gen_docs DIR`` renders the coverage.

Run: python -m spark_rapids_tpu_torch.tools.api_validation
"""

from __future__ import annotations

#: reference expression rules (GpuOverrides.scala:773-2669 + shims)
REFERENCE_EXPRESSIONS = """
Abs Acos Acosh Add AddMonths AggregateExpression Alias And ArrayContains
Asin Asinh
AtLeastNNonNulls Atan Atanh AttributeReference Average BRound BitwiseAnd
BitwiseNot BitwiseOr BitwiseXor CaseWhen Cbrt Ceil CheckOverflow Coalesce
CollectList Concat ConcatWs Contains Cos Cosh Cot Count CreateArray
CreateNamedStruct CurrentRow DateAdd DateAddInterval DateDiff
DateFormatClass DateSub DayOfMonth DayOfWeek DayOfYear Divide ElementAt
EndsWith EqualNullSafe EqualTo Exp Explode Expm1 First Floor FromUnixTime
GetArrayItem GetJsonObject GetMapValue GetStructField GreaterThan
GreaterThanOrEqual Greatest Hour If In InSet InitCap InputFileBlockLength
InputFileBlockStart InputFileName IntegralDivide IsNaN IsNotNull IsNull
KnownFloatingPointNormalized Lag Last LastDay Lead Least Length LessThan
LessThanOrEqual Like Literal Log Log10 Log1p Log2 Logarithm Lower
MakeDecimal Max Md5 Min Minute MonotonicallyIncreasingID Month Multiply
Murmur3Hash NaNvl NormalizeNaNAndZero Not Or PivotFirst Pmod PosExplode
Pow PromotePrecision PythonUDF Quarter Rand Remainder Rint Round RowNumber
ScalarSubquery Second ShiftLeft ShiftRight ShiftRightUnsigned Signum Sin
Sinh Size SortOrder SparkPartitionID SpecifiedWindowFrame Sqrt StartsWith
StringLPad StringLocate StringRPad StringReplace StringSplit StringTrim
StringTrimLeft StringTrimRight Substring SubstringIndex Subtract Sum Tan
Tanh TimeAdd ToDegrees ToRadians ToUnixTimestamp UnaryMinus UnaryPositive
UnboundedFollowing UnboundedPreceding UnixTimestamp UnscaledValue Upper
WeekDay WindowExpression WindowSpecDefinition Year Cast RegExpReplace
AnsiCast TimeSub
""".split()

#: reference exec rules (GpuOverrides.scala:2774-3041 + shims)
REFERENCE_EXECS = """
BatchScanExec BroadcastExchangeExec BroadcastNestedLoopJoinExec
CartesianProductExec CoalesceExec CollectLimitExec CustomShuffleReaderExec
DataWritingCommandExec ExpandExec FilterExec GenerateExec GlobalLimitExec
HashAggregateExec LocalLimitExec ProjectExec RangeExec ShuffleExchangeExec
SortAggregateExec SortExec TakeOrderedAndProjectExec UnionExec WindowExec
BroadcastHashJoinExec FileSourceScanExec ShuffledHashJoinExec
SortMergeJoinExec ArrowEvalPythonExec MapInPandasExec
FlatMapGroupsInPandasExec AggregateInPandasExec WindowInPandasExec
FlatMapCoGroupsInPandasExec
""".split()

REFERENCE_SCANS = ["CSVScan", "ParquetScan", "OrcScan"]
REFERENCE_PARTITIONINGS = ["Hash", "Range", "RoundRobin", "Single"]

_P = "spark_rapids_tpu_torch"

#: reference name -> (module, attribute) implementing the same concept
#: under another name; each is probed at validate() time, so a dropped
#: implementation shows as missing
_RENAMES = {
    "AttributeReference": (f"{_P}.exprs.base", "ColumnReference"),
    "PythonUDF": (f"{_P}.udf.exprs", "OpaquePythonUDF"),
    "AggregateExpression": (f"{_P}.exprs.aggregates", "NamedAgg"),
    "SortOrder": (f"{_P}.execs.sort", "SortKey"),
    "WindowSpecDefinition": (f"{_P}.exprs.window", "WindowSpec"),
    "SpecifiedWindowFrame": (f"{_P}.exprs.window", "WindowFrame"),
    "CurrentRow": (f"{_P}.exprs.window", "CURRENT_ROW"),
    "UnboundedPreceding": (f"{_P}.exprs.window", "UNBOUNDED"),
    "UnboundedFollowing": (f"{_P}.exprs.window", "UNBOUNDED"),
    "Explode": (f"{_P}.exprs.collections", "Explode"),
    "PosExplode": (f"{_P}.exprs.collections", "Explode"),
    "InSet": (f"{_P}.exprs.predicates", "In"),
    "CountDistinct": (f"{_P}.exprs.aggregates", "CountDistinct"),
    "UnixTimestamp": (f"{_P}.exprs.datetime", "UnixTimestampFromTs"),
    "ToUnixTimestamp": (f"{_P}.exprs.datetime", "UnixTimestampFromTs"),
    "ScalarSubquery": (f"{_P}.exprs.subquery", "ScalarSubquery"),
    # ANSI cast is the one Cast under the ansi.enabled key
    "AnsiCast": (f"{_P}.exprs.cast", "Cast"),
    # expanded before planning into one masked First per pivot value,
    # which the group-by runs (the JAX planner registers the class)
    "PivotFirst": (f"{_P}.exprs.aggregates", "PivotFirst"),
}


def _known_expression_names() -> set:
    """Every expression, aggregate and window concept the port
    implements, by reference name: the live registries and the probed
    renames."""
    import importlib

    from spark_rapids_tpu_torch.exprs import window as W
    from spark_rapids_tpu_torch.plan import planner as PL

    names = {c.__name__ for c in PL.SUPPORTED_EXPRS}
    names |= {c.__name__ for c in PL.SUPPORTED_AGGS}
    # the window machinery is spec-based rather than a rule each
    for cls in (W.WindowExpression, W.RowNumber, W.Rank, W.DenseRank,
                W.Lead, W.Lag):
        names.add(cls.__name__)
    for ref, (mod, attr) in _RENAMES.items():
        try:
            if hasattr(importlib.import_module(mod), attr):
                names.add(ref)
        except ImportError:
            pass
    return names


#: reference exec -> (module, class, note), resolved at validate() time:
#: a renamed or deleted implementation shows as drift
_EXEC_MAP: dict = {
    "BatchScanExec": (f"{_P}.io.scan", "ParquetScanExec",
                      "+OrcScanExec/CsvScanExec"),
    "FileSourceScanExec": (f"{_P}.io.scan", "ParquetScanExec",
                           "+pushdown, coalescing"),
    "BroadcastExchangeExec": (f"{_P}.execs.join",
                              "TpuBroadcastHashJoinExec",
                              "broadcast build collection inside"),
    "BroadcastHashJoinExec": (f"{_P}.execs.join",
                              "TpuBroadcastHashJoinExec", ""),
    "BroadcastNestedLoopJoinExec": (f"{_P}.execs.join",
                                    "TpuBroadcastHashJoinExec",
                                    "cross/keyless-conditional path"),
    "CartesianProductExec": (f"{_P}.execs.join",
                             "TpuShuffledHashJoinExec", "cross path"),
    "CoalesceExec": (f"{_P}.execs.exchange", "TpuCoalescePartitionsExec",
                     ""),
    "CollectLimitExec": (f"{_P}.execs.limit", "TpuCollectLimitExec", ""),
    "CustomShuffleReaderExec": (f"{_P}.execs.adaptive",
                                "CoalescedShuffleReaderExec",
                                "AQE coalesced partition specs"),
    "DataWritingCommandExec": (f"{_P}.io.write", "FileWriteExec",
                               "+Parquet/Csv/Orc"),
    "ExpandExec": (f"{_P}.execs.expand", "TpuExpandExec", ""),
    "FilterExec": (f"{_P}.execs.basic", "TpuFilterExec", ""),
    "GenerateExec": (f"{_P}.execs.generate", "TpuGenerateExec", ""),
    "GlobalLimitExec": (f"{_P}.execs.limit", "TpuGlobalLimitExec", ""),
    "LocalLimitExec": (f"{_P}.execs.limit", "TpuLocalLimitExec", ""),
    "HashAggregateExec": (f"{_P}.execs.aggregate", "TpuHashAggregateExec",
                          ""),
    "SortAggregateExec": (f"{_P}.execs.aggregate", "TpuHashAggregateExec",
                          "sort-agnostic"),
    "ProjectExec": (f"{_P}.execs.basic", "TpuProjectExec", ""),
    "RangeExec": (f"{_P}.execs.basic", "TpuRangeExec", ""),
    "ShuffleExchangeExec": (f"{_P}.execs.exchange",
                            "TpuShuffleExchangeExec", ""),
    "ShuffledHashJoinExec": (f"{_P}.execs.join", "TpuShuffledHashJoinExec",
                             ""),
    "SortMergeJoinExec": (f"{_P}.execs.join", "TpuShuffledHashJoinExec",
                          "hash join instead, like the reference"),
    "SortExec": (f"{_P}.execs.sort", "TpuSortExec", "out-of-core"),
    "TakeOrderedAndProjectExec": (f"{_P}.execs.sort",
                                  "TpuTakeOrderedAndProjectExec", ""),
    "UnionExec": (f"{_P}.execs.basic", "TpuUnionExec", ""),
    "WindowExec": (f"{_P}.execs.window", "TpuWindowExec", ""),
    "ArrowEvalPythonExec": (f"{_P}.execs.python_exec", "TpuMapInArrowExec",
                            "arrow-batch python eval"),
    "MapInPandasExec": (f"{_P}.execs.python_exec", "TpuMapInPandasExec",
                        ""),
    "FlatMapGroupsInPandasExec": (f"{_P}.execs.python_exec",
                                  "TpuFlatMapGroupsInPandasExec", ""),
    "AggregateInPandasExec": (f"{_P}.execs.python_exec",
                              "TpuAggregateInPandasExec", ""),
    "WindowInPandasExec": (f"{_P}.execs.python_exec",
                           "TpuWindowInPandasExec", "unbounded frames"),
    "FlatMapCoGroupsInPandasExec": (f"{_P}.execs.python_exec",
                                    "TpuFlatMapCoGroupsInPandasExec", ""),
}


def _resolve_execs():
    """Probe every _EXEC_MAP entry against the live modules:
    (resolved {ref: display}, missing [ref], drift [ref]), drift being
    an entry whose module or class does not exist."""
    import importlib

    resolved: dict = {}
    missing: list = []
    drift: list = []
    for ref, entry in _EXEC_MAP.items():
        if entry is None:
            missing.append(ref)
            continue
        mod, cls, note = entry
        try:
            ok = hasattr(importlib.import_module(mod), cls)
        except ImportError:
            ok = False
        if ok:
            resolved[ref] = f"{cls}" + (f" ({note})" if note else "")
        else:
            drift.append(ref)
    return resolved, sorted(missing), sorted(drift)


def validate() -> dict:
    """{'expressions': (supported, missing), 'execs': (supported,
    missing, map), ...}: the live registries against the checklist."""
    have = _known_expression_names()
    exprs_ok = sorted(n for n in REFERENCE_EXPRESSIONS if n in have)
    exprs_missing = sorted(n for n in set(REFERENCE_EXPRESSIONS) - have)

    resolved, missing, drift = _resolve_execs()
    exec_map = dict(resolved)
    for ref in missing + drift:
        exec_map[ref] = None

    return {
        "expressions": (exprs_ok, exprs_missing),
        "execs": (sorted(resolved), missing + drift, exec_map),
        "exec_drift": drift,
        "scans": (list(REFERENCE_SCANS), []),
        "partitionings": (list(REFERENCE_PARTITIONINGS), []),
    }


def assert_no_drift() -> None:
    """Raise when the exec map names an implementation that no longer
    resolves (entries missing by design, None, are fine)."""
    drift = validate()["exec_drift"]
    if drift:
        raise AssertionError(
            "api_validation exec map drift (implementation vanished): "
            + ", ".join(drift)
            + " — update _EXEC_MAP in tools/api_validation.py")


def coverage_md() -> str:
    v = validate()
    eo, em = v["expressions"]
    xo, xm, xmap = v["execs"]
    lines = [
        "# API coverage vs the reference checklist",
        "",
        "Generated by `python -m spark_rapids_tpu_torch.tools.gen_docs` "
        "from the port's live registries diffed against the reference's "
        "replacement rules (SURVEY.md Appendix A / GpuOverrides.scala) — "
        "do not edit.",
        "",
        f"## Expressions: {len(eo)}/{len(set(REFERENCE_EXPRESSIONS))}",
        "",
        "Missing: " + (", ".join(em) if em else "none"),
        "",
        f"## Execs: {len(xo)}/{len(xmap)}",
        "",
        "| reference exec | this engine |",
        "|---|---|",
    ]
    for k in sorted(xmap):
        lines.append(f"| {k} | {xmap[k] or '**missing**'} |")
    lines += [
        "",
        f"## Scans: {len(v['scans'][0])}/{len(REFERENCE_SCANS)} — "
        + ", ".join(v["scans"][0]),
        f"## Partitionings: {len(v['partitionings'][0])}"
        f"/{len(REFERENCE_PARTITIONINGS)} — "
        + ", ".join(v["partitionings"][0]),
        "",
    ]
    return "\n".join(lines)


def counts() -> dict:
    """The summary the CLI prints: supported and missing counts."""
    v = validate()
    eo, em = v["expressions"]
    xo, xm, _ = v["execs"]
    return {"expressions": len(eo), "expressions_missing": len(em),
            "execs": len(xo), "execs_missing": len(xm),
            "drift": len(v["exec_drift"])}


if __name__ == "__main__":
    assert_no_drift()
    c = counts()
    print(f"expressions {c['expressions']} supported / "
          f"{c['expressions_missing']} missing; execs {c['execs']} "
          f"supported / {c['execs_missing']} missing; no drift")
