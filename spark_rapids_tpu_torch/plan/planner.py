"""Logical -> physical lowering.

Counterpart of ``spark_rapids_tpu/plan/planner.py`` for the file
relations (Scan, the Parquet one, OrcRelation and CsvRelation: their
scan execs get each file's Hive partition values), InMemoryRelation, RangeRel, Filter, Project, Aggregate, Expand,
Generate, Join, Window, Sort, Limit, Union, Cached, MapInArrow,
GroupedPandas and CoGroupedPandas.  Scan and in-memory
columns are pruned to what the plan above reads: an Expand keeps only
the columns read above it and needs what their expressions read in
every projection; a Generate repeats only the child columns read above
it; a Union prunes by position (its members name their columns apart,
as q5's ``ss_store_sk`` and ``sr_store_sk``), each member projected to
the kept positions where its own lowering kept more.

- An aggregate over several input partitions lowers as
  ``_plan_aggregate`` does there: partial aggregate -> hash exchange on
  the group keys -> final aggregate (a grand aggregate coalesces its
  partials instead of hashing them); a single partition aggregates
  completely.
- An aggregate whose every function is a collect (``collect_list``,
  ``collect_set``) lowers to ``TpuCollectAggExec``: over several input
  partitions a grouped one takes a hash exchange on its keys (unless
  the child is already distributed so) and collects each reduce
  partition alone, a grand one coalesces.  A collect beside another
  aggregate is tagged for the CPU engine (the JAX planner sends it
  there at lowering, with no reason in its ``explain()``).
- A join lowers as ``_plan_join`` does there.  When a legal build side
  is estimated at most ``autoBroadcastJoinThresholdBytes`` (10 MiB;
  ``broadcast_candidates``, from ``plan/logical.py``'s estimates), the
  smaller such side is broadcast.  Otherwise a keyed join whose key
  types match on both sides, with more than one input partition on
  either, takes a hash exchange on each side's keys (unless the side is
  already distributed so) under a partition-wise join.  Only identical
  key types hash alike, so other joins, and keyless ones, run as one
  wide join.  When both sides take a fresh exchange and
  ``sql.adaptive.enabled`` is on (the default), the join is a
  ``TpuAdaptiveJoinExec`` over the two exchanges (JAX
  ``planner.py:972-990``): its strategy waits for their measured map
  output (``execs/adaptive.py``).  Collective joins are not ported.
- A Filter over a file scan, both lowered to the GPU, pushes its
  condition into the scan (JAX ``_maybe_push_filter``): footer pruning
  and the host prefilter (``io/scan.py``).  With
  ``scan.elideDeviceFilter`` and ``scan.hostPrefilter`` on and a
  condition that compiles whole to ``pyarrow.compute``, the Filter is
  elided (JAX ``_can_elide_device_filter``): the scan reads what the
  parent needs and the condition's columns, filters exactly and emits
  only what the parent needs (the JAX ``null_upload_cols``
  placeholders are not needed: the port binds by name; a partition
  column the condition reads is appended before the prefilter, as the
  JAX rule keeps partition columns).  The pushed conjuncts also prune
  whole files on their Hive partition values.  A Filter the tags keep
  on the CPU engine pushes nothing.
- Once the plan is lowered, ``inject_runtime_filters`` adds a runtime
  join filter to each eligible join (``plan/runtime_filter.py``).
- A window with partition keys over several input partitions lowers
  as the JAX planner's ``L.Window`` branch: a hash exchange on the
  partition keys (unless the child is already hash-distributed so)
  under a per-partition ``TpuWindowExec``; any other window drains its
  input into one batch.
- A sort over several partitions lowers as ``_plan_sort``: a range
  exchange (bounds from a sample) under a partition-scoped sort, whose
  partitions come out in key order (``sort.rangeExchange`` off, or one
  input partition: coalesce and sort once).  A LIMIT over a sort with a
  fixed-width primary key becomes a streaming top-n (``_maybe_topn``,
  which reads the sort's input before any exchange), any other LIMIT a
  collect or global limit.
- Only a hash distribution satisfies a join, an aggregate or a window:
  a range exchange's does not (``_hash_satisfies``).
- ``Cached`` lowers to ``execs/cache.py::TpuCacheExec`` over its whole
  child, whatever the plan above reads, so its slot serves every later
  plan; a Filter above it is no Filter over a scan, so nothing pushes
  into, elides over or runtime-filters the scan under a cache.
- The Python nodes (JAX ``planner.py``'s branches) lower to
  ``execs/python_exec.py`` over their whole children: ``MapInArrow`` to
  ``TpuMapInArrowExec`` / ``TpuMapInPandasExec``; ``GroupedPandas`` over
  a hash exchange on its keys when its child has several partitions not
  already distributed so (a keyless one coalesces them);
  ``CoGroupedPandas`` over an exchange of each side into
  ``sql.shuffle.partitions``.  Their exchanges launch K1.  A declared
  output type with no device layout keeps the node on the CPU engine.
- ``TorchScalarUDF`` (``udf/exprs.py``) is registered as the JAX
  ``JaxScalarUDF`` is; ``OpaquePythonUDF`` is not, so a node holding
  one runs on the CPU engine.
- Before lowering, ``_rewrite_scalar_subqueries`` (the JAX planner's
  prepass of that name) runs each ScalarSubquery of a Filter or Project
  once, through this planner on the session's device, and splices its
  value in as a Literal.  Before it, as in JAX, ``_rewrite_split_
  extracts`` turns ``split(s, d)[i]`` (a plain literal delimiter, a
  literal index >= 0) into ``SplitPart``, and ``_rewrite_input_file_
  exprs`` turns ``input_file_name()`` / ``input_file_block_start()`` /
  ``input_file_block_length()`` in a Project or Filter over a chain of
  Projects and Filters down to a file scan into the hidden columns
  that scan appends (a Filter's output drops them again); elsewhere
  they stay and run on the CPU engine.  Neither prepass mutates the
  caller's plan.
- Partition-aware expressions (``exprs/nondeterministic.py``) get their
  partition context only in Project, Filter, Expand and Generate: one
  in an aggregate, a sort, a window or a join is tagged for the CPU
  engine, and so, with ``spark.rapids.tpu.sql.ansi.enabled``, is an
  expression there that could raise (ANSI flags are polled by those
  four execs only), with the reasons of JAX ``_forbid_partition_aware``
  and ``_forbid_ansi_risky`` (``PlanMeta._check_keyed``).  A Filter pushes into its scan
  only ``io/pushdown.py::pushable_condition``: nothing when the
  condition is nondeterministic, and never a conjunct reading a hidden
  input-file column or, with ANSI on, one that could raise; such a
  Filter is never elided.

The planner hands the scans, exchanges and coalesces one
``TaskRuntime``: the session's task semaphore and upload stream, and
``sql.taskThreads``, ``sql.scan.decodeThreads``, the stage depth and
the upload path (``sql.scan.packedUpload`` and
``sql.wireCompression.*``: ``columnar/transfer.py::WirePolicy``) from
its conf.

Before lowering, the plan is tagged, as the JAX planner tags it
(``PlanMeta``): each node whose exec switch
(``spark.rapids.tpu.sql.exec.<Node>``) is off, whose expressions or
aggregates the registries below do not accept (a class not registered,
its switch ``spark.rapids.tpu.sql.expression.<Class>`` off, an input
type outside its signature in ``plan/typesig.py``, or a
``check_supported`` that raises), or whose shape the device execs do
not run (a residual condition on an outer, semi or anti join, a
keyless outer join, a window ``check_supported`` refuses), or which
is a source whose columns have no device layout
(``schema_device_representable``: an array of a string, decimal or
struct, a map of such keys or values), carries will-not-work reasons.
With ``spark.rapids.tpu.sql.optimizer.enabled`` on, an island of GPU
nodes whose transfers cost more than the card saves joins the CPU side
(``plan/cost.py::optimize_costs``, after ``tag()``).  A GPU node over a
CPU child whose output has no device layout joins the CPU side too
(``_demote_unrepresentable_boundaries``, as in JAX).  With
``spark.rapids.tpu.sql.enabled`` off, every node carries "disabled by
spark.rapids.tpu.sql.enabled" and nothing else is tagged: the whole plan
runs on the CPU engine, its output in host tensors, and a scalar
subquery's subplan runs there too.
The decision is made here, from the tags alone: a tagged node lowers
to ``execs/fallback.py::CpuFallbackExec`` over its lowered children,
and runs on ``cpu/engine.py``; every other node lowers to the GPU
execs, which raise on what they cannot run.
Nothing catches a run-time error to fall back.  ``explain()`` marks
each node ``*`` (GPU) or ``!`` (CPU) with the reasons.
"""

from __future__ import annotations

import copy
from typing import Iterator, Optional

import pyarrow as pa
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import trace as _trace
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import batches_to_arrow
from spark_rapids_tpu_torch.columnar.transfer import WirePolicy
from spark_rapids_tpu_torch.cpu.engine import execute_cpu
from spark_rapids_tpu_torch.serving.cancel import check_point
from spark_rapids_tpu_torch.execs.adaptive import TpuAdaptiveJoinExec
from spark_rapids_tpu_torch.execs.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.execs.base import TaskRuntime, TpuExec
from spark_rapids_tpu_torch.execs.cache import TpuCacheExec
from spark_rapids_tpu_torch.execs.coalesce import plan_coalesce
from spark_rapids_tpu_torch.execs.collect_agg import TpuCollectAggExec
from spark_rapids_tpu_torch.execs.retry import RetryPolicy
from spark_rapids_tpu_torch.execs import python_exec as PX
from spark_rapids_tpu_torch.execs.basic import (
    TpuFilterExec,
    TpuProjectExec,
    TpuRangeExec,
    TpuUnionExec,
)
from spark_rapids_tpu_torch.execs.exchange import (
    TpuCoalescePartitionsExec,
    TpuShuffleExchangeExec,
)
from spark_rapids_tpu_torch.execs.expand import TpuExpandExec
from spark_rapids_tpu_torch.execs.fallback import CpuFallbackExec
from spark_rapids_tpu_torch.execs.generate import TpuGenerateExec
from spark_rapids_tpu_torch.execs.join import (
    TpuBroadcastHashJoinExec,
    TpuShuffledHashJoinExec,
)
from spark_rapids_tpu_torch.execs.limit import (
    TpuCollectLimitExec,
    TpuGlobalLimitExec,
)
from spark_rapids_tpu_torch.execs.sort import (
    TOPN_PRIMARY_TYPES,
    TpuSortExec,
    TpuTopNExec,
)
from spark_rapids_tpu_torch.execs.window import TpuWindowExec
from spark_rapids_tpu_torch.exprs import aggregates as AG
from spark_rapids_tpu_torch.exprs import arithmetic as A
from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs import bitwise as BW
from spark_rapids_tpu_torch.exprs import collections as COLL
from spark_rapids_tpu_torch.exprs import complex as CX
from spark_rapids_tpu_torch.exprs import datetime as DT
from spark_rapids_tpu_torch.exprs import decimal as DEC
from spark_rapids_tpu_torch.exprs import math as M
from spark_rapids_tpu_torch.exprs import nondeterministic as ND
from spark_rapids_tpu_torch.exprs import predicates as P
from spark_rapids_tpu_torch.exprs import strings as S
from spark_rapids_tpu_torch.exprs.base import (
    Alias,
    BoundReference,
    ColumnReference,
    Expression,
    Literal,
    ansi_enabled,
    bind_references,
)
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.hashing import Md5, Murmur3Hash
from spark_rapids_tpu_torch.exprs.subquery import ScalarSubquery, scalar_value
from spark_rapids_tpu_torch.io.pa_filter import compile_filter
from spark_rapids_tpu_torch.io.pushdown import pushable_condition
from spark_rapids_tpu_torch.io.rebase import REBASE_MODE_READ
from spark_rapids_tpu_torch.io.scan import (
    HIDDEN_COLUMNS,
    ArrowSourceExec,
    CsvScanExec,
    OrcScanExec,
    ParquetScanExec,
)
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.ops.partition import (
    HashPartitioning,
    RangePartitioning,
)
from spark_rapids_tpu_torch.parallel.pipeline import prefetch, stage_depth
from spark_rapids_tpu_torch.parallel.speculation import SpeculationPolicy
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan import typesig as TS
from spark_rapids_tpu_torch.plan.cost import optimize_costs
from spark_rapids_tpu_torch.plan.runtime_filter import inject_runtime_filters
from spark_rapids_tpu_torch.python_worker import PYTHON_WORKERS
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager
from spark_rapids_tpu_torch.udf.exprs import TorchScalarUDF


# ---------------------------------------------------------------------- #
# What the GPU runs: the registries the tags check
# ---------------------------------------------------------------------- #

#: expression class -> its switch
SUPPORTED_EXPRS: dict[type, str] = {}
#: expression class -> the input types its device version takes
EXPR_SIGS: dict[type, TS.ExprSig] = {}


def register_expr(cls: type, sig: TS.ExprSig, key_name: str = "") -> None:
    """``cls`` on the GPU under its switch (the JAX key of
    ``key_name``, else of its own name) with its input signature."""
    SUPPORTED_EXPRS[cls] = C.register(
        f"spark.rapids.tpu.sql.expression.{key_name or cls.__name__}", True)
    EXPR_SIGS[cls] = sig


_ANY = TS.ExprSig(TS.ALL)
_ORDERABLE = TS.ExprSig(TS.ORDERABLE)
_ARITH = TS.ExprSig(
    TS.NUMERIC + TS.NULLSIG,
    "decimal arithmetic falls back (unscaled-value math would be wrong)")
_NUMERIC = TS.ExprSig(TS.NUMERIC + TS.NULLSIG)
_LOGIC = TS.ExprSig(TS.BOOLEAN + TS.NULLSIG)
_DT = TS.ExprSig(TS.DATETIME + TS.INTEGRAL + TS.NULLSIG)
_STR = TS.ExprSig(TS.STRING + TS.INTEGRAL + TS.NULLSIG,
                  "needle and length parameters are literals")

# the JAX planner's signatures, class by class
for _sig, _classes in (
    (_ANY, (B.Alias, B.BoundReference, B.ColumnReference, B.Literal,
            P.IsNull, P.IsNotNull, P.AtLeastNNonNulls)),
    (TS.ExprSig(TS.NUMERIC + TS.DECIMAL + TS.NULLSIG,
                "decimal results wider than precision 18 fall back"),
     (A.Add, A.Subtract)),
    (_ARITH, (A.Multiply, A.Divide, A.IntegralDivide, A.Remainder, A.Pmod,
              A.UnaryMinus, A.UnaryPositive, A.Abs, A.Least, A.Greatest)),
    (_ORDERABLE, (P.EqualTo, P.LessThan, P.LessThanOrEqual,
                  P.GreaterThan, P.GreaterThanOrEqual, P.EqualNullSafe,
                  P.In, P.Coalesce, P.If, P.CaseWhen)),
    (_NUMERIC, (P.IsNaN,)),
    (_LOGIC, (P.And, P.Or, P.Not)),
    (TS.ExprSig(TS.COMMON + TS.NULLSIG), (Murmur3Hash,)),
    (TS.ExprSig(TS.STRING + TS.NULLSIG), (Md5,)),
    (TS.ExprSig(TS.DECIMAL + TS.NULLSIG),
     (DEC.PromotePrecision, DEC.CheckOverflow, DEC.UnscaledValue)),
    (TS.ExprSig(TS.INTEGRAL + TS.DECIMAL + TS.NULLSIG), (DEC.MakeDecimal,)),
    (_NUMERIC, (M.Sqrt, M.Cbrt, M.Exp, M.Expm1, M.Sin, M.Cos, M.Tan, M.Cot,
                M.Asin, M.Acos, M.Atan, M.Sinh, M.Cosh, M.Tanh, M.Asinh,
                M.Acosh, M.Atanh, M.Rint, M.Signum, M.ToDegrees,
                M.ToRadians, M.Log, M.Log10, M.Log2, M.Log1p, M.Logarithm,
                M.Pow, M.Ceil, M.Floor, M.Round, M.BRound,
                M.KnownFloatingPointNormalized)),
    (TS.ExprSig(TS.TypeSig.of("float", "double") + TS.NULLSIG,
                "NaN semantics need floating inputs"),
     (M.NaNvl, M.NormalizeNaNAndZero)),
    (TS.ExprSig(TS.INTEGRAL + TS.NULLSIG),
     (BW.BitwiseAnd, BW.BitwiseOr, BW.BitwiseXor, BW.BitwiseNot,
      BW.ShiftLeft, BW.ShiftRight, BW.ShiftRightUnsigned)),
    (_DT, (DT.Year, DT.Month, DT.DayOfMonth, DT.DayOfWeek, DT.WeekDay,
           DT.DayOfYear, DT.Quarter, DT.LastDay, DT.Hour, DT.Minute,
           DT.Second, DT.DateAdd, DT.DateSub, DT.AddMonths, DT.DateDiff,
           DT.UnixTimestampFromTs, DT.DateFormatClass, DT.TimeAdd,
           DT.TimeSub, DT.DateAddInterval)),
    (TS.ExprSig(TS.INTEGRAL + TS.NULLSIG, "epoch seconds input"),
     (DT.FromUnixTime,)),
    (_STR, (S.Length, S.Upper, S.Lower, S.StartsWith, S.EndsWith,
            S.Contains, S.Like, S.Substring, S.StringTrim,
            S.StringTrimLeft, S.StringTrimRight, S.Concat,
            S.StringReplace, S.RegExpReplace, S.StringLPad, S.StringRPad,
            S.StringLocate, S.SubstringIndex, S.InitCap, S.ConcatWs,
            S.StringSplit, S.SplitPart, S.GetJsonObject)),
    (TS.ExprSig(TS.ALL, "the cast pairs in check_supported"), (Cast,)),
    (TS.ExprSig(TS.ALL, "array input required"),
     (COLL.Size, COLL.GetArrayItem, COLL.ArrayContains)),
    (TS.ExprSig(TS.NUMERIC + TS.BOOLEAN + TS.DATETIME + TS.NULLSIG,
                "fixed-width elements only"), (COLL.CreateArray,)),
    (TS.ExprSig(TS.ALL + TS.NESTED, "struct/map input; fixed-width map "
                "key/value on device (check_supported)"),
     (CX.GetStructField, CX.CreateNamedStruct, CX.GetMapValue,
      CX.ElementAt)),
    (TS.ExprSig(TS.ALL, "no inputs"),
     (ND.SparkPartitionID, ND.MonotonicallyIncreasingID, ND.Rand)),
    (TS.ExprSig(TS.ALL, "rewritten to hidden scan columns above file "
                "scans; other positions fall back (Spark default values)"),
     ND.INPUT_FILE_EXPRS),
):
    for _cls in _classes:
        register_expr(_cls, _sig)
# a torch UDF runs in the exec like a built-in, under the switch of its
# JAX counterpart; an opaque Python UDF stays unregistered, so its node
# runs on the CPU engine
register_expr(TorchScalarUDF, TS.ExprSig(
    TS.NUMERIC + TS.BOOLEAN + TS.DATETIME + TS.NULLSIG,
    "user columnar function over fixed-width device arrays"),
    key_name="JaxScalarUDF")

#: the aggregates the device group-by computes
SUPPORTED_AGGS = (AG.Sum, AG.Count, AG.CountStar, AG.Min, AG.Max,
                  AG.Average, AG.First, AG.Last, AG.CollectList,
                  AG.CollectSet)
_VALUE_TYPES = TS.NUMERIC + TS.DECIMAL + TS.DATETIME + TS.BOOLEAN \
    + TS.NULLSIG
#: aggregate class -> the input types the device group-by takes (the
#: JAX ``AGG_SIGS``)
AGG_SIGS: dict[type, TS.ExprSig] = {
    AG.CollectList: TS.ExprSig(
        TS.NUMERIC + TS.DATETIME + TS.BOOLEAN + TS.NULLSIG,
        "fixed-width elements only"),
    AG.CollectSet: TS.ExprSig(
        TS.NUMERIC + TS.DATETIME + TS.BOOLEAN + TS.NULLSIG,
        "fixed-width elements only"),
    AG.Sum: TS.ExprSig(TS.NUMERIC + TS.DECIMAL + TS.NULLSIG),
    AG.Average: TS.ExprSig(TS.NUMERIC + TS.NULLSIG,
                           "decimal avg needs scale-aware division"),
    AG.Count: TS.ExprSig(TS.ALL),
    AG.CountStar: TS.ExprSig(TS.ALL),
    AG.Min: TS.ExprSig(_VALUE_TYPES, "string min/max falls back"),
    AG.Max: TS.ExprSig(_VALUE_TYPES, "string min/max falls back"),
    AG.First: TS.ExprSig(_VALUE_TYPES),
    AG.Last: TS.ExprSig(_VALUE_TYPES),
}

#: logical node class -> its switch, under the JAX package's key names
#: (the Parquet leaf is its ``ParquetRelation``)
EXEC_SWITCHES: dict[type, str] = {
    cls: C.register("spark.rapids.tpu.sql.exec." + (
        "ParquetRelation" if cls is L.Scan else cls.__name__), True)
    for cls in (L.Scan, L.OrcRelation, L.CsvRelation, L.InMemoryRelation,
                L.RangeRel, L.Project,
                L.Filter, L.Aggregate, L.Expand, L.Generate, L.Join, L.Window,
                L.Sort, L.Limit, L.Union, L.MapInArrow, L.GroupedPandas,
                L.CoGroupedPandas, L.Cached)
}

#: every node's reason with ``spark.rapids.tpu.sql.enabled`` off
SWITCH_OFF_REASON = f"disabled by {C.SQL_ENABLED}"

#: nodes whose output is what a Python function returns
_PYTHON_NODES = (L.MapInArrow, L.GroupedPandas, L.CoGroupedPandas)


def _check_expr(e: Expression, conf: C.TorchConf, reasons: set) -> None:
    """Reasons ``e`` (bound) or any expression under it cannot run on
    the GPU."""
    key = SUPPORTED_EXPRS.get(type(e))
    if key is None:
        reasons.add(f"expression {type(e).__name__} is not supported on "
                    "the GPU")
    elif not conf.get(key):
        reasons.add(f"expression {type(e).__name__} disabled by {key}")
    TS.check_inputs(e, EXPR_SIGS.get(type(e)), reasons)
    check = getattr(e, "check_supported", None)
    if check is not None:
        try:
            check()
        except TypeError as exc:
            reasons.add(str(exc))
    for c in e.children:
        _check_expr(c, conf, reasons)


def _check_agg(fn: AG.AggregateFunction, reasons: set) -> None:
    """Reasons the device group-by cannot compute ``fn`` (bound)."""
    if not isinstance(fn, SUPPORTED_AGGS):
        reasons.add(f"aggregate {fn.name} is not supported on the GPU")
        return
    sig = AGG_SIGS[type(fn)]
    if fn.child is not None and not sig.inputs.supports(fn.child.dtype):
        reasons.add(
            f"aggregate {fn.name} does not support input type "
            f"{fn.child.dtype.name} on the GPU (supported: "
            f"{sig.inputs.describe()})")
    check = getattr(fn, "check_supported", None)
    if check is not None:
        try:
            check()
        except TypeError as exc:
            reasons.add(str(exc))


#: element types an array or a map holds on the device (the JAX list)
_DEVICE_ELEMENTS = (T.BooleanType, T.ByteType, T.ShortType, T.IntegerType,
                    T.LongType, T.FloatType, T.DoubleType, T.DateType,
                    T.TimestampType)


def schema_device_representable(schema: T.Schema) -> bool:
    """Whether a batch of ``schema`` has a device layout: an array's
    elements and a map's keys and values fixed-width (not a string, a
    decimal or a nested type), a struct's fields each representable
    (JAX ``_schema_device_representable``)."""

    def ok(dt: T.DataType) -> bool:
        if isinstance(dt, T.ListType):
            return isinstance(dt.element, _DEVICE_ELEMENTS)
        if isinstance(dt, T.StructType):
            return all(ok(f.dtype) for f in dt.fields)
        if isinstance(dt, T.MapType):
            return isinstance(dt.key, _DEVICE_ELEMENTS) \
                and isinstance(dt.value, _DEVICE_ELEMENTS)
        return True

    return all(ok(f.dtype) for f in schema.fields)


def _is_collect(fn) -> bool:
    return isinstance(fn, AG.CollectList)


class PlanMeta:
    """A logical node with its will-not-work reasons, over its
    children's metas."""

    def __init__(self, plan: L.LogicalPlan, conf: C.TorchConf):
        self.plan = plan
        self.conf = conf
        self.children = [PlanMeta(c, conf) for c in plan.children]
        self.reasons: set[str] = set()

    @property
    def can_replace(self) -> bool:
        return not self.reasons

    def will_not_work(self, reason: str) -> None:
        self.reasons.add(reason)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def tag(self) -> None:
        key = EXEC_SWITCHES.get(type(self.plan))
        if key is None:
            self.will_not_work(
                f"operator {self.plan.name} is not supported on the GPU")
        elif not self.conf.get(key):
            self.will_not_work(f"disabled by {key}")
        if key is not None and not self.children \
                and not schema_device_representable(self.plan.schema):
            # a source of columns that can never upload: a CPU source
            self.will_not_work("source output type has no device layout")
        self._tag_exprs()
        for c in self.children:
            c.tag()

    def _check(self, e: Expression, schema: T.Schema) -> None:
        _check_expr(bind_references(e, schema), self.conf, self.reasons)

    def _check_keyed(self, e: Expression, schema: T.Schema,
                     where: str) -> None:
        """``_check`` for an expression outside project / filter /
        expand / generate, where partition context and ANSI polling are
        missing (``where`` names the position in the reason)."""
        self._check(e, schema)
        if ND.tree_is_partition_aware(e):
            self.will_not_work(
                f"nondeterministic expression as {where} is only "
                "supported in project/filter on the GPU")
        if ansi_enabled(self.conf) and _tree_has_ansi_risk(e):
            self.will_not_work(
                f"ANSI-checked expression as {where} only runs on the GPU "
                "inside project/filter — CPU fallback")

    def _tag_exprs(self) -> None:  # noqa: C901 - one branch a node
        p = self.plan
        cs = p.children[0].schema if p.children else None
        if isinstance(p, L.Project):
            for e in p.exprs:
                self._check(e, cs)
        elif isinstance(p, L.Filter):
            self._check(p.condition, cs)
        elif isinstance(p, L.Expand):
            for proj in p.projections:
                for e in proj:
                    self._check(e, cs)
        elif isinstance(p, L.Generate):
            _check_expr(p.generator.child, self.conf, self.reasons)
            try:
                p.generator.check_supported()
            except TypeError as exc:
                self.will_not_work(str(exc))
        elif isinstance(p, L.Aggregate):
            if any(_is_collect(na.fn) for na in p.aggs) and not all(
                    _is_collect(na.fn) for na in p.aggs):
                self.will_not_work(
                    "collect_list/collect_set beside other aggregates "
                    "(the collect exec computes collects only)")
            for g in p.groups:
                self._check_keyed(g, cs, "grouping key")
            for na in p.aggs:
                fn = na.fn.bind(cs) if isinstance(na.fn, SUPPORTED_AGGS) \
                    else na.fn
                _check_agg(fn, self.reasons)
                for e in na.fn.inputs():
                    self._check_keyed(e, cs, "aggregate input")
        elif isinstance(p, L.Sort):
            for k in p.keys:
                self._check_keyed(k.expr, cs, "sort key")
        elif isinstance(p, L.Window):
            for we, _ in p.window_exprs:
                for e in (list(we.fn.inputs()) + list(we.spec.partition_by)
                          + [k.expr for k in we.spec.order_by]):
                    self._check_keyed(e, cs, "window input")
                try:
                    we.bind(cs).check_supported()
                except (NotImplementedError, TypeError) as exc:
                    self.will_not_work(str(exc))
        elif isinstance(p, _PYTHON_NODES) \
                and not schema_device_representable(p.schema):
            self.will_not_work("declared output type has no device layout")
        elif isinstance(p, L.Join):
            ls, rs = (c.schema for c in p.children)
            for k in p.left_keys:
                self._check_keyed(k, ls, "join key")
            for k in p.right_keys:
                self._check_keyed(k, rs, "join key")
            if p.condition is not None:
                if p.join_type != "inner":
                    self.will_not_work(
                        f"{p.join_type} join with a residual condition")
                else:
                    both = T.Schema(list(ls.fields) + list(rs.fields))
                    self._check(p.condition, both)
                    if ansi_enabled(self.conf) \
                            and _tree_has_ansi_risk(p.condition):
                        self.will_not_work(
                            "ANSI-checked expression as join condition "
                            "only runs on the GPU inside project/filter — "
                            "CPU fallback")
            if not p.left_keys and p.join_type not in ("cross", "inner"):
                self.will_not_work(f"{p.join_type} join without keys")

    def explain(self, indent: int = 0) -> str:
        """The tree, one node a line: ``*`` runs on the GPU, ``!`` on the
        CPU engine, with its reasons."""
        mark = "*" if self.can_replace else "!"
        s = "  " * indent + f"{mark} {self.plan.node_desc()}"
        if self.reasons:
            s += "  <-- cannot run on the GPU because " + "; ".join(
                sorted(self.reasons))
        s += "\n"
        for c in self.children:
            s += c.explain(indent + 1)
        return s



class Planner:
    """Lowers logical plans for one session: its conf, device, shuffle
    manager, task semaphore (None: the process semaphore), upload
    stream (None: uploads on the consumer's stream) and buffer store
    (None: the process store, read when an exec parks a batch)."""

    def __init__(self, conf: C.TorchConf, device: torch.device,
                 manager: ShuffleManager,
                 semaphore: Optional[TpuSemaphore] = None,
                 upload_stream=None, store=None):
        self.conf = conf
        self.device = device
        self.manager = manager
        self.runtime = TaskRuntime(
            semaphore or TpuSemaphore.get(conf),
            task_threads=conf.get(C.TASK_THREADS),
            decode_threads=conf.get(C.DECODE_THREADS),
            stage_depth=stage_depth(conf), upload_stream=upload_stream,
            retry=RetryPolicy.from_conf(conf, store),
            speculation=SpeculationPolicy.from_conf(conf),
            wire=WirePolicy.from_conf(conf))
        #: id(logical node) -> its meta, while a plan is lowered
        self._tags: dict[int, PlanMeta] = {}

    def plan(self, plan: L.LogicalPlan) -> TpuExec:
        return self.plan_with_meta(plan)[0]

    def plan_with_meta(self, plan: L.LogicalPlan
                       ) -> tuple[TpuExec, PlanMeta]:
        """The physical plan and the tagged logical tree it came from
        (``query.tag`` and ``query.lower`` spans, as the JAX
        ``plan_query`` records)."""
        with _trace.span("query.tag"):
            plan = _rewrite_split_extracts(plan)
            plan = _rewrite_input_file_exprs(plan)
            plan = self._rewrite_scalar_subqueries(plan)
            meta = PlanMeta(plan, self.conf)
            if self.conf.get(C.SQL_ENABLED):
                meta.tag()
                optimize_costs(meta)
                _demote_unrepresentable_boundaries(meta)
            else:
                # every node, where JAX tags the root alone and lowers
                # its children to the device: nothing touches the card
                for m in meta.walk():
                    m.will_not_work(SWITCH_OFF_REASON)
        with _trace.span("query.lower"):
            saved, self._tags = self._tags, {id(m.plan): m
                                             for m in meta.walk()}
            try:
                root = self._lower(plan, None)
            finally:
                self._tags = saved
            inject_runtime_filters(root, self.conf)
            plan_coalesce(root, self.conf)
            level = self.conf.get(C.METRICS_LEVEL)
            for node in root.walk():
                node.metrics_level = level  # collect_metrics' default
        return root, meta

    def _rewrite_scalar_subqueries(self, plan: L.LogicalPlan
                                   ) -> L.LogicalPlan:
        """The plan with every ScalarSubquery in a Filter's condition or
        a Project's list replaced by its value, each subplan run once;
        nodes that change are shallow copies (the caller's plan is not
        mutated)."""
        children = [self._rewrite_scalar_subqueries(c)
                    for c in plan.children]

        def rw(e: Expression) -> Expression:
            if isinstance(e, ScalarSubquery):
                if self.conf.get(C.SQL_ENABLED):
                    table = collect_exec(self.plan(e.plan), self.conf)
                else:  # the switch off: the CPU engine (JAX subquery_value)
                    table = execute_cpu(e.plan,
                                        ansi=ansi_enabled(self.conf))
                return Literal(scalar_value(table), e.dtype)
            return e

        out = copy.copy(plan)
        out.children = children
        if isinstance(plan, L.Filter) and _has_subquery(plan.condition):
            out.condition = plan.condition.transform_up(rw)
        elif isinstance(plan, L.Project) \
                and any(_has_subquery(e) for e in plan.exprs):
            out.exprs = [e.transform_up(rw) for e in plan.exprs]
        elif all(a is b for a, b in zip(children, plan.children)):
            return plan
        return out

    def _lower(self, p: L.LogicalPlan, required: Optional[set]) -> TpuExec:
        """``required``: column names the parent reads (None = all)."""
        meta = self._tags.get(id(p))
        ansi = ansi_enabled(self.conf)
        if meta is not None and not meta.can_replace:
            # the CPU engine reads its children's whole schemas; with the
            # master switch off its output stays in host tensors
            return CpuFallbackExec(
                p, meta.reasons, [self._lower(c, None) for c in p.children],
                self.device if self.conf.get(C.SQL_ENABLED)
                else torch.device("cpu"), self.conf.get(C.BATCH_ROWS),
                self.runtime, ansi=ansi)
        if isinstance(p, L.FileRelation):
            return self._plan_scan(p, required)
        if isinstance(p, L.InMemoryRelation):
            return ArrowSourceExec(p.table, p.schema, self.device,
                                   self.conf.get(C.BATCH_ROWS),
                                   _leaf_columns(p.schema, required),
                                   self.runtime)
        if isinstance(p, L.RangeRel):
            return TpuRangeExec(p.start, p.end, p.step, self.device,
                                self.conf.get(C.BATCH_ROWS))
        if isinstance(p, L.Expand):
            keep = _kept_positions(p.schema, required)
            need = set().union(*(proj[i].references()
                                 for proj in p.projections for i in keep))
            return TpuExpandExec(
                [[proj[i] for i in keep] for proj in p.projections],
                T.Schema([p.schema.fields[i] for i in keep]),
                self._lower(p.children[0], need), ansi=ansi)
        if isinstance(p, L.Union):
            return self._plan_union(p, required)
        if isinstance(p, L.Cached):
            # the whole child, whatever this plan reads: the slot serves
            # every later plan
            return TpuCacheExec(p.slot, self._lower(p.children[0], None),
                                self.runtime)
        if isinstance(p, _PYTHON_NODES):
            return self._plan_python(p)
        if isinstance(p, L.Generate):
            made = {p.out_name, "pos"} if p.generator.pos else {p.out_name}
            keep = None if required is None else required - made
            need = None if keep is None else keep | p.unbound.references()
            return TpuGenerateExec(p.unbound, p.out_name,
                                   self._lower(p.children[0], need), keep,
                                   ansi=ansi)
        if isinstance(p, L.Filter):
            elide = self._can_elide_device_filter(p)
            need = None if required is None \
                else required | p.condition.references()
            child = self._lower(p.children[0], required if elide else need)
            if isinstance(child, ParquetScanExec):
                pushed = self._pushable(p.condition)
                if pushed is not None:
                    child.push_filter(pushed, exact=elide)
                if elide:
                    return child
            return TpuFilterExec(p.condition, child, ansi=ansi)
        if isinstance(p, L.Project):
            need = set().union(*(e.references() for e in p.exprs))
            if any(_by_position(e) for e in p.exprs):
                need = None  # ordinals of the unpruned child
            return TpuProjectExec(p.exprs, self._lower(p.children[0], need),
                                  ansi=ansi)
        if isinstance(p, L.Aggregate):
            need = set().union(*(e.references() for e in p.groups),
                               *(e.references() for na in p.aggs
                                 for e in na.fn.inputs()))
            return self._plan_aggregate(p, self._lower(p.children[0], need))
        if isinstance(p, L.Join):
            cond = set() if p.condition is None \
                else p.condition.references()
            sides = []
            for child, keys, keep in (
                    (p.children[0], p.left_keys, True),
                    (p.children[1], p.right_keys,
                     p.join_type not in ("left_semi", "left_anti"))):
                need = None
                if required is not None:
                    # each side: its keys, and what the parent reads of
                    # its half of the output
                    need = set().union(*(k.references() for k in keys))
                    names = set(child.schema.names)
                    need |= cond & names
                    if keep:
                        need |= required & names
                sides.append(self._lower(child, need))
            return self._plan_join(p, *sides)
        if isinstance(p, L.Window):
            need = None
            if required is not None:
                made = {name for _, name in p.window_exprs}
                need = (required - made).union(
                    *(we.references() for we, _ in p.window_exprs))
            return self._plan_window(p, self._lower(p.children[0], need))
        if isinstance(p, L.Sort):
            need = None if required is None else required.union(
                *(k.expr.references() for k in p.keys))
            return self._plan_sort(p, self._lower(p.children[0], need))
        if isinstance(p, L.Limit):
            child = self._lower(p.children[0], required)
            topn = self._maybe_topn(p, child)
            if topn is not None:
                return topn
            if child.num_partitions > 1:
                return TpuCollectLimitExec(p.n, child)
            return TpuGlobalLimitExec(p.n, child)
        raise NotImplementedError(
            f"{type(p).__name__} is not lowered by spark_rapids_tpu_torch")

    def _plan_scan(self, p: L.FileRelation, required: Optional[set]
                   ) -> ParquetScanExec:
        """A file relation's scan exec (JAX ``convert_meta``'s three
        relation branches), reading the columns ``required``."""
        args = (p.paths, p.schema)
        if isinstance(p, L.CsvRelation):
            cls, args = CsvScanExec, args + (p.file_fields,)
        else:
            cls = OrcScanExec if isinstance(p, L.OrcRelation) \
                else ParquetScanExec
        scan = cls(
            *args, self.device, self.conf.get(C.TASK_TARGET_BYTES),
            self.conf.get(C.BATCH_ROWS), _leaf_columns(p.schema, required),
            p.estimated_rows(), self.runtime,
            fast_decode=self.conf.get(C.FAST_DECODE),
            host_prefilter=self.conf.get(C.HOST_PREFILTER),
            max_decoded_bytes=self.conf.get(C.MAX_READ_BATCH_BYTES),
            rebase_mode=self.conf.get(REBASE_MODE_READ),
            partition_values=p.partition_values,
            partition_fields=p.partition_fields)
        if self.conf.get(C.SHARING_ENABLED) \
                and self.conf.get(C.SHARING_SCANS):
            scan.share_conf = self.conf
        return scan

    def _pushable(self, condition: Expression) -> Optional[Expression]:
        """What of a Filter's condition its scan may take
        (``io/pushdown.py::pushable_condition``)."""
        ansi = ansi_enabled(self.conf)
        return pushable_condition(condition, lambda c: bool(
            c.references() & HIDDEN_COLUMNS)
            or (ansi and _tree_has_ansi_risk(c)))

    def _can_elide_device_filter(self, p: L.Filter) -> bool:
        """Whether the Filter over a file scan can go: the prefilter
        is on and its compiled form covers the whole condition, which
        reads at least one column, is deterministic, reads no hidden
        input-file column, and ANSI is off (JAX
        ``_can_elide_device_filter``)."""
        child = p.children[0]
        meta = self._tags.get(id(child))
        if not (isinstance(child, L.FileRelation)
                and (meta is None or meta.can_replace)
                and self.conf.get(C.ELIDE_DEVICE_FILTER)
                and self.conf.get(C.HOST_PREFILTER)
                and p.condition.references()
                and not ansi_enabled(self.conf)
                and self._pushable(p.condition) is p.condition):
            return False
        return compile_filter(
            bind_references(p.condition, child.schema)) is not None

    def _plan_union(self, p: L.Union, required: Optional[set]) -> TpuExec:
        """Each member lowered for the kept positions' names, then
        projected to exactly those positions where it kept more (a
        member with a name twice is lowered whole and projected by
        position)."""
        keep = _kept_positions(p.schema, required)
        members = []
        for child in p.children:
            names = child.schema.names
            unique = len(set(names)) == len(names)
            need = None if required is None or not unique \
                else {names[i] for i in keep}
            m = self._lower(child, need)
            ords = [m.schema.index_of(names[i]) for i in keep] if unique \
                else keep
            if ords != list(range(len(m.schema))):
                m = TpuProjectExec([
                    BoundReference(o, m.schema.fields[o].dtype,
                                   m.schema.fields[o].nullable,
                                   m.schema.fields[o].name)
                    for o in ords], m)
            members.append(m)
        return TpuUnionExec(T.Schema([p.schema.fields[i] for i in keep]),
                            *members)

    def _exchange(self, partitioning, child: TpuExec
                  ) -> TpuShuffleExchangeExec:
        return TpuShuffleExchangeExec(
            partitioning, child, self.manager,
            self.conf.get(C.SORT_SAMPLES_PER_BATCH), self.runtime,
            self.conf.get(C.BATCH_ROWS))

    def _plan_python(self, p: L.LogicalPlan) -> TpuExec:
        """A Python node (JAX ``planner.py``'s MapInArrow, GroupedPandas
        and CoGroupedPandas branches) over its whole children: a grouped
        one over a hash exchange on its keys when its child has several
        partitions not already distributed so (a keyless one coalesces
        them), a cogroup over an exchange of each side."""
        kw = dict(device=self.device, runtime=self.runtime,
                  max_workers=self.conf.get(PYTHON_WORKERS))
        kids = [self._lower(c, None) for c in p.children]
        if isinstance(p, L.MapInArrow):
            cls = PX.TpuMapInPandasExec if p.pandas else PX.TpuMapInArrowExec
            return cls(p.fn, p.schema, kids[0], **kw)
        n = self.conf.get(C.SHUFFLE_PARTITIONS)
        if isinstance(p, L.CoGroupedPandas):
            sides = [self._exchange(HashPartitioning(
                [ColumnReference(k) for k in keys], n), kid)
                for kid, keys in ((kids[0], p.left_key_names),
                                  (kids[1], p.right_key_names))]
            return PX.TpuFlatMapCoGroupsInPandasExec(
                p.left_key_names, p.right_key_names, p.fn, p.schema,
                *sides, **kw)
        source = kids[0]
        if source.num_partitions > 1 and p.key_names:
            bound = [bind_references(ColumnReference(k), source.schema)
                     for k in p.key_names]
            if _hash_satisfies(source, bound) is None:
                source = self._exchange(HashPartitioning(
                    [ColumnReference(k) for k in p.key_names], n), source)
        elif source.num_partitions > 1:
            source = TpuCoalescePartitionsExec(source, self.runtime)
        cls = {"flatmap": PX.TpuFlatMapGroupsInPandasExec,
               "agg": PX.TpuAggregateInPandasExec,
               "window": PX.TpuWindowInPandasExec}[p.kind]
        return cls(p.key_names, p.payload, p.schema, source, **kw)

    def _plan_collect(self, p: L.Aggregate, child: TpuExec) -> TpuExec:
        """All-collect aggregates (JAX ``_plan_aggregate``'s collect
        branch): several partitions hash-exchange on the group keys,
        unless the child already satisfies them, and collect per reduce
        partition; a grand collect coalesces them."""
        rt = self.runtime
        if child.num_partitions > 1:
            if not p.groups:
                return TpuCollectAggExec(
                    p.groups, p.aggs, TpuCoalescePartitionsExec(child, rt),
                    runtime=rt)
            bound = [bind_references(g, child.schema) for g in p.groups]
            if _hash_satisfies(child, bound) is None:
                n = self.conf.get(C.SHUFFLE_PARTITIONS)
                child = self._exchange(HashPartitioning(p.groups, n), child)
            return TpuCollectAggExec(p.groups, p.aggs, child,
                                     partitioned=True, runtime=rt)
        return TpuCollectAggExec(p.groups, p.aggs, child, runtime=rt)

    def _plan_aggregate(self, p: L.Aggregate, child: TpuExec) -> TpuExec:
        if p.aggs and all(_is_collect(na.fn) for na in p.aggs):
            return self._plan_collect(p, child)
        rt, goal = self.runtime, self.conf.get(C.BATCH_ROWS)
        if child.num_partitions <= 1:
            return TpuHashAggregateExec(p.groups, p.aggs, child, runtime=rt,
                                        goal_rows=goal)
        partial = TpuHashAggregateExec(p.groups, p.aggs, child,
                                       mode="partial", runtime=rt,
                                       goal_rows=goal)
        if p.groups:
            keys = [BoundReference(i, f.dtype, f.nullable, f.name)
                    for i, f in enumerate(
                        partial.schema.fields[: len(p.groups)])]
            n = self.conf.get(C.SHUFFLE_PARTITIONS)
            source: TpuExec = self._exchange(HashPartitioning(keys, n),
                                             partial)
        else:
            source = TpuCoalescePartitionsExec(partial, self.runtime)
        return TpuHashAggregateExec(p.groups, p.aggs, source, mode="final",
                                    input_schema=child.schema, runtime=rt,
                                    goal_rows=goal)

    def _plan_window(self, p: L.Window, child: TpuExec) -> TpuExec:
        part_by = p.window_exprs[0][0].spec.partition_by
        if not part_by or child.num_partitions <= 1:
            return TpuWindowExec(p.window_exprs, child,
                                 runtime=self.runtime)
        bound = [bind_references(e, child.schema) for e in part_by]
        if _hash_satisfies(child, bound) is None:
            n = self.conf.get(C.SHUFFLE_PARTITIONS)
            child = self._exchange(HashPartitioning(part_by, n), child)
        return TpuWindowExec(p.window_exprs, child, partitioned=True,
                             runtime=self.runtime)

    def _plan_sort(self, p: L.Sort, child: TpuExec) -> TpuExec:
        if child.num_partitions > 1 and self.conf.get(C.SORT_RANGE_EXCHANGE):
            n = self.conf.get(C.SHUFFLE_PARTITIONS)
            ex = self._exchange(RangePartitioning(p.keys, n), child)
            return self._sort(p.keys, ex, "partition")
        if child.num_partitions > 1:
            child = TpuCoalescePartitionsExec(child, self.runtime)
        return self._sort(p.keys, child, "global")

    def _sort(self, keys, child: TpuExec, scope: str) -> TpuSortExec:
        return TpuSortExec(keys, child, scope, self.runtime,
                           self.conf.get(C.SORT_SINGLE_BATCH_ROWS),
                           self.conf.get(C.SORT_MAX_BUCKETS),
                           self.conf.get(C.SORT_SAMPLES_PER_BATCH))

    def _maybe_topn(self, p: L.Limit, child: TpuExec) -> Optional[TpuExec]:
        """LIMIT n (at most ``sql.topn.maxRows``) over a sort with a
        fixed-width primary key -> a streaming top-n over the sort's input
        before its coalesce or range exchange (the top-n drains every
        partition)."""
        if not (isinstance(child, TpuSortExec)
                and 0 < p.n <= self.conf.get(C.TOPN_MAX_ROWS)
                and isinstance(child.keys[0].expr.dtype,
                               TOPN_PRIMARY_TYPES)):
            return None
        source = child.children[0]
        if isinstance(source, TpuCoalescePartitionsExec) or (
                isinstance(source, TpuShuffleExchangeExec)
                and isinstance(source.partitioning, RangePartitioning)):
            source = source.children[0]
        return TpuTopNExec(p.n, child.keys, source)

    def _plan_join(self, p: L.Join, left: TpuExec,
                   right: TpuExec) -> TpuExec:
        chunk = self.conf.get(C.JOIN_OUTPUT_CHUNK_ROWS)
        args = (p.left_keys, p.right_keys, p.join_type, left, right, chunk,
                p.condition)
        rt = self.runtime
        candidates = broadcast_candidates(
            p.join_type, p.children[0].estimated_bytes(),
            p.children[1].estimated_bytes(),
            self.conf.get(C.BROADCAST_THRESHOLD))
        if candidates:
            side = min(candidates, key=lambda c: c[1])[0]
            return TpuBroadcastHashJoinExec(*args, build_side=side,
                                            runtime=rt)
        lkeys = [bind_references(k, left.schema) for k in p.left_keys]
        rkeys = [bind_references(k, right.schema) for k in p.right_keys]
        # both sides hash a key alike only when its types are identical
        same_types = all(lk.dtype == rk.dtype
                         for lk, rk in zip(lkeys, rkeys))
        if not (lkeys and p.join_type != "cross" and same_types) or (
                left.num_partitions <= 1 and right.num_partitions <= 1):
            return TpuShuffledHashJoinExec(*args, runtime=rt)
        lsat = _hash_satisfies(left, lkeys)
        rsat = _hash_satisfies(right, rkeys)
        if lsat is not None:
            n = lsat.num_partitions
            if rsat is not None and rsat.num_partitions != n:
                rsat = None  # mismatched widths: re-shuffle the right
        elif rsat is not None:
            n = rsat.num_partitions
        else:
            n = self.conf.get(C.SHUFFLE_PARTITIONS)
        if lsat is None:
            left = self._exchange(HashPartitioning(p.left_keys, n), left)
        if rsat is None:
            right = self._exchange(HashPartitioning(p.right_keys, n), right)
        if self.conf.get(C.ADAPTIVE_ENABLED) and lsat is None \
                and rsat is None:
            # both sides are fresh exchanges: the strategy and the reduce
            # grouping wait for their measured map output (a reused
            # distribution is fixed by the stage that made it)
            return TpuAdaptiveJoinExec(p.left_keys, p.right_keys,
                                       p.join_type, left, right, chunk,
                                       p.condition, runtime=rt,
                                       conf=self.conf)
        return TpuShuffledHashJoinExec(p.left_keys, p.right_keys,
                                       p.join_type, left, right, chunk,
                                       p.condition, partition_wise=True,
                                       runtime=rt)


def _demote_unrepresentable_boundaries(meta: PlanMeta) -> None:
    """A GPU node over a CPU child whose output has no device layout
    would fail at the upload: move the CPU region up until every
    host -> device boundary carries representable types (each demotion
    makes a new boundary one level up, hence the loop)."""
    changed = True
    while changed:
        changed = False
        for m in list(meta.walk()):
            for c in m.children:
                if m.can_replace and not c.can_replace \
                        and not schema_device_representable(c.plan.schema):
                    m.will_not_work(
                        "child output type has no device layout "
                        "(list of string/decimal) — runs on CPU")
                    changed = True


def plan_query(plan: L.LogicalPlan, planner: "Planner"
               ) -> tuple[TpuExec, PlanMeta]:
    """Lower a logical plan: the one place a collect, a stream or a
    prepared template's first execution plans (a prepared template's
    later executions never come here)."""
    return planner.plan_with_meta(plan)


def close_tree(exec_: TpuExec) -> None:
    """Close every node of a physical plan: it releases what the drain
    held and leaves the tree ready to drain again."""
    for node in exec_.walk():
        if hasattr(node, "close"):
            node.close()


def _checked(batches: Iterator) -> Iterator:
    """The drain loop's cancellation checkpoint: a cancelled query
    raises here, on the consumer's thread, before each batch."""
    for b in batches:
        check_point()
        yield b


def _fetched(batch, schema: T.Schema) -> pa.Table:
    """One result batch as Arrow (a ``query.fetch.batch`` span)."""
    if _trace.TRACER.enabled:
        with _trace.span("query.fetch.batch"):
            return batches_to_arrow(iter([batch]), schema)
    return batches_to_arrow(iter([batch]), schema)


def collect_exec(exec_: TpuExec, conf: C.TorchConf) -> pa.Table:
    """Run a physical plan to an Arrow table, fetching batches on a
    ``result.fetch`` stage; the stage and the exec tree are closed on
    every exit."""
    fetch = prefetch(exec_.execute(), stage_depth(conf), "result.fetch")
    try:
        tables = [_fetched(b, exec_.schema) for b in _checked(fetch)]
        return pa.concat_tables(tables) if tables \
            else batches_to_arrow([], exec_.schema)
    finally:
        fetch.close()
        close_tree(exec_)


def stream_exec(exec_: TpuExec, conf: C.TorchConf) -> Iterator[pa.Table]:
    """Run a physical plan and yield each batch as an Arrow table as the
    ``serve.stream.fetch`` stage yields it (the stage runs at most its
    depth ahead of the consumer); the stage and the tree are closed on
    every exit, a consumer's early close too."""
    fetch = prefetch(exec_.execute(), stage_depth(conf), "serve.stream.fetch")
    try:
        for batch in _checked(fetch):
            yield _fetched(batch, exec_.schema)
    finally:
        fetch.close()
        close_tree(exec_)


def _has_subquery(e: Expression) -> bool:
    return isinstance(e, ScalarSubquery) or any(_has_subquery(c)
                                                 for c in e.children)


def _by_position(e) -> bool:
    """True when the expression reads a column by its ordinal."""
    return isinstance(e, BoundReference) or any(_by_position(c)
                                                for c in e.children)


def _kept_positions(schema: T.Schema, required: Optional[set]
                    ) -> list[int]:
    """The positions of ``schema`` whose names the parent reads (all of
    them for None); a COUNT(*)-only parent still needs one column's row
    counts, so never none."""
    if required is None:
        return list(range(len(schema)))
    return [i for i, n in enumerate(schema.names) if n in required] or [0]


def _leaf_columns(schema: T.Schema, required: Optional[set]
                  ) -> Optional[list[str]]:
    """The columns a source reads: None for all."""
    if required is None:
        return None
    return [schema.names[i] for i in _kept_positions(schema, required)]


def broadcast_candidates(join_type: str, lbytes: Optional[int],
                         rbytes: Optional[int],
                         threshold: int) -> list[tuple[str, int]]:
    """The legal (build side, estimated bytes) pairs of a broadcast
    join within the threshold: an outer join builds the side it does not
    preserve, full_outer never broadcasts, -1 disables."""
    out: list[tuple[str, int]] = []
    if threshold < 0 or join_type == "full_outer":
        return out
    if join_type in ("inner", "cross", "left_outer", "left_semi",
                     "left_anti") and rbytes is not None \
            and rbytes <= threshold:
        out.append(("right", rbytes))
    if join_type in ("inner", "cross", "right_outer") \
            and lbytes is not None and lbytes <= threshold:
        out.append(("left", lbytes))
    return out


def _hash_satisfies(exec_: TpuExec,
                    keys: list) -> Optional[HashPartitioning]:
    """The child's hash distribution when it hashes exactly these key
    columns (same ordinals, same types), else None."""
    part = exec_.output_partitioning
    if not isinstance(part, HashPartitioning) \
            or len(part.exprs) != len(keys):
        return None
    for pe, jk in zip(part.exprs, keys):
        if not (isinstance(pe, BoundReference)
                and isinstance(jk, BoundReference)
                and pe.ordinal == jk.ordinal and pe.dtype == jk.dtype):
            return None
    return part


def _tree_has_ansi_risk(e: Expression) -> bool:
    """Whether the tree holds an expression whose ANSI checks only the
    Project / Filter / Expand / Generate execs poll: integral Add /
    Subtract / Multiply, the divide family, a Cast."""
    if isinstance(e, (Cast, A.Add, A.Subtract, A.Multiply, A.Divide,
                      A.IntegralDivide, A.Remainder, A.Pmod)):
        return True
    return any(_tree_has_ansi_risk(c) for c in e.children)


def _map_node_exprs(plan: L.LogicalPlan, children: list, fn
                    ) -> L.LogicalPlan:
    """``plan`` over ``children`` with ``fn`` applied to a Project's or a
    Filter's expressions; a shallow copy when anything changed."""
    out = copy.copy(plan)
    out.children = children
    changed = any(a is not b for a, b in zip(children, plan.children))
    if isinstance(plan, L.Project):
        exprs = [fn(e) for e in plan.exprs]
        if any(a is not b for a, b in zip(exprs, plan.exprs)):
            out.exprs, changed = exprs, True
    elif isinstance(plan, L.Filter):
        cond = fn(plan.condition)
        if cond is not plan.condition:
            out.condition, changed = cond, True
    return out if changed else plan


def _rewrite_split_extracts(plan: L.LogicalPlan) -> L.LogicalPlan:
    """JAX's prepass of that name: ``split(s, d)[i]`` (GetArrayItem over
    a StringSplit with a plain literal delimiter, no limit and a literal
    index >= 0) becomes ``SplitPart``; any other split stays, and its
    ``check_supported`` sends it to the CPU engine."""

    def xform(e: Expression) -> Expression:
        if isinstance(e, COLL.GetArrayItem) \
                and isinstance(e.child, S.StringSplit) \
                and isinstance(e.index, Literal) \
                and e.index.value is not None and int(e.index.value) >= 0:
            sp = e.child
            if isinstance(sp.delim, Literal) and sp.delim.value \
                    and not any(ch in S.StringSplit._META
                                for ch in sp.delim.value) \
                    and sp.limit == -1:
                return S.SplitPart(sp.child, sp.delim, int(e.index.value))
        return e

    def rw(e: Expression) -> Expression:
        return e.transform_up(xform) if _has(e, COLL.GetArrayItem) else e

    children = [_rewrite_split_extracts(c) for c in plan.children]
    return _map_node_exprs(plan, children, rw)


def _has(e: Expression, cls) -> bool:
    return isinstance(e, cls) or any(_has(c, cls) for c in e.children)


def _rewrite_input_file_exprs(plan: L.LogicalPlan) -> L.LogicalPlan:
    """JAX's prepass of that name: an input-file expression in a Project
    or a Filter whose child is a chain of Projects and Filters down to a
    file scan reads the hidden column the scan then appends (the
    chain passes the three hidden columns up; a rewritten Filter is
    projected back to its own columns).  Any other position keeps the
    expression, whose ``check_supported`` sends it to the CPU engine."""

    def node_exprs(p):
        if isinstance(p, L.Project):
            return p.exprs
        if isinstance(p, L.Filter):
            return [p.condition]
        return []

    def augment(p: L.LogicalPlan) -> Optional[L.LogicalPlan]:
        if isinstance(p, L.FileRelation):
            return p.with_input_files()
        if isinstance(p, L.Project):
            child = augment(p.children[0])
            if child is None:
                return None
            made = set(p.schema.names)
            return L.Project(list(p.exprs) + [
                ColumnReference(f.name) for f in ND.INPUT_FILE_FIELDS
                if f.name not in made], child)
        if isinstance(p, L.Filter):
            child = augment(p.children[0])
            return None if child is None else L.Filter(p.condition, child)
        return None

    def replace(e: Expression) -> Expression:
        if isinstance(e, ND.InputFileName):
            return Alias(ColumnReference(e.HIDDEN), e.name)
        return e

    def walk(p: L.LogicalPlan) -> L.LogicalPlan:
        children = [walk(c) for c in p.children]
        if any(a is not b for a, b in zip(children, p.children)):
            p = copy.copy(p)
            p.children = children
        if not any(_has(e, ND.InputFileName) for e in node_exprs(p)):
            return p
        child = augment(p.children[0])
        if child is None:
            return p
        if isinstance(p, L.Project):
            return L.Project([e.transform_up(replace) for e in p.exprs],
                             child)
        kept = L.Filter(p.condition.transform_up(replace), child)
        return L.Project([ColumnReference(n)
                          for n in p.children[0].schema.names], kept)

    return walk(plan)
