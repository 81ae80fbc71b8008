"""The port's front door: a pyspark-shaped session and DataFrame.

Counterpart of ``spark_rapids_tpu/session.py`` for the slices ported so
far: ``TorchSession.read_parquet / create_dataframe / range`` and
``DataFrame.where / select / with_column / group_by(...).agg / rollup /
cube / grouping_sets / agg / join / union / order_by / limit /
collect``, with ``col``, ``lit``, ``sum_``, ``avg``, ``count``,
``count_star``, ``count_distinct``, ``min_``, ``max_``, ``first``,
``last``, ``collect_list`` and ``collect_set``, the array functions
``array``, ``array_size``, ``get_item``, ``array_contains`` and
``named_struct``, and ``Expression.get_field / element_at /
get_map_value``, and the long tail of the JAX helpers: ``rand``,
``monotonically_increasing_id``, ``spark_partition_id``, ``nanvl``,
``replace_``, ``regexp_replace``, ``lpad``, ``rpad``, ``locate``,
``substring_index``, ``initcap`` and ``concat_ws`` (``Md5``, the bitwise
classes and ``InputFileName`` are built as classes, as the JAX
package's tests build them).  ``GroupedData.pivot(col, values)`` expands each
aggregate into one masked aggregate per listed value (JAX
``expand_pivot_aggs``).  ``select`` takes one top-level generator,
``explode``, ``explode_outer``, ``posexplode`` or ``posexplode_outer``:
it becomes a ``Generate`` node under the projection, as Spark's
ExtractGenerator rule makes it; a generator anywhere else in the list
is an analysis error.  ``select`` takes window expressions (``rank()``,
``row_number()``, ``dense_rank()``, ``lead``, ``lag`` or an aggregate,
``.over(Window.partition_by(...).order_by(...))``) anywhere in its
list: they are extracted into ``Window`` plan nodes under the
projection, one per (partition_by, order_by) group.

As there, grouping sets (rollup, cube) become an Expand that nulls
each set's dropped keys and tags its rows with ``__gid``, an aggregate
over the keys and ``__gid``, and a projection that drops ``__gid``;
``count_distinct`` becomes a two-level aggregate; ``union`` widens its
members' column types (INT < LONG < DOUBLE, NULL to anything) with a
cast, or raises TypeError.  ``grouping()`` / ``grouping_id()``, and
``count_distinct`` beside other aggregates or over grouping sets, are
not in the JAX package and not here.

``DataFrame.cache`` / ``persist`` / ``unpersist`` (``plan/logical.py::
Cached``, ``execs/cache.py``), ``map_in_arrow`` and ``map_in_pandas``,
and on ``GroupedData`` ``apply_in_pandas``, ``agg_in_pandas``,
``transform_in_pandas`` and ``cogroup(...).apply_in_pandas`` run user
Python in the worker pool (``python_worker``); ``udf`` and
``torch_udf`` are in ``udf/``, and ``explain()`` ends with each torch or
opaque UDF's tier.

A session runs on one device, ``cuda`` unless the caller asks for the
CPU.  Asking for CUDA on a host without it raises: the CPU engine that
runs the nodes the planner tags off the GPU is part of the plan, not a
device.  It owns its shuffle manager and, on CUDA, the side stream its
scans upload on.  The buffer store and the task semaphore are the
process's (``plugin.py``): the first session brings the plugin up,
which sizes the store from that session's conf and device (on CUDA
``memory.fraction`` of the card unless ``memory.hbm.budgetBytes`` is
set; its disk tier under ``memory.spill.dir`` or a temporary
directory) and makes the semaphore; later sessions use them, and each
query aligns the semaphore's permits with its conf
(``TpuSemaphore.sync_conf``).  ``spill_stats()`` and ``retry_stats()``
read the store's and the OOM ladder's counters; after a ``collect``
the store holds none of the query's batches.  A conf with
``robustness.faults.enabled`` arms its fault schedule for each query.
``collect`` runs the plan on a ``result.fetch`` stage and converts each
batch as it comes, as the JAX package's ``stream_exec`` does.
``config.SERIAL`` holds the keys that run a query serially.

The serving tier (``serving/``): ``TorchSession(conf, device, tenant=,
priority=)`` names the admission queue its queries join and their
weighted-fair share; every ``collect`` passes admission (one conf read
while ``serving.maxConcurrent`` is 0), carries a cancel token
(``cancel(query_id)``), and with ``serving.sharing.enabled`` consults
the cross-tenant result cache.  ``prepare(df)`` returns a
``PreparedQuery`` over the session's plan cache (``plan_cache``).

Observability (``trace/``): the session syncs the tracer, the device
ledger, the telemetry sampler and ``MetricTimer``'s device sync with
its conf when it is built and at each query
(``sync_observability``).  Each query runs under a
``trace_context(query_id=...)`` with ``query.plan`` and
``query.execute`` spans (a stream's execute span covers its whole
drain), a result served from the cache records
``serve.result_cache_hit`` and a query cancelled before it started
``cancel.shed``; ``export_trace(path)`` writes the trace as Chrome
JSON.

The query history and the event log (``tools/profiling.py``,
``eventlog/``): every query a session runs (a collect, a stream drained
to its end, a prepared execution, a result served from the cache, a
query cancelled) is recorded in ``session.history`` with its plan's
text and a snapshot of its operators' settled metrics, taken on the
query's thread once the metric reaper has settled them (a cached tree
drained again records the execution's own deltas).  With
``eventLog.enabled`` each is also a JSONL record in the session's file
(``event_log_path``), written by the history's worker.
``explain("analyze")`` runs the query and renders its operators'
settled metrics with the jit-cache, retry, fault, runtime-filter and
plan-cache footers (and the ledger's, with the ledger on).  With
``obs.enabled`` (``obs/``) each query in flight is listed under the ops
plane's ``/queries`` and its wall feeds the SLO watchdog.

Files (``plan/logical.py``'s file relations, ``io/scan.py``,
``io/write.py``): ``read_parquet(*paths, columns=)``, ``read_orc(*paths,
columns=)`` and ``read_csv(*paths, schema=)`` take files or directories,
whose Hive ``key=value`` directories become trailing partition columns;
``df.write.mode(m).partition_by(*cols).compression(c)
.parquet / csv / orc(path)`` (and ``write_parquet / write_csv /
write_orc(path, mode=, partition_by=)``) plans the query as ``collect``
does, under admission and a cancel token, and runs its
``FileWriteExec``; it returns the ``WriteStats`` (None when mode
``ignore`` skipped the write).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Iterator, Optional, Sequence, Union

import pyarrow as pa
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import obs as _obs
from spark_rapids_tpu_torch import trace as _trace
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import schema_from_arrow
from spark_rapids_tpu_torch.config import TorchConf
from spark_rapids_tpu_torch.eventlog import (
    conf_fingerprint,
    maybe_writer,
    plan_fingerprint,
    render_plan_report,
    table_digest,
)
from spark_rapids_tpu_torch.execs.base import TpuExec, sync_metrics_conf
from spark_rapids_tpu_torch.execs.sort import SortKey
from spark_rapids_tpu_torch.exprs.aggregates import (
    AggregateFunction,
    Average,
    CollectList,
    CollectSet,
    Count,
    CountDistinct,
    CountStar,
    First,
    Last,
    Max,
    Min,
    NamedAgg,
    Sum,
    expand_pivot_aggs,
)
from spark_rapids_tpu_torch.exprs.base import (
    Alias,
    BoundReference,
    ColumnReference,
    Expression,
    Literal,
    _column,
    col,
    lit,
)
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.collections import (
    ArrayContains,
    CreateArray,
    Explode,
    GetArrayItem,
    Size,
)
from spark_rapids_tpu_torch.exprs.complex import CreateNamedStruct
from spark_rapids_tpu_torch.exprs.datetime import DateFormatClass, FromUnixTime
from spark_rapids_tpu_torch.exprs.math import NaNvl
from spark_rapids_tpu_torch.exprs.nondeterministic import (
    MonotonicallyIncreasingID,
    Rand,
    SparkPartitionID,
)
from spark_rapids_tpu_torch.exprs.strings import (
    ConcatWs,
    InitCap,
    RegExpReplace,
    StringLocate,
    StringLPad,
    StringReplace,
    StringRPad,
    SubstringIndex,
)
from spark_rapids_tpu_torch.exprs.window import WindowExpression
from spark_rapids_tpu_torch.execs import retry as _retry
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.memory.store import get_store
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan import planner as _planner
from spark_rapids_tpu_torch.plan.planner import Planner
from spark_rapids_tpu_torch.plan.runtime_filter import render_runtime_filters
from spark_rapids_tpu_torch.plugin import TorchPlugin
from spark_rapids_tpu_torch.robustness import faults
from spark_rapids_tpu_torch.robustness import lock_tracker as _locks
from spark_rapids_tpu_torch.serving import cancel as _cancel
from spark_rapids_tpu_torch.serving import update_serving_context
from spark_rapids_tpu_torch.serving.scheduler import admission
from spark_rapids_tpu_torch.udf.exprs import OpaquePythonUDF, TorchScalarUDF
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager
from spark_rapids_tpu_torch.tools.profiling import (
    QueryHistory,
    next_query_id,
    render_analyze,
    snapshot_exec,
)
from spark_rapids_tpu_torch.trace import ledger as _ledger
from spark_rapids_tpu_torch.trace import telemetry as _telemetry

__all__ = ["TorchSession", "DataFrame", "col", "lit", "sum_", "avg",
           "count", "count_star", "count_distinct", "min_", "max_",
           "first", "last", "from_unixtime", "date_format",
           "collect_list", "collect_set", "explode", "explode_outer",
           "posexplode", "posexplode_outer", "array", "array_size",
           "get_item", "array_contains", "named_struct", "rand",
           "monotonically_increasing_id", "spark_partition_id", "nanvl",
           "replace_", "regexp_replace", "lpad", "rpad", "locate",
           "substring_index", "initcap", "concat_ws"]

AggLike = Union[NamedAgg, AggregateFunction, tuple]


def sum_(e) -> Sum:
    return Sum(_column(e))


def avg(e) -> Average:
    return Average(_column(e))


def count(e) -> Count:
    return Count(_column(e))


def count_star() -> CountStar:
    return CountStar()


def min_(e) -> Min:
    return Min(_column(e))


def max_(e) -> Max:
    return Max(_column(e))


def count_distinct(e) -> CountDistinct:
    return CountDistinct(_column(e))


def first(e, ignore_nulls: bool = False) -> First:
    return First(_column(e), ignore_nulls)


def last(e, ignore_nulls: bool = False) -> Last:
    return Last(_column(e), ignore_nulls)


def collect_list(e) -> CollectList:
    return CollectList(_column(e))


def collect_set(e) -> CollectSet:
    return CollectSet(_column(e))


def explode(e) -> Explode:
    return Explode(_column(e))


def explode_outer(e) -> Explode:
    return Explode(_column(e), outer=True)


def posexplode(e) -> Explode:
    return Explode(_column(e), pos=True)


def posexplode_outer(e) -> Explode:
    return Explode(_column(e), pos=True, outer=True)


def array(*exprs) -> CreateArray:
    return CreateArray(*[_column(e) for e in exprs])


def array_size(e) -> Size:
    return Size(_column(e))


def get_item(e, index: int) -> GetArrayItem:
    """array[index], 0-based."""
    return GetArrayItem(_column(e), lit(index))


def array_contains(e, value) -> ArrayContains:
    return ArrayContains(_column(e), lit(value))


def named_struct(*names_and_values) -> CreateNamedStruct:
    """named_struct("a", e1, "b", e2, ...), as Spark's."""
    names = names_and_values[0::2]
    values = tuple(_column(v) for v in names_and_values[1::2])
    return CreateNamedStruct(tuple(names), values)


def from_unixtime(e, fmt: str = "yyyy-MM-dd HH:mm:ss") -> FromUnixTime:
    return FromUnixTime(_column(e), fmt)


def date_format(e, fmt: str = "yyyy-MM-dd") -> DateFormatClass:
    return DateFormatClass(_column(e), fmt)


def rand(seed: int = 0) -> Rand:
    return Rand(seed)


def monotonically_increasing_id() -> MonotonicallyIncreasingID:
    return MonotonicallyIncreasingID()


def spark_partition_id() -> SparkPartitionID:
    return SparkPartitionID()


def nanvl(a, b) -> NaNvl:
    return NaNvl(_column(a), _column(b))


def replace_(e, search: str, replacement: str) -> StringReplace:
    return StringReplace(_column(e), lit(search), lit(replacement))


def regexp_replace(e, pattern: str, replacement: str) -> RegExpReplace:
    return RegExpReplace(_column(e), lit(pattern), lit(replacement))


def lpad(e, length: int, pad: str = " ") -> StringLPad:
    return StringLPad(_column(e), lit(length), lit(pad))


def rpad(e, length: int, pad: str = " ") -> StringRPad:
    return StringRPad(_column(e), lit(length), lit(pad))


def locate(substr: str, e, start: int = 1) -> StringLocate:
    return StringLocate(lit(substr), _column(e), lit(start))


def substring_index(e, delim: str, count: int) -> SubstringIndex:
    return SubstringIndex(_column(e), lit(delim), lit(count))


def initcap(e) -> InitCap:
    return InitCap(_column(e))


def concat_ws(sep: str, *exprs) -> ConcatWs:
    return ConcatWs(lit(sep), *[_column(e) for e in exprs])


def _coerce_union_member(plan: L.LogicalPlan,
                         widened: Sequence[Optional[T.DataType]]
                         ) -> L.LogicalPlan:
    """A union member projected onto the widened column types; the
    member itself when nothing changes.  Columns are read by name, or by
    position where a name occurs twice."""
    fields = plan.schema.fields
    if all(ct is None or ct == f.dtype for f, ct in zip(fields, widened)):
        return plan
    unique = len(set(plan.schema.names)) == len(fields)
    exprs: list[Expression] = []
    for i, (f, ct) in enumerate(zip(fields, widened)):
        ref = ColumnReference(f.name) if unique \
            else BoundReference(i, f.dtype, f.nullable, f.name)
        exprs.append(ref if ct is None or ct == f.dtype
                     else Cast(ref, ct).alias(f.name))
    return L.Project(exprs, plan)


def _extract_windows(e: Expression, acc: list) -> Expression:
    """``e`` with every window expression replaced by a reference to a
    generated column ``__w<i>``; the expressions and names go to
    ``acc``."""
    if isinstance(e, WindowExpression):
        name = f"__w{len(acc)}"
        acc.append((e, name))
        return ColumnReference(name)
    kids = e.children
    new = [_extract_windows(c, acc) for c in kids]
    if all(n is o for n, o in zip(new, kids)):
        return e
    return e.with_children(new)


def _forbid_nested_explode(e: Expression) -> None:
    """A generator is valid only at the top of a select list (Spark
    raises the same analysis error for a nested one)."""
    for c in e.children:
        if isinstance(c, Explode):
            raise ValueError("explode/posexplode must be at the top level "
                             "of a select list")
        _forbid_nested_explode(c)


def _extract_generator(plan: L.LogicalPlan, exprs: list[Expression]
                       ) -> L.LogicalPlan:
    """The select list's one top-level generator (bare or aliased) as a
    ``Generate`` node over ``plan``; ``exprs`` gets references to its
    columns in its place."""
    gens = [(i, e) for i, e in enumerate(exprs)
            if isinstance(e, Explode)
            or (isinstance(e, Alias) and isinstance(e.child, Explode))]
    if gens:
        if len(gens) > 1:
            raise ValueError("only one explode per select")
        i, e = gens[0]
        alias_name = e.out_name if isinstance(e, Alias) else None
        gen = e.child if isinstance(e, Alias) else e
        if gen.pos and alias_name is not None:
            raise ValueError("posexplode yields two columns (pos, col); "
                             "alias them with a following select")
        out_name = alias_name or "col"
        plan = L.Generate(gen, plan, out_name=out_name)
        exprs[i:i + 1] = ([ColumnReference("pos")] if gen.pos else []) \
            + [ColumnReference(out_name)]
    for e in exprs:
        _forbid_nested_explode(e)
    return plan


def render_udfs(plan: L.LogicalPlan) -> list[str]:
    """explain() lines: the tier of each torch or opaque UDF in the plan
    (a compiled UDF is a tree of built-in expressions)."""
    lines: list[str] = []

    def walk_expr(e: Expression) -> None:
        if isinstance(e, (TorchScalarUDF, OpaquePythonUDF)):
            line = f"udf {e.fn_name}: tier {e.tier}"
            if line not in lines:
                lines.append(line)
        for c in e.children:
            walk_expr(c)

    def walk(p: L.LogicalPlan) -> None:
        if isinstance(p, L.Project):
            for e in p.exprs:
                walk_expr(e)
        elif isinstance(p, L.Filter):
            walk_expr(p.condition)
        for c in p.children:
            walk(c)

    walk(plan)
    return lines


def sync_observability(conf: TorchConf, writer=None) -> None:
    """Align the process tracer, ledger, telemetry sampler, ops plane
    and ``MetricTimer``'s device sync with ``conf`` (at session build
    and at each query boundary), under the JAX ownership rule: a
    programmatic ``enable()`` / ``start()`` is not overridden, and only
    the conf that turned one on turns it off.  ``writer``, the
    session's event log, is attached to the sampler and the
    watchdog."""
    _trace.sync_conf(conf)
    _ledger.sync_conf(conf)
    _telemetry.sync_conf(conf, writer=writer)
    _obs.sync_conf(conf, writer=writer)
    sync_metrics_conf(conf)


class _QueryRecord:
    """One query's prologue (its id, the ops plane's entry, the event
    log's counters before it, its clocks) and its epilogue
    (:meth:`record`)."""

    def __init__(self, session: "TorchSession", qid: int, tok):
        self.qid = qid
        self.conf_hash = conf_fingerprint(session.conf)
        if _obs.REGISTRY.enabled:
            _obs.REGISTRY.begin(qid, tenant=session.tenant, token=tok,
                                conf_hash=self.conf_hash)
        self.elog = session._eventlog
        self.pre = self.elog.query_begin() if self.elog is not None \
            else None
        self.start_ts = time.time()
        self.t0 = time.perf_counter()
        self.t0_ns = time.perf_counter_ns()

    def annotate(self, meta, tok=None) -> None:
        """The plan, once planning rendered it, on the ops plane."""
        if _obs.REGISTRY.enabled and meta is not None:
            text = meta.explain()
            _obs.REGISTRY.annotate(self.qid, plan=text,
                                   plan_hash=plan_fingerprint(text),
                                   token=tok)

    def record(self, session: "TorchSession", explain: str, exec_tree,
               engine: str, plan_text=None,
               result: Optional[pa.Table] = None,
               rows: Optional[int] = None, baseline=None) -> None:
        """The epilogue, on the query's thread: leave the ops plane
        (feeding the watchdog), take the event log's end-of-query
        counters, and record the history event (``exec_tree``'s
        settled metrics less ``baseline``).  The log record, with
        ``plan_text()`` (default ``explain``) and ``result``'s digest,
        is appended by the history's worker."""
        _obs.REGISTRY.finish(self.qid, engine=engine)
        on_event = None
        elog = self.elog
        if elog is not None:
            post = elog.query_end(self.pre)
            n = result.num_rows if result is not None else rows

            def on_event(ev):
                elog.log_query(
                    ev, post, plan_text() if plan_text else explain,
                    engine, result_digest=table_digest(result)
                    if result is not None else None, rows=n)

        session.history.record(
            explain, exec_tree, time.perf_counter() - self.t0,
            query_id=self.qid, start_ts=self.start_ts, end_ts=time.time(),
            start_ns=self.t0_ns, end_ns=time.perf_counter_ns(),
            conf_hash=self.conf_hash, on_event=on_event,
            baseline=baseline)


class TorchSession:
    def __init__(self, conf: Optional[Union[TorchConf, dict]] = None,
                 device: Union[str, torch.device] = "cuda",
                 tenant: str = "default", priority: Optional[int] = None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchSession(device='cuda') needs a CUDA device and "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "to run on the CPU")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        self.device = device
        self.conf = conf if isinstance(conf, TorchConf) else TorchConf(conf)
        self.plugin = TorchPlugin.get_or_create(self.conf, device)
        self.shuffle_manager = ShuffleManager()
        self.upload_stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        #: the admission queue this session's queries join, and their
        #: weighted-fair share (None: ``serving.defaultPriority``)
        self.tenant = tenant
        self.priority = priority
        self._plan_cache = None  # made by the first prepare
        self._plan_cache_lock = threading.Lock()
        #: the cancel tokens of this session's queries in flight
        self._tokens = _cancel.TokenSet()
        #: recent queries (``tools/profiling.QueryHistory``)
        self.history = QueryHistory(self.conf.get(C.HISTORY_CAPACITY))
        #: the event-log writer, None with ``eventLog.enabled`` off
        self._eventlog = maybe_writer(self.conf)
        sync_observability(self.conf, self._eventlog)

    @property
    def event_log_path(self) -> Optional[str]:
        """This session's event-log file (None with the log off).  Its
        records are appended by the history's worker: read
        ``history.events`` first and the file is complete."""
        return self._eventlog.path if self._eventlog is not None \
            else None

    @property
    def store(self):
        """The process buffer store (the live plugin's)."""
        return get_store()

    @property
    def semaphore(self) -> TpuSemaphore:
        """The process task semaphore."""
        return TpuSemaphore.get(self.conf)

    @property
    def plan_cache(self):
        """This session's prepared-plan cache (an LRU of lowered exec
        trees, ``serving.planCache.capacity``), made on first use."""
        with self._plan_cache_lock:
            if self._plan_cache is None:
                from spark_rapids_tpu_torch.serving.plan_cache import (
                    PlanCache,
                )

                self._plan_cache = PlanCache(
                    self.conf.get(C.PLAN_CACHE_CAPACITY), self.conf)
            return self._plan_cache

    def prepare(self, df: "DataFrame"):
        """Lower a DataFrame template once into the plan cache; the
        returned ``PreparedQuery``'s ``execute`` / ``execute_stream``
        drain the cached tree.  SQL text with ``:name`` parameters
        prepares through ``frontends.sql.SqlSession.prepare``."""
        from spark_rapids_tpu_torch.serving.prepared import PreparedQuery

        if not isinstance(df, DataFrame):
            raise TypeError("TorchSession.prepare takes a DataFrame; for "
                            "SQL text use frontends.sql.SqlSession.prepare")
        pq = PreparedQuery(self, df=df)
        pq._resolve(None)  # pay the lowering now
        return pq

    def cancel(self, query_id: Optional[int] = None,
               reason: str = "cancelled") -> int:
        """Cancel this session's queries in flight (all, or the one with
        ``query_id``): each raises ``QueryCancelled`` at its next
        checkpoint and unwinds (admission slot, permits, store entries
        released).  How many were newly cancelled.  A query still
        waiting for admission has no id yet; only the cancel-all form
        reaches it."""
        return self._tokens.cancel(query_id, reason)

    @staticmethod
    def export_trace(path: str) -> str:
        """Write the process's collected trace as Chrome Trace Format
        JSON (Perfetto, chrome://tracing); the path.  Run queries with
        ``spark.rapids.tpu.trace.enabled`` first (JAX
        ``TpuSession.export_trace``)."""
        from spark_rapids_tpu_torch.trace.export import export_chrome_trace

        return export_chrome_trace(path)

    def spill_stats(self) -> dict:
        """The process store's gauges and spill totals
        (``BufferStore.spill_stats``)."""
        return self.store.spill_stats()

    @staticmethod
    def retry_stats() -> dict:
        """What the OOM ladder absorbed, process-wide
        (``execs/retry.retry_stats``)."""
        return _retry.retry_stats()

    def read_parquet(self, *paths: str,
                     columns: Optional[Sequence[str]] = None) -> "DataFrame":
        """Parquet files or directories of them (Hive partitions become
        trailing columns); ``columns`` projects over both kinds."""
        return DataFrame(L.Scan(list(paths), columns), self)

    def read_orc(self, *paths: str,
                 columns: Optional[Sequence[str]] = None) -> "DataFrame":
        """ORC files or directories, as ``read_parquet``."""
        return DataFrame(L.OrcRelation(list(paths), columns), self)

    def read_csv(self, *paths: str,
                 schema: Optional[T.Schema] = None) -> "DataFrame":
        """CSV files with a header line, or directories of them, cast to
        ``schema`` (None: the types pyarrow infers from the first)."""
        return DataFrame(L.CsvRelation(list(paths), schema), self)

    def create_dataframe(self, data: Union[pa.Table, dict]) -> "DataFrame":
        """A host Arrow table (or a dict of columns) as a DataFrame; its
        batches upload to the session's device."""
        table = data if isinstance(data, pa.Table) else pa.table(data)
        return DataFrame(L.InMemoryRelation(table), self)

    def range(self, start: int, end: Optional[int] = None,
              step: int = 1) -> "DataFrame":
        """``id`` (LONG) from ``start`` to ``end`` (exclusive), or from
        0 to ``start`` when ``end`` is None."""
        if end is None:
            start, end = 0, start
        return DataFrame(L.RangeRel(start, end, step), self)


def _engine_schema(schema: Union[pa.Schema, T.Schema]) -> T.Schema:
    return schema_from_arrow(schema) if isinstance(schema, pa.Schema) \
        else schema


class _CoGrouped:
    """``a.group_by(...).cogroup(b.group_by(...))``."""

    def __init__(self, left: "GroupedData", right: "GroupedData"):
        self._left = left
        self._right = right

    def apply_in_pandas(self, fn, schema) -> "DataFrame":
        """``fn(left group frame, right group frame) -> frame`` for every
        key either side holds (Spark's cogroup().applyInPandas)."""
        return DataFrame(L.CoGroupedPandas(
            self._left._key_names(), self._right._key_names(), fn,
            _engine_schema(schema), self._left._df._plan,
            self._right._df._plan), self._left._df._session)


class GroupedData:
    """A grouped frame; ``grouping_sets`` (each the set of key names it
    keeps) makes an Expand-based aggregate of every set.  Its pandas
    methods (``apply_in_pandas``, ``agg_in_pandas``,
    ``transform_in_pandas``, ``cogroup``) take plain column keys."""

    def __init__(self, df: "DataFrame", keys: list[Expression],
                 grouping_sets: Optional[list[frozenset]] = None):
        self._df = df
        self._keys = keys
        self._sets = grouping_sets
        self._pivot: Optional[tuple] = None

    def pivot(self, pivot_col, values: Sequence) -> "GroupedData":
        """pyspark's pivot with an explicit value list: each aggregate
        becomes one masked aggregate per value, named ``{value}`` for a
        single aggregate, ``{value}_{name}`` otherwise (Spark's mode that
        queries the distinct values first is not supported, as in the
        JAX package)."""
        if self._sets is not None:
            raise ValueError("pivot over rollup/cube is not supported")
        self._pivot = (_column(pivot_col), list(values))
        return self

    def agg(self, *aggs: AggLike) -> "DataFrame":
        named = []
        for i, a in enumerate(aggs):
            if isinstance(a, NamedAgg):
                named.append(a)
            elif isinstance(a, tuple):
                named.append(NamedAgg(*a))
            else:
                named.append(NamedAgg(a, f"{a.name}_{i}"))
        if self._pivot is not None:
            pcol, values = self._pivot
            named = expand_pivot_aggs(pcol, values, named,
                                      single=len(named) == 1)
        named = [x for na in named for x in (
            na.fn.expand(na.out_name) if hasattr(na.fn, "expand")
            else (na,))]
        if any(isinstance(na.fn, CountDistinct) for na in named):
            return self._agg_distinct(named)
        if self._sets is not None:
            return self._agg_grouping_sets(named)
        return DataFrame(L.Aggregate(self._keys, named, self._df._plan),
                         self._df._session)

    def _key_names(self) -> list[str]:
        names = []
        for k in self._keys:
            if isinstance(k, ColumnReference):
                names.append(k.col_name)
            elif isinstance(k, Alias):
                names.append(k.out_name)
            else:
                raise ValueError("grouped pandas UDFs need plain column keys")
        return names

    def cogroup(self, other: "GroupedData") -> _CoGrouped:
        return _CoGrouped(self, other)

    def apply_in_pandas(self, fn, schema) -> "DataFrame":
        """``fn(pandas frame of a group) -> frame`` of ``schema`` (Spark's
        applyInPandas)."""
        return DataFrame(L.GroupedPandas(
            self._key_names(), fn, _engine_schema(schema), "flatmap",
            self._df._plan), self._df._session)

    def agg_in_pandas(self, *aggs) -> "DataFrame":
        """Pandas aggregates, each (output name, fn(Series) -> scalar,
        input column): the group keys, then a DOUBLE a function."""
        key_names = self._key_names()
        child = self._df._plan.schema
        fields = [child.field(k) for k in key_names] + [
            T.Field(name, T.DOUBLE, True) for name, _fn, _c in aggs]
        return DataFrame(L.GroupedPandas(
            key_names, list(aggs), T.Schema(fields), "agg", self._df._plan),
            self._df._session)

    def transform_in_pandas(self, *fns) -> "DataFrame":
        """Pandas window functions over unbounded frames, each (output
        name, fn(Series) -> scalar, input column): the scalar is given to
        every row of its group, as a DOUBLE after the child's columns."""
        child = self._df._plan.schema
        fields = list(child.fields) + [T.Field(name, T.DOUBLE, True)
                                       for name, _fn, _c in fns]
        return DataFrame(L.GroupedPandas(
            self._key_names(), list(fns), T.Schema(fields), "window",
            self._df._plan), self._df._session)

    def _agg_distinct(self, named: list[NamedAgg]) -> "DataFrame":
        """count(DISTINCT x) as two aggregates: group by (keys, x) to
        drop repeats, then count x per key group (Spark's
        RewriteDistinctAggregates for a single distinct)."""
        if self._sets is not None:
            raise ValueError("count_distinct over grouping sets is not "
                             "supported")
        if not all(isinstance(na.fn, CountDistinct) for na in named):
            raise ValueError("count_distinct beside other aggregates is "
                             "not supported")
        x = named[0].fn.child
        if any(na.fn.child != x for na in named[1:]):
            raise ValueError("count_distinct over different expressions "
                             "is not supported")
        inner = L.Aggregate(self._keys + [x.alias("__dist")], [],
                            self._df._plan)
        key_names = inner.schema.names[: len(self._keys)]
        outer = L.Aggregate(
            [ColumnReference(n) for n in key_names],
            [NamedAgg(Count(ColumnReference("__dist")), na.out_name)
             for na in named], inner)
        return DataFrame(outer, self._df._session)

    def _agg_grouping_sets(self, named: list[NamedAgg]) -> "DataFrame":
        """Expand (a projection a set: the child's columns with the
        set's dropped keys NULL, and ``__gid``, the set's index), an
        aggregate over the keys and ``__gid``, then the keys and the
        aggregates without ``__gid``."""
        child = self._df._plan
        key_names = []
        for k in self._keys:
            if not isinstance(k, ColumnReference):
                raise ValueError("grouping-set keys must be plain columns")
            key_names.append(k.col_name)
        fields = child.schema.fields
        projections = [
            [Literal(None, f.dtype)
             if f.name in key_names and f.name not in included
             else ColumnReference(f.name) for f in fields]
            + [Literal.of(gid)]
            for gid, included in enumerate(self._sets)]
        expand = L.Expand(projections, [f.name for f in fields] + ["__gid"],
                          child)
        agg = L.Aggregate(list(self._keys) + [ColumnReference("__gid")],
                          named, expand)
        return DataFrame(L.Project(
            [ColumnReference(n)
             for n in key_names + [na.out_name for na in named]], agg),
            self._df._session)


class DataFrame:
    def __init__(self, plan: L.LogicalPlan, session: TorchSession):
        self._plan = plan
        self._session = session

    @property
    def schema(self) -> T.Schema:
        return self._plan.schema

    def select(self, *exprs) -> "DataFrame":
        """Projection of expressions or column names; window expressions
        in it become ``Window`` nodes under it, one per (partition_by,
        order_by) group, as Spark's ExtractWindowExpressions rule does."""
        acc: list = []
        rewritten = [_extract_windows(_column(e), acc) for e in exprs]
        plan = _extract_generator(self._plan, rewritten)
        groups: list[tuple[tuple, list]] = []
        for we, name in acc:
            key = (we.spec.partition_by, we.spec.order_by)
            for k, members in groups:
                if k == key:
                    members.append((we, name))
                    break
            else:
                groups.append((key, [(we, name)]))
        for _, members in groups:
            plan = L.Window(members, plan)
        return DataFrame(L.Project(rewritten, plan), self._session)

    def where(self, cond: Expression) -> "DataFrame":
        return DataFrame(L.Filter(cond, self._plan), self._session)

    filter = where

    def with_column(self, name: str, e: Expression) -> "DataFrame":
        """Every other column, then ``e`` as ``name`` (replacing a column
        of that name)."""
        return self.select(*[ColumnReference(n) for n in self.schema.names
                             if n != name], e.alias(name))

    def group_by(self, *keys) -> GroupedData:
        return GroupedData(self, [_column(k) for k in keys])

    def rollup(self, *keys: str) -> GroupedData:
        """GROUP BY ROLLUP: (a, b, c) -> the sets (a, b, c), (a, b), (a)
        and ()."""
        return GroupedData(self, [_column(k) for k in keys], [
            frozenset(keys[:i]) for i in range(len(keys), -1, -1)])

    def cube(self, *keys: str) -> GroupedData:
        """GROUP BY CUBE: every subset of the keys, largest first."""
        return GroupedData(self, [_column(k) for k in keys], [
            frozenset(c) for r in range(len(keys), -1, -1)
            for c in itertools.combinations(keys, r)])

    def grouping_sets(self, sets: Sequence[Sequence[str]],
                      keys: Sequence[str]) -> GroupedData:
        """GROUP BY GROUPING SETS: ``sets`` of the key names in ``keys``."""
        return GroupedData(self, [_column(k) for k in keys],
                           [frozenset(st) for st in sets])

    def agg(self, *aggs: AggLike) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def join(self, other: "DataFrame",
             on: Union[str, Sequence[str], None] = None, how: str = "inner",
             left_on: Optional[Sequence] = None,
             right_on: Optional[Sequence] = None,
             condition: Optional[Expression] = None) -> "DataFrame":
        """Equi-join on ``on`` (column names both sides share) or on
        ``left_on`` / ``right_on``; the output is left ++ right columns.
        ``condition`` (inner joins only) is a residual predicate over
        them; ``how="cross"``, or an inner join with no keys, pairs every
        row with every row."""
        if on is not None:
            names = [on] if isinstance(on, str) else list(on)
            lk = [ColumnReference(n) for n in names]
            rk = [ColumnReference(n) for n in names]
        else:
            lk = [_column(e) for e in (left_on or [])]
            rk = [_column(e) for e in (right_on or [])]
        return DataFrame(L.Join(self._plan, other._plan, lk, rk, how,
                                condition), self._session)

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL by position: each column of the two members widened
        to their common type (Spark's WidenSetOperationTypes), or
        TypeError; the output names are this frame's."""
        lf, rf = self.schema.fields, other.schema.fields
        if len(lf) != len(rf):
            raise TypeError(f"union members have {len(lf)} and {len(rf)} "
                            "columns")
        widened: list[Optional[T.DataType]] = []
        for i, (a, b) in enumerate(zip(lf, rf)):
            ct = T.common_type(a.dtype, b.dtype)
            if ct is None:
                raise TypeError(f"union column {i + 1} ({a.name!r}) has "
                                f"incompatible types {a.dtype} and "
                                f"{b.dtype}")
            widened.append(None if a.dtype == b.dtype else ct)
        return DataFrame(L.Union([
            _coerce_union_member(self._plan, widened),
            _coerce_union_member(other._plan, widened)]), self._session)

    def order_by(self, *keys, desc: bool = False) -> "DataFrame":
        """Sort by ``keys`` (expressions or SortKeys); ``desc`` sorts
        descending with NULLs last, as Spark does."""
        sks = [k if isinstance(k, SortKey)
               else SortKey(_column(k), descending=desc, nulls_last=desc)
               for k in keys]
        return DataFrame(L.Sort(sks, self._plan), self._session)

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(L.Limit(n, self._plan), self._session)

    def cache(self) -> "DataFrame":
        """Materialize this frame once (Spark's ``df.cache()``): the first
        device collect that drains it stores its batches in the session's
        buffer store, and later collects of it, or of frames made from it
        after this call, read them instead of running it again."""
        if not isinstance(self._plan, L.Cached):
            self._plan = L.Cached(self._plan)
        return self

    persist = cache

    def unpersist(self) -> "DataFrame":
        """Drop the cached batches: their store entries close."""
        if isinstance(self._plan, L.Cached):
            self._plan.slot.clear()
        return self

    def map_in_arrow(self, fn, schema) -> "DataFrame":
        """``fn(pa.Table) -> pa.Table`` over each batch, in the Python
        worker pool; ``schema`` (pyarrow or the port's) is the declared
        output, and ``fn`` must pickle (a module-level function)."""
        return DataFrame(L.MapInArrow(fn, _engine_schema(schema),
                                      self._plan), self._session)

    def map_in_pandas(self, fn, schema) -> "DataFrame":
        """``fn(pandas.DataFrame) -> pandas.DataFrame`` over each batch, in
        the worker pool (Spark's mapInPandas)."""
        return DataFrame(L.MapInArrow(fn, _engine_schema(schema), self._plan,
                                      pandas=True), self._session)

    @property
    def write(self) -> "DataFrameWriter":
        """``df.write.mode('overwrite').partition_by('k').parquet(path)``."""
        return DataFrameWriter(self)

    def write_parquet(self, path: str, mode: str = "error",
                      partition_by: Sequence[str] = ()):
        return self.write.mode(mode).partition_by(*partition_by).parquet(path)

    def write_csv(self, path: str, mode: str = "error",
                  partition_by: Sequence[str] = ()):
        return self.write.mode(mode).partition_by(*partition_by).csv(path)

    def write_orc(self, path: str, mode: str = "error",
                  partition_by: Sequence[str] = ()):
        return self.write.mode(mode).partition_by(*partition_by).orc(path)

    def _run_command(self, make_exec):
        """Plan the query, wrap its tree in ``make_exec(tree, runtime)``
        and ``run()`` that, under the same admission, cancel token,
        fault scope and query id a ``collect`` takes."""
        conf = self._session.conf
        tok = self._begin(None)
        try:
            with self._admitted(tok, None):
                qid = self._start_query(tok)
                with faults.query_scope(conf), \
                        _trace.trace_context(query_id=qid):
                    planner = self._planner()
                    with _trace.span("query.plan"):
                        tree, _meta = _planner.plan_query(self._plan,
                                                          planner)
                    with _trace.span("query.execute"):
                        return make_exec(tree, planner.runtime).run()
        except _cancel.QueryCancelled as e:
            _cancel.tick_outcome(e.reason)
            raise
        finally:
            self._end(tok, None)

    def _planner(self) -> Planner:
        s = self._session
        return Planner(s.conf, s.device, s.shuffle_manager, s.semaphore,
                       s.upload_stream)

    def physical_plan(self) -> TpuExec:
        return self._planner().plan(self._plan)

    def explain(self, mode: str = "simple") -> str:
        """``simple``: the tagged logical tree (``*`` on the GPU, ``!``
        on the CPU engine with its reasons), then the physical plan and
        a line for each runtime filter's build site and each scan that
        applies one.  ``analyze``: run the query, then the plan with
        each operator's settled metrics and the query's footers
        (``tools/profiling.render_analyze``)."""
        if mode.lower() == "analyze":
            return self._explain_analyze()
        if mode.lower() != "simple":
            raise ValueError(f"explain mode {mode!r}: simple or analyze")
        plan, meta = self._planner().plan_with_meta(self._plan)
        return "\n".join([meta.explain().rstrip("\n"), plan.tree_string(),
                          *render_runtime_filters(plan),
                          *render_udfs(self._plan)])

    def _explain_analyze(self) -> str:
        """EXPLAIN ANALYZE: the counters around one collect, as deltas
        (process-wide: a concurrent query's activity may show), and its
        history event, found by its id."""
        from spark_rapids_tpu_torch.execs.jit_cache import cache_stats
        from spark_rapids_tpu_torch.plan import runtime_filter as _rf
        from spark_rapids_tpu_torch.serving import plan_cache as _pc

        jit0, retry0 = cache_stats(), _retry.retry_stats()
        faults0, rf0, pc0 = faults.recovered_total(), _rf.stats(), \
            _pc.stats()
        # synced now, not at the query's start, so that the snapshot
        # before it sees a ledger its conf turns on
        _ledger.sync_conf(self._session.conf)
        led0 = _ledger.snapshot() if _ledger.LEDGER.enabled else None
        _out, qid = self._collect()
        jit1, retry1, rf1, pc1 = cache_stats(), _retry.retry_stats(), \
            _rf.stats(), _pc.stats()
        cs = {k: jit1[k] - jit0[k] for k in ("hits", "misses")}
        counters = {
            "retry": {k: max(0, retry1[k] - retry0[k]) for k in retry1},
            "faults_recovered": max(0, faults.recovered_total() - faults0),
            "rf": {k: max(0, rf1[k] - rf0[k]) for k in rf1},
            "plan_cache": {k: max(0, pc1[k] - pc0[k])
                           for k in ("hits", "misses", "evictions")},
        }
        led = None
        if led0 is not None and _ledger.LEDGER.enabled:
            _ledger.LEDGER.flush(timeout=2.0)
            led = _ledger.summarize(_ledger.delta(led0, _ledger.snapshot()))
        events = self._session.history.events
        ev = next((e for e in reversed(events) if e.query_id == qid),
                  events[-1])
        trace_events = _trace.snapshot() if _trace.is_enabled() else None
        return render_analyze(ev, trace_events, cache_stats=cs,
                              counters=counters, ledger=led)

    def collect(self) -> pa.Table:
        """Run the query on the session's device; the result as Arrow.
        The stage and the exec tree are closed on every exit, which
        releases the query's store entries."""
        return self._collect()[0]

    def _begin(self, token_sink):
        """A new query's cancel token, tracked by the session (and by
        ``token_sink``, a prepared template's set)."""
        tok = _cancel.begin(self._session.conf, tenant=self._session.tenant)
        self._session._tokens.add(tok)
        if token_sink is not None:
            token_sink.add(tok)
        return tok

    def _end(self, tok, token_sink) -> None:
        self._session._tokens.discard(tok)
        if token_sink is not None:
            token_sink.discard(tok)
        _cancel.end(tok)

    @contextlib.contextmanager
    def _admitted(self, tok, serving_facts, attach: bool = True):
        """The admission scope of one query (JAX ``_collect_tpu``'s):
        the token attached (not for a stream, whose token is attached
        around each pull and never across a yield), admitted through
        the scheduler under the session's tenant and priority, the
        serving facts deposited."""
        s = self._session
        facts = dict(serving_facts) if serving_facts else {}
        group = facts.pop("admission_group", None)
        with _cancel.attach_token(tok) if tok is not None and attach \
                else contextlib.nullcontext(), \
                admission(s.conf, tenant=s.tenant, priority=s.priority,
                          group=group, token=tok):
            if facts:
                update_serving_context(**facts)
            yield

    def _start_query(self, tok) -> int:
        """The query boundary: the process semaphore, lock tracker and
        observability follow the session's conf; the query's id (its
        token's too)."""
        s = self._session
        TpuSemaphore.sync_conf(s.conf)
        _locks.sync_conf(s.conf)
        sync_observability(s.conf, s._eventlog)
        qid = next_query_id()
        if tok is not None:
            tok.query_id = qid
        return qid

    def _begin_query(self, tok) -> _QueryRecord:
        """:meth:`_start_query` and the record's prologue."""
        return _QueryRecord(self._session, self._start_query(tok), tok)

    def _record_cancelled(self, e: "_cancel.QueryCancelled",
                          serving_facts=None) -> None:
        """Count a cancellation once, and record a query that unwound
        before it ran (shed in the admission queue): its record has no
        operator and the wire front door's ``connect`` facts, which
        admission never deposited."""
        _cancel.tick_outcome(e.reason)
        if e.recorded:
            return
        from spark_rapids_tpu_torch.serving import (
            clear_serving_context,
            current_serving_context,
        )

        q = self._begin_query(None)
        if e.query_id is None:
            e.query_id = q.qid
        expl = (f"CancelledBeforeExecution [{e.reason}: shed in the "
                f"admission queue; no operator ran]\n")
        connect = (serving_facts or {}).get("connect")
        prev = current_serving_context() if connect else None
        if connect:
            update_serving_context(connect=connect)
        try:
            with _trace.trace_context(query_id=q.qid):
                if _trace.TRACER.enabled:
                    _trace.event("cancel.shed", query_id=q.qid,
                                 reason=e.reason)
            q.record(self._session, expl, None, e.reason)
        finally:
            if connect:
                clear_serving_context()
                if prev:
                    update_serving_context(**prev)
        e.recorded = True

    def _result_cache_hit(self, out: pa.Table, meta, tok
                          ) -> tuple[pa.Table, int]:
        """A query served by the result cache: no exec tree, one
        ``serve.result_cache_hit`` event and a record of its own (the
        placeholder operator, the digest and rows of ``out``)."""
        q = self._begin_query(tok)
        expl = meta.explain() if meta is not None else (
            "ResultCacheHit [plan not lowered: served from the "
            "cross-tenant result cache]\n")
        with _trace.trace_context(query_id=q.qid):
            if _trace.TRACER.enabled:
                _trace.event("serve.result_cache_hit", query_id=q.qid,
                             rows=out.num_rows)
        q.record(self._session, expl, None, "tpu", result=out)
        return out, q.qid

    def _collect(self, exec_: Optional[TpuExec] = None, meta=None,
                 drain_lock=None, serving_facts=None, token_sink=None
                 ) -> tuple[pa.Table, int]:
        """collect, or a prepared template's execution over its cached
        ``exec_`` and ``meta`` (planning skipped); the result and the
        query's id.  ``drain_lock`` (the cache entry's) is taken inside
        admission; with ``serving.sharing.enabled`` the result cache is
        consulted inside admission, before it."""
        from spark_rapids_tpu_torch.serving import work_share as _ws

        conf = self._session.conf
        tok = self._begin(token_sink)
        try:
            with self._admitted(tok, serving_facts):
                sharing = conf.get(C.SHARING_ENABLED)
                if sharing:
                    cached, verdict = _ws.lookup_result(self._plan, conf)
                    if verdict is not None:
                        update_serving_context(result_cache=verdict)
                    if cached is not None:
                        return self._result_cache_hit(cached, meta, tok)
                with drain_lock if drain_lock is not None \
                        else contextlib.nullcontext():
                    out, qid = self._collect_admitted(tok, exec_, meta)
                if sharing:
                    _ws.offer_result(self._plan, conf, out)
                return out, qid
        except _cancel.QueryCancelled as e:
            self._record_cancelled(e, serving_facts)
            raise
        finally:
            self._end(tok, token_sink)

    def _collect_admitted(self, tok, exec_, meta) -> tuple[pa.Table, int]:
        """The admitted query: plan unless the tree is given (a cached
        tree's settled metrics are the baseline of its record), run,
        record, all under the fault scope."""
        conf = self._session.conf
        q = self._begin_query(tok)
        try:
            baseline = snapshot_exec(exec_) if exec_ is not None else None
            with faults.query_scope(conf), \
                    _trace.trace_context(query_id=q.qid):
                if exec_ is None:
                    with _trace.span("query.plan"):
                        exec_, meta = _planner.plan_query(
                            self._plan, self._planner())
                q.annotate(meta, tok)
                expl = _explain_text(exec_, meta)
                try:
                    with _trace.span("query.execute"):
                        out = _planner.collect_exec(exec_, conf)
                except _cancel.QueryCancelled as e:
                    # the unwind closed the tree: the record keeps its
                    # partial metrics
                    if e.query_id is None:
                        e.query_id = q.qid
                    expl += f"\n[query unwound: {e.reason}]"
                    q.record(self._session, expl, exec_, e.reason,
                             baseline=baseline)
                    e.recorded = True
                    raise
                q.record(self._session, expl, exec_, "tpu",
                         plan_text=lambda: _plan_text(exec_, meta),
                         result=out, baseline=baseline)
            return out, q.qid
        finally:
            _obs.REGISTRY.drop(q.qid)

    def _stream(self, exec_: Optional[TpuExec] = None, meta=None,
                batch_rows: Optional[int] = None, drain_lock=None,
                serving_facts=None, token_sink=None
                ) -> Iterator[pa.RecordBatch]:
        """The result as Arrow record batches, each as the fetch stage
        yields it (re-chunked to ``batch_rows``): backpressure is the
        stage's depth.  The admission slot and ``drain_lock`` are held
        until the stream is drained or closed.  The token is attached
        around each pull, not across the yields, and a checkpoint runs
        before each (JAX ``_stream_tpu_cancellable``).  A stream drained
        to its end is recorded (its rows, no digest); one closed early
        is not."""
        from spark_rapids_tpu_torch.serving import work_share as _ws

        conf = self._session.conf
        tok = self._begin(token_sink)
        tctx: dict = {}

        @contextlib.contextmanager
        def attach():
            """The token and the query's trace context, around each pull
            (never across a yield)."""
            with _cancel.attach_token(tok) if tok is not None \
                    else contextlib.nullcontext(), \
                    _trace.attach_context(tctx or None):
                yield

        q: Optional[_QueryRecord] = None
        try:
            with self._admitted(tok, serving_facts, attach=False), \
                    drain_lock if drain_lock is not None \
                    else contextlib.nullcontext():
                acc: Optional[list] = None
                if conf.get(C.SHARING_ENABLED):
                    cached, verdict = _ws.lookup_result(self._plan, conf)
                    if verdict is not None:
                        update_serving_context(result_cache=verdict)
                    if cached is not None:
                        out, _qid = self._result_cache_hit(cached, meta, tok)
                        yield from out.to_batches(max_chunksize=batch_rows)
                        return
                    acc, cap = [], conf.get(C.RESULT_CACHE_BUDGET) // 4
                q = self._begin_query(tok)
                tctx["query_id"] = q.qid
                baseline = snapshot_exec(exec_) if exec_ is not None \
                    else None
                rows = 0
                with faults.query_scope(conf):
                    with attach():
                        if exec_ is None:
                            with _trace.span("query.plan"):
                                exec_, meta = _planner.plan_query(
                                    self._plan, self._planner())
                    q.annotate(meta, tok)
                    expl = _explain_text(exec_, meta)
                    gen = _planner.stream_exec(exec_, conf)
                    try:
                        while True:
                            with attach():
                                _cancel.check_point()
                                tbl = next(gen, None)
                            if tbl is None:
                                break
                            rows += tbl.num_rows
                            _obs.REGISTRY.note_batch(q.qid, tbl.num_rows)
                            if acc is not None:
                                acc.append(tbl)
                                if sum(t.nbytes for t in acc) > cap:
                                    acc = None  # past the one-result cap
                            for i, rb in enumerate(tbl.to_batches(
                                    max_chunksize=batch_rows)):
                                if i:  # a checkpoint a frame
                                    with attach():
                                        _cancel.check_point()
                                yield rb
                    except _cancel.QueryCancelled as e:
                        if e.query_id is None:
                            e.query_id = q.qid
                        with attach():
                            gen.close()
                            q.record(self._session,
                                     expl + f"\n[stream unwound: {e.reason}]",
                                     exec_, e.reason, rows=rows,
                                     baseline=baseline)
                        e.recorded = True
                        raise
                    finally:
                        with attach():
                            gen.close()
                    # fully drained: the execute span covers the whole
                    # drain (JAX records a streamed query's the same way)
                    if _trace.TRACER.enabled:
                        _trace.record_complete(
                            "query.execute", q.t0_ns,
                            time.perf_counter_ns() - q.t0_ns,
                            query_id=q.qid, streamed=True)
                    with attach():
                        q.record(self._session, expl, exec_, "tpu",
                                 plan_text=lambda: _plan_text(exec_, meta),
                                 rows=rows, baseline=baseline)
                if acc:
                    _ws.offer_result(self._plan, conf,
                                     pa.concat_tables(acc))
        except _cancel.QueryCancelled as e:
            self._record_cancelled(e, serving_facts)
            raise
        finally:
            self._end(tok, token_sink)
            if q is not None:
                _obs.REGISTRY.drop(q.qid)


def _explain_text(exec_: TpuExec, meta) -> str:
    """A query's history text: its tagged logical tree (the physical
    tree when no planner metadata came with a cached one)."""
    return meta.explain() if meta is not None else exec_.tree_string()


def _plan_text(exec_: TpuExec, meta) -> str:
    """A query's event-log plan: ``explain()``'s report of its tree."""
    if meta is None:
        return exec_.tree_string()
    return render_plan_report(exec_, meta)


class DataFrameWriter:
    """A write's settings (JAX ``DataFrameWriter``): ``mode`` (``error``,
    ``overwrite``, ``append``, ``ignore``), ``partition_by`` and
    ``compression`` (Parquet's and ORC's codec, ``snappy`` by default),
    then ``parquet``, ``csv`` or ``orc`` runs the write and returns its
    ``WriteStats``."""

    def __init__(self, df: DataFrame):
        self._df = df
        self._mode = "error"
        self._partition_by: list[str] = []
        self._compression = "snappy"

    def mode(self, m: str) -> "DataFrameWriter":
        self._mode = m
        return self

    def partition_by(self, *cols: str) -> "DataFrameWriter":
        self._partition_by.extend(cols)
        return self

    def compression(self, c: str) -> "DataFrameWriter":
        self._compression = c
        return self

    def parquet(self, path: str):
        from spark_rapids_tpu_torch.io.write import ParquetWriteExec

        return self._run(ParquetWriteExec, path)

    def csv(self, path: str):
        from spark_rapids_tpu_torch.io.write import CsvWriteExec

        return self._run(CsvWriteExec, path)

    def orc(self, path: str):
        from spark_rapids_tpu_torch.io.write import OrcWriteExec

        return self._run(OrcWriteExec, path)

    def _run(self, exec_cls, path: str):
        from spark_rapids_tpu_torch.io.write import prepare_target

        if not prepare_target(path, self._mode):
            return None
        return self._df._run_command(lambda tree, runtime: exec_cls(
            path, tree, self._partition_by, self._compression, runtime))
