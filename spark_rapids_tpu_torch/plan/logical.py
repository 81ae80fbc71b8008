"""Logical plan nodes: the file relations (``Scan``, which is JAX's
``ParquetRelation``, ``OrcRelation`` and ``CsvRelation``, each over
files or Hive-partitioned directories), InMemoryRelation, RangeRel,
Filter, Project, Aggregate, Expand, Generate, Join, Window, Sort, Limit
and Union; ``Cached`` with its ``CacheSlot`` (``DataFrame.cache``), and
the Python nodes ``MapInArrow``, ``GroupedPandas`` and
``CoGroupedPandas``.

Counterpart of the matching nodes of ``spark_rapids_tpu/plan/logical.py``.
Nodes keep their expressions by column name; the planner binds them to
the physical child, after it has pruned the scan's columns.

Every node estimates an upper bound on its rows and bytes, as there,
for the planner's broadcast choice: a Parquet or ORC scan counts its
files' own row counts (a CSV scan none), an in-memory table its rows, a range its values, a node with one
child passes the child's bound on (a filter can only shrink), a grand
aggregate makes one row, a LIMIT at most its n, a join at most the sum
of its sides (the JAX estimate), an Expand its child's rows times its
projections, a Union the sum of its members, and a Generate nothing
(no bound: nothing bounds an array's length), nor a Python function
that may make rows (MapInArrow, apply_in_pandas, a cogroup).  Bytes are rows times
``row_width_bytes`` of the node's schema.
"""

from __future__ import annotations

import copy
import os
import re
import threading
import weakref
from typing import Optional, Sequence

import pyarrow as pa
import pyarrow.parquet as pq

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import schema_from_arrow
from spark_rapids_tpu_torch.execs.join import JOIN_TYPES, joined_schema
from spark_rapids_tpu_torch.execs.sort import SortKey
from spark_rapids_tpu_torch.exprs.aggregates import NamedAgg
from spark_rapids_tpu_torch.exprs.base import (
    Expression,
    bind_references,
    output_field,
)
from spark_rapids_tpu_torch.exprs.nondeterministic import INPUT_FILE_FIELDS


class LogicalPlan:
    children: list["LogicalPlan"]

    @property
    def schema(self) -> T.Schema:
        raise NotImplementedError

    def estimated_rows(self) -> Optional[int]:
        """An upper bound on the node's rows; None when unknown."""
        if len(self.children) == 1:
            return self.children[0].estimated_rows()
        return None

    def estimated_bytes(self) -> Optional[int]:
        n = self.estimated_rows()
        return None if n is None else n * row_width_bytes(self.schema)

    @property
    def name(self) -> str:
        return type(self).__name__

    def node_desc(self) -> str:
        """One line for ``explain()``, in the JAX nodes' format."""
        return self.name


def _value_bytes(dt: T.DataType) -> int:
    """Estimated bytes of one value: a fixed-width value's size, 32
    chars and a 4-byte length for a string, and the JAX scan's nested
    widths: 128 for an array, 192 for a map, a struct's fields and 1."""
    if isinstance(dt, T.StringType):
        return 32 + 4
    if isinstance(dt, T.ListType):
        return 128
    if isinstance(dt, T.MapType):
        return 192
    if isinstance(dt, T.StructType):
        return 1 + sum(_value_bytes(f.dtype) for f in dt.fields)
    return T.to_torch_dtype(dt).itemsize


def row_width_bytes(schema: T.Schema) -> int:
    """Bytes per row: each value's ``_value_bytes`` and a validity byte
    per column."""
    return max(sum(_value_bytes(f.dtype) + 1 for f in schema.fields), 1)


def expand_scan_paths(paths: Sequence[str], ext: str
                      ) -> tuple[list[str], list[dict], list[str]]:
    """Files, each file's Hive partition values and the partition
    column names, of ``paths`` (JAX ``expand_scan_paths``).  A file path
    is taken as it is; a directory is walked in sorted order, its
    ``key=value`` segments read as the partition values of the files
    under them (``__HIVE_DEFAULT_PARTITION__`` is NULL, ``%XX`` escapes
    are undone), a subdirectory of another shape skipped, and of its
    files only those ending in ``ext`` and not starting with ``_`` or
    ``.`` (``_SUCCESS``, hidden files) are read."""
    files: list[str] = []
    values: list[dict] = []
    part_cols: list[str] = []
    for p in paths:
        if not os.path.isdir(p):
            files.append(p)
            values.append({})
            continue
        for root, dirs, names in sorted(os.walk(p)):
            dirs.sort()
            rel = os.path.relpath(root, p)
            pv: Optional[dict] = {}
            if rel != ".":
                for seg in rel.split(os.sep):
                    if "=" not in seg:
                        pv = None
                        break
                    k, _, v = seg.partition("=")
                    pv[k] = None if v == HIVE_DEFAULT_PARTITION \
                        else _unescape_part(v)
                if pv is None:
                    continue
            for name in sorted(names):
                if name.startswith(("_", ".")) or not name.endswith(ext):
                    continue
                files.append(os.path.join(root, name))
                values.append(dict(pv))
                for k in pv:
                    if k not in part_cols:
                        part_cols.append(k)
    return files, values, part_cols


#: the directory name of a NULL partition value
HIVE_DEFAULT_PARTITION = "__HIVE_DEFAULT_PARTITION__"


def _unescape_part(v: str) -> str:
    return re.sub("%([0-9A-Fa-f]{2})",
                  lambda m: chr(int(m.group(1), 16)), v)


def infer_partition_fields(part_cols: Sequence[str],
                           values: Sequence[dict]) -> list[T.Field]:
    """Each partition column's field: LONG when every non-NULL value
    parses as an integer, else STRING (JAX ``infer_partition_fields``,
    the common part of Spark's partition type inference)."""
    fields = []
    for c in part_cols:
        dtype: T.DataType = T.LONG
        for pv in values:
            v = pv.get(c)
            if v is None:
                continue
            try:
                int(v)
            except (TypeError, ValueError):
                dtype = T.STRING
                break
        fields.append(T.Field(c, dtype, True))
    return fields


class FileRelation:
    """Files of one format and one schema (the first file's), read
    from file paths or from directories with Hive partition discovery
    (JAX ``_FileRelation``); a mixin of the three file relations, each
    a ``LogicalPlan``.  The schema is the file columns, then the
    partition columns (Spark's layout), then, with ``input_files``, the
    hidden input-file columns (``exprs/nondeterministic.py::
    INPUT_FILE_FIELDS``: each row's file path, block start and block
    length), which the planner's ``_rewrite_input_file_exprs`` asks for.
    ``columns`` projects over the file and partition columns alike:
    ``self.columns`` keeps the file columns of it (None: all)."""

    EXT = ""

    def __init__(self, paths: Sequence[str],
                 columns: Optional[Sequence[str]] = None,
                 input_files: bool = False):
        if not paths:
            raise ValueError(f"{self.name} needs at least one path")
        self.children = []
        self.paths, self.partition_values, part_cols = expand_scan_paths(
            list(paths), self.EXT)
        if not self.paths:
            raise FileNotFoundError(f"no {self.EXT} files under "
                                    f"{list(paths)}")
        self.partition_fields = infer_partition_fields(
            part_cols, self.partition_values)
        file_fields = list(self._file_schema(self.paths[0]).fields)
        self.columns: Optional[list[str]] = None
        if columns is not None:
            part_names = {f.name for f in self.partition_fields}
            by_name = {f.name: f for f in file_fields}
            self.columns = [c for c in columns if c not in part_names]
            file_fields = [by_name[c] for c in self.columns]
            self.partition_fields = [f for f in self.partition_fields
                                     if f.name in set(columns)]
        self.file_fields = file_fields
        self.input_files = input_files
        self._set_schema()
        self._est_rows: Optional[int] = None

    def _set_schema(self) -> None:
        self._schema = T.Schema(
            self.file_fields + self.partition_fields
            + (list(INPUT_FILE_FIELDS) if self.input_files else []))

    def with_input_files(self) -> "FileRelation":
        """A copy whose schema ends with the hidden input-file columns;
        the paths are not walked again."""
        if self.input_files:
            return self
        out = copy.copy(self)
        out.input_files = True
        out._set_schema()
        return out

    def _file_schema(self, path: str) -> T.Schema:
        raise NotImplementedError

    def _file_rows(self, path: str) -> int:
        raise NotImplementedError

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def estimated_rows(self) -> Optional[int]:
        """The files' own row counts, read once, on demand."""
        if self._est_rows is None:
            try:
                self._est_rows = sum(self._file_rows(p) for p in self.paths)
            except (OSError, NotImplementedError, pa.ArrowException):
                return None
        return self._est_rows

    def node_desc(self) -> str:
        parts = "" if not self.partition_fields else \
            f" partitioned by {[f.name for f in self.partition_fields]}"
        return (f"{self.name} {[os.path.basename(p) for p in self.paths]}"
                f"{parts}")


class Scan(FileRelation, LogicalPlan):
    """Parquet files: JAX's ``ParquetRelation`` (its exec switch keeps
    that name)."""

    EXT = ".parquet"

    def _file_schema(self, path: str) -> T.Schema:
        return schema_from_arrow(pq.read_schema(path))

    def _file_rows(self, path: str) -> int:
        return pq.read_metadata(path).num_rows


ParquetRelation = Scan


class OrcRelation(FileRelation, LogicalPlan):
    """ORC files (JAX ``OrcRelation``): pyarrow's ORC reader decodes a
    stripe at a time on the host, and the scan uploads stripes as the
    Parquet scan uploads row groups."""

    EXT = ".orc"

    def _file_schema(self, path: str) -> T.Schema:
        import pyarrow.orc as paorc

        return schema_from_arrow(paorc.ORCFile(path).schema)

    def _file_rows(self, path: str) -> int:
        import pyarrow.orc as paorc

        return paorc.ORCFile(path).nrows


class CsvRelation(FileRelation, LogicalPlan):
    """CSV files with a header line (JAX ``CsvRelation``): the columns
    of ``schema``, else the types pyarrow infers from the first file;
    every file is cast to them.  No row estimate."""

    EXT = ".csv"

    def __init__(self, paths: Sequence[str],
                 schema: Optional[T.Schema] = None,
                 input_files: bool = False):
        self._given = schema
        super().__init__(paths, None, input_files)

    @property
    def file_schema(self) -> T.Schema:
        return T.Schema(self.file_fields)

    def _file_schema(self, path: str) -> T.Schema:
        if self._given is not None:
            return self._given
        import pyarrow.csv as pacsv

        return schema_from_arrow(pacsv.read_csv(path).schema)


def read_csv_file(path: str, fields: Sequence[T.Field],
                  columns: Optional[Sequence[str]] = None) -> pa.Table:
    """One CSV file read with ``fields``' types (``columns``: those
    only; None: all).  A TIMESTAMP column is read by pyarrow's inference
    and cast to UTC microseconds, as JAX ``CsvScanExec`` casts its read:
    pyarrow's reader refuses text with no zone offset for a zoned column
    type, and text with one for a naive type."""
    import pyarrow.csv as pacsv

    types = {f.name: T.to_arrow_type(f.dtype) for f in fields
             if not isinstance(f.dtype, T.TimestampType)}
    t = pacsv.read_csv(path, convert_options=pacsv.ConvertOptions(
        column_types=types, include_columns=list(columns)
        if columns is not None else None))
    stamped = {f.name for f in fields if isinstance(f.dtype, T.TimestampType)}
    if stamped & set(t.column_names):
        utc = pa.timestamp("us", tz="UTC")
        t = pa.Table.from_arrays(
            [c.cast(utc) if n in stamped else c
             for n, c in zip(t.column_names, t.columns)],
            names=t.column_names)
    return t


_DIGESTS_COMPUTED = 0


def digests_computed() -> int:
    """How many in-memory tables ``content_digest`` has hashed."""
    return _DIGESTS_COMPUTED


class InMemoryRelation(LogicalPlan):
    """A host Arrow table (``TorchSession.create_dataframe``)."""

    def __init__(self, table: pa.Table):
        self.children = []
        self.table = table
        self._schema = schema_from_arrow(table.schema)
        self._content_digest: Optional[str] = None

    def content_digest(self) -> str:
        """The table's content digest (``eventlog.table_digest``), hashed
        once per relation: Arrow tables are immutable, and the serving
        tier's plan keys would otherwise hash it at every prepare."""
        global _DIGESTS_COMPUTED
        if self._content_digest is None:
            from spark_rapids_tpu_torch.eventlog import table_digest

            _DIGESTS_COMPUTED += 1
            self._content_digest = table_digest(self.table)
        return self._content_digest

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def estimated_rows(self) -> Optional[int]:
        return self.table.num_rows

    def node_desc(self) -> str:
        return f"InMemoryRelation [{self.table.num_rows} rows]"


class RangeRel(LogicalPlan):
    """``id`` from ``start`` (inclusive) to ``end`` (exclusive) by
    ``step`` (``TorchSession.range``)."""

    def __init__(self, start: int, end: int, step: int = 1):
        if step == 0:
            raise ValueError("range step must not be 0")
        self.children = []
        self.start, self.end, self.step = start, end, step
        self._schema = T.Schema([T.Field("id", T.LONG, False)])

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def estimated_rows(self) -> Optional[int]:
        return max(0, -(-(self.end - self.start) // self.step))

    def node_desc(self) -> str:
        return f"Range ({self.start}, {self.end}, step={self.step})"


class Filter(LogicalPlan):
    def __init__(self, condition: Expression, child: LogicalPlan):
        self.children = [child]
        self.condition = condition
        bind_references(condition, child.schema)  # resolve names now

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    def node_desc(self) -> str:
        return f"Filter [{self.condition!r}]"


class Project(LogicalPlan):
    def __init__(self, exprs: Sequence[Expression], child: LogicalPlan):
        self.children = [child]
        self.exprs = list(exprs)
        bound = [bind_references(e, child.schema) for e in self.exprs]
        self._schema = T.Schema([output_field(e, i)
                                 for i, e in enumerate(bound)])

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def node_desc(self) -> str:
        return f"Project [{', '.join(e.name for e in self.exprs)}]"


class Aggregate(LogicalPlan):
    def __init__(self, groups: Sequence[Expression],
                 aggs: Sequence[NamedAgg], child: LogicalPlan):
        self.children = [child]
        self.groups = list(groups)
        self.aggs = list(aggs)
        cs = child.schema
        keys = [output_field(bind_references(g, cs), i)
                for i, g in enumerate(self.groups)]
        outs = [NamedAgg(na.fn.bind(cs), na.out_name).output_field()
                for na in self.aggs]
        self._schema = T.Schema(keys + outs)

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def estimated_rows(self) -> Optional[int]:
        if not self.groups:
            return 1  # a grand aggregate makes one row
        return self.children[0].estimated_rows()

    def node_desc(self) -> str:
        ks = ", ".join(g.name for g in self.groups)
        asr = ", ".join(f"{na.fn.name}->{na.out_name}" for na in self.aggs)
        return f"Aggregate keys=[{ks}] [{asr}]"


class Expand(LogicalPlan):
    """Each input row once per projection list (rollup, cube and
    grouping sets build on it).  A column's type is that of its first
    projection whose expression is not of the NULL type."""

    def __init__(self, projections: Sequence[Sequence[Expression]],
                 names: Sequence[str], child: LogicalPlan):
        if not projections or any(len(p) != len(names)
                                  for p in projections):
            raise ValueError("every Expand projection needs one "
                             "expression per name")
        self.children = [child]
        self.projections = [list(p) for p in projections]
        self.names = list(names)
        bound = [[bind_references(e, child.schema) for e in p]
                 for p in self.projections]
        fields = []
        for i, name in enumerate(self.names):
            dt = next((p[i].dtype for p in bound
                       if not isinstance(p[i].dtype, T.NullType)), T.NULL)
            fields.append(T.Field(name, dt, True))
        self._schema = T.Schema(fields)

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def estimated_rows(self) -> Optional[int]:
        n = self.children[0].estimated_rows()
        return None if n is None else n * len(self.projections)

    def node_desc(self) -> str:
        return (f"Expand [{len(self.projections)} projections, "
                f"{len(self.names)} cols]")


class Generate(LogicalPlan):
    """explode / posexplode (and their ``_outer`` forms) of one array
    expression: the child's columns repeated per element, then ``pos``
    (posexplode) and the element as ``out_name``."""

    def __init__(self, generator, child: LogicalPlan,
                 out_name: str = "col"):
        self.children = [child]
        #: by name, for the exec to bind against its pruned child
        self.unbound = generator
        self.generator = generator.with_children(
            [bind_references(generator.child, child.schema)])
        # an analysis error, not a fallback: no engine explodes a
        # non-array (Spark raises AnalysisException the same way)
        self.generator.check_supported()
        self.out_name = out_name
        fields = list(child.schema.fields)
        if self.generator.pos:
            fields.append(T.Field("pos", T.INT, self.generator.outer))
        fields.append(T.Field(out_name, self.generator.dtype, True))
        self._schema = T.Schema(fields)

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def estimated_rows(self) -> Optional[int]:
        return None

    def node_desc(self) -> str:
        return f"Generate [{self.generator.name}]"


class Join(LogicalPlan):
    """An equi-join; ``condition`` is a residual predicate over the
    joined row (left ++ right columns).  A cross join, or an inner join
    with no keys, pairs every row with every row."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: str,
                 condition: Optional[Expression] = None):
        if join_type not in JOIN_TYPES:
            raise ValueError(f"unknown join type {join_type!r}")
        if len(left_keys) != len(right_keys):
            raise ValueError(f"{len(left_keys)} left keys against "
                             f"{len(right_keys)} right keys")
        self.children = [left, right]
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.condition = condition
        # resolve names now; the key types must compare
        for lk, rk in zip(self.left_keys, self.right_keys):
            lt = bind_references(lk, left.schema).dtype
            rt = bind_references(rk, right.schema).dtype
            if T.common_type(lt, rt) is None \
                    and not T.decimal_beside_integral(lt, rt):
                raise TypeError(f"join keys {lk.name} ({lt}) and "
                                f"{rk.name} ({rt}) do not compare")
        self._schema = joined_schema(left.schema, right.schema, join_type)
        if condition is not None:
            bind_references(condition, T.Schema(
                list(left.schema.fields) + list(right.schema.fields)))

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def estimated_rows(self) -> Optional[int]:
        sides = [c.estimated_rows() for c in self.children]
        return None if None in sides else sum(sides)

    def node_desc(self) -> str:
        ks = ", ".join(f"{l.name}={r.name}" for l, r in
                       zip(self.left_keys, self.right_keys))
        c = f" cond={self.condition!r}" if self.condition is not None else ""
        return f"Join {self.join_type} [{ks}]{c}"


class Window(LogicalPlan):
    """One (partition_by, order_by) group of window expressions, their
    columns appended to the child's (``DataFrame.select`` chains one
    node per group)."""

    def __init__(self, window_exprs, child: LogicalPlan):
        self.children = [child]
        self.window_exprs = list(window_exprs)  # of (expression, name)
        bound = [(we.bind(child.schema), name)
                 for we, name in self.window_exprs]
        self._schema = T.Schema(
            list(child.schema.fields)
            + [T.Field(name, we.dtype, we.nullable) for we, name in bound])

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def node_desc(self) -> str:
        fns = ", ".join(f"{we.fn.describe()}->{n}"
                        for we, n in self.window_exprs)
        return f"Window [{fns}] ({self.window_exprs[0][0].spec.describe()})"


class Sort(LogicalPlan):
    def __init__(self, keys: Sequence[SortKey], child: LogicalPlan):
        self.children = [child]
        self.keys = list(keys)
        for k in self.keys:
            bind_references(k.expr, child.schema)

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    def node_desc(self) -> str:
        ks = ", ".join(f"{k.expr.name}{' DESC' if k.descending else ''}"
                       for k in self.keys)
        return f"Sort [{ks}]"


class Limit(LogicalPlan):
    def __init__(self, n: int, child: LogicalPlan):
        if n < 0:
            raise ValueError(f"limit of {n} rows")
        self.children = [child]
        self.n = n

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    def estimated_rows(self) -> Optional[int]:
        c = self.children[0].estimated_rows()
        return self.n if c is None else min(self.n, c)

    def node_desc(self) -> str:
        return f"Limit {self.n}"


class Union(LogicalPlan):
    """UNION ALL of members with the same column types, by position
    (``DataFrame.union`` widens them first); the output names are the
    first member's."""

    def __init__(self, children: Sequence[LogicalPlan]):
        if not children:
            raise ValueError("a union needs at least one member")
        self.children = list(children)
        first = self.children[0].schema
        for c in self.children[1:]:
            if [f.dtype for f in c.schema.fields] != [
                    f.dtype for f in first.fields]:
                raise TypeError(f"union members {first} and {c.schema} "
                                "differ; DataFrame.union widens them")
        self._schema = T.Schema([
            T.Field(f.name, f.dtype, any(c.schema.fields[i].nullable
                                         for c in self.children))
            for i, f in enumerate(first.fields)])

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def estimated_rows(self) -> Optional[int]:
        rows = [c.estimated_rows() for c in self.children]
        return None if None in rows else sum(rows)


def _close_parts(held: dict) -> None:
    for handles in held.pop("parts", None) or ():
        for h in handles:
            h.close()


class CacheSlot:
    """What ``df.cache()`` shares between the plans that read it: filled
    once, by the first device run that drains the cached subtree, with
    a list per partition of buffer-store handles; every later plan over
    the slot serves those batches and never runs the subtree.  The CPU
    engine keeps its own materialization, ``cpu_table``.  ``publish``
    keeps the first of two racing fills and closes the other's.  The
    store is the process's, shared by every session, so a slot that no
    plan reaches any more closes its batches when it is collected."""

    def __init__(self):
        self.lock = threading.Lock()
        #: "parts": a list per partition of ``SpillableBatch`` handles;
        #: None until a run publishes
        self._held: dict = {"parts": None}
        self.cpu_table: Optional[pa.Table] = None
        weakref.finalize(self, _close_parts, self._held)

    @property
    def parts(self) -> Optional[list]:
        return self._held.get("parts")

    @property
    def filled(self) -> bool:
        return self.parts is not None

    def publish(self, parts: list) -> None:
        with self.lock:
            if self._held.get("parts") is None:
                self._held["parts"], parts = parts, []
        for handles in parts:  # lost the race: drop ours
            for h in handles:
                h.close()

    def clear(self) -> None:
        """Close every stored batch (``DataFrame.unpersist``)."""
        with self.lock:
            parts, self._held["parts"] = self._held.get("parts"), None
            self.cpu_table = None
        for handles in parts or ():
            for h in handles:
                h.close()


class Cached(LogicalPlan):
    """``df.cache()``: its child's rows, materialized once in the slot."""

    def __init__(self, child: LogicalPlan, slot: Optional[CacheSlot] = None):
        self.children = [child]
        self.slot = slot or CacheSlot()

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    def node_desc(self) -> str:
        state = "cached" if self.slot.filled else "materializing"
        return f"Cached [{state}]"


class MapInArrow(LogicalPlan):
    """``fn`` over each batch of the child as a pyarrow Table (``pandas``:
    as a pandas DataFrame, ``mapInPandas``), in the Python worker pool;
    ``schema`` is the declared output both engines cast results to."""

    def __init__(self, fn, schema: T.Schema, child: LogicalPlan,
                 pandas: bool = False):
        self.children = [child]
        self.fn = fn
        self._schema = schema
        self.pandas = pandas

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def estimated_rows(self) -> Optional[int]:
        return None  # a Python function may make rows

    def node_desc(self) -> str:
        kind = "MapInPandas" if self.pandas else "MapInArrow"
        return f"{kind} [{getattr(self.fn, '__name__', 'fn')}]"


class GroupedPandas(LogicalPlan):
    """The grouped pandas functions, ``kind`` one of ``flatmap``
    (``apply_in_pandas``: ``payload`` the user's function), ``agg``
    (``agg_in_pandas``) and ``window`` (``transform_in_pandas``), whose
    ``payload`` is [(output name, fn(Series) -> scalar, input column)].
    Each group must be whole in one partition: the planner hash-exchanges
    the child on ``key_names``."""

    KINDS = ("flatmap", "agg", "window")

    def __init__(self, key_names: Sequence[str], payload, schema: T.Schema,
                 kind: str, child: LogicalPlan):
        if kind not in self.KINDS:
            raise ValueError(f"unknown grouped pandas kind {kind!r}")
        self.children = [child]
        self.key_names = list(key_names)
        self.payload = payload
        self.kind = kind
        self._schema = schema
        for k in self.key_names:
            child.schema.index_of(k)  # raises on an unknown key

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def estimated_rows(self) -> Optional[int]:
        return None if self.kind == "flatmap" \
            else self.children[0].estimated_rows()

    def node_desc(self) -> str:
        return f"GroupedPandas[{self.kind}] keys={self.key_names}"


class CoGroupedPandas(LogicalPlan):
    """``cogroup(...).apply_in_pandas``: ``fn(left group, right group)``
    for every key either side holds, each side hash-exchanged on its
    keys."""

    def __init__(self, left_keys: Sequence[str], right_keys: Sequence[str],
                 fn, schema: T.Schema, left: LogicalPlan,
                 right: LogicalPlan):
        if len(left_keys) != len(right_keys):
            raise ValueError(f"{len(left_keys)} left keys against "
                             f"{len(right_keys)} right keys")
        self.children = [left, right]
        self.left_key_names = list(left_keys)
        self.right_key_names = list(right_keys)
        self.fn = fn
        self._schema = schema
        for k in self.left_key_names:
            left.schema.index_of(k)
        for k in self.right_key_names:
            right.schema.index_of(k)

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def node_desc(self) -> str:
        return (f"CoGroupedPandas [{getattr(self.fn, '__name__', 'fn')}] "
                f"keys={self.left_key_names}")
