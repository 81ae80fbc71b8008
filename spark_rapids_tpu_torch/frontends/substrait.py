"""Substrait frontend: foreign plans run on the port.

Counterpart of ``spark_rapids_tpu/frontends/substrait.py``.  A plan in
Substrait's JSON form (the protobuf JSON mapping, as a producer such as
Spark, Ibis or DuckDB emits it) is lowered onto ``plan/logical.py``
nodes; tagging, lowering to the GPU and the CPU engine's fallback then
treat it as any DataFrame's plan.

Rels: ``read`` (a ``namedTable`` registered with ``register_table``, or
``localFiles`` of Parquet files; ``baseSchema`` names and a
``projection`` select columns), ``filter``, ``project`` (its output is
the input's fields and then its expressions; ``common.emit`` selects),
``aggregate`` with at most one grouping (measures ``sum``, ``min``,
``max``, ``avg`` and ``count`` of one argument, no measure filter),
``sort``, ``fetch`` (no offset; an absent count is proto3's 0, -1 is
all rows) and ``join`` on an AND of equalities between the two sides
(inner, left, right, outer, left semi and left anti).  Expressions:
field selections, literals (boolean, i8-i64, fp32, fp64, string, date
and typed NULLs), casts, and the standard functions ``gt``, ``gte``,
``lt``, ``lte``, ``equal``, ``add``, ``subtract``, ``multiply``,
``divide``, ``modulus``, ``and``, ``or``, ``not``, ``is_null`` and
``is_not_null``.  Anything else raises ``SubstraitError``; an
expression that translates but that the GPU does not run reaches the
CPU engine through the planner's tags, shown by ``explain()``.

Substrait refers to fields by position and the port's nodes by name:
every rel's output keeps distinct names (a project's new expressions
and a join's right side are renamed where they would repeat one), so
each field reference resolves to the name at its position.  The root's
``names`` rename the output.

``execute_plan`` takes no ``engine`` argument: the port's ``collect``
has none (ROADMAP.md section 3).
"""

from __future__ import annotations

import json
from typing import Optional, Union

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.execs.sort import SortKey
from spark_rapids_tpu_torch.exprs import aggregates as AG
from spark_rapids_tpu_torch.exprs import arithmetic as A
from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs import predicates as P
from spark_rapids_tpu_torch.exprs.base import output_field
from spark_rapids_tpu_torch.plan import logical as L


class SubstraitError(ValueError):
    """A plan outside the supported Substrait subset."""


#: standard function name -> binary constructor
_BINARY_FNS = {
    "gt": P.GreaterThan,
    "gte": P.GreaterThanOrEqual,
    "lt": P.LessThan,
    "lte": P.LessThanOrEqual,
    "equal": P.EqualTo,
    "add": A.Add,
    "subtract": A.Subtract,
    "multiply": A.Multiply,
    "divide": A.Divide,
    "modulus": A.Remainder,
}

_VARIADIC_BOOL = {"and": P.And, "or": P.Or}

_UNARY_FNS = {"not": P.Not, "is_null": P.IsNull, "is_not_null": P.IsNotNull}

_MEASURE_FNS = {
    "sum": AG.Sum,
    "min": AG.Min,
    "max": AG.Max,
    "avg": AG.Average,
    "count": AG.Count,
}

_LITERAL_KEYS = {
    "boolean": T.BOOLEAN,
    "i8": T.BYTE,
    "i16": T.SHORT,
    "i32": T.INT,
    "i64": T.LONG,
    "fp32": T.FLOAT,
    "fp64": T.DOUBLE,
    "string": T.STRING,
    "date": T.DATE,
}

_TYPE_KEYS = {
    "bool": T.BOOLEAN,
    "i8": T.BYTE,
    "i16": T.SHORT,
    "i32": T.INT,
    "i64": T.LONG,
    "fp32": T.FLOAT,
    "fp64": T.DOUBLE,
    "string": T.STRING,
    "date": T.DATE,
    "timestamp": T.TIMESTAMP,
    "timestampTz": T.TIMESTAMP,
}

_JOIN_TYPES = {
    "JOIN_TYPE_INNER": "inner",
    "JOIN_TYPE_LEFT": "left_outer",
    "JOIN_TYPE_RIGHT": "right_outer",
    "JOIN_TYPE_OUTER": "full_outer",
    "JOIN_TYPE_LEFT_SEMI": "left_semi",
    "JOIN_TYPE_LEFT_ANTI": "left_anti",
}


class SubstraitFrontend:
    """Register tables, then run Substrait plans over them on the
    session's device (``TorchSession``'s: a card unless the caller asks
    for the CPU).  Made through the plugin too:
    ``TorchPlugin.get_or_create(conf, device).session("substrait")``."""

    def __init__(self, conf=None, device=None, session=None):
        from spark_rapids_tpu_torch.session import TorchSession

        #: ``session`` given: the plans run there
        self.session = session if session is not None \
            else TorchSession(conf, device=device)
        self._tables: dict[str, L.LogicalPlan] = {}

    def register_table(self, name: str, source) -> None:
        """``source``: a pyarrow Table, or Parquet path(s) (a str or a
        list; directories are read with their Hive partitions)."""
        import pyarrow as pa

        if isinstance(source, pa.Table):
            self._tables[name.lower()] = L.InMemoryRelation(source)
        else:
            paths = [source] if isinstance(source, str) else list(source)
            self._tables[name.lower()] = \
                self.session.read_parquet(*paths)._plan

    def execute_plan(self, plan: Union[str, dict],
                     engine: Optional[str] = None):
        """A plan (JSON text or its dict) -> its result as a pa.Table;
        ``engine`` as ``DataFrame.collect`` takes it (None: the
        session's ``spark.rapids.tpu.sql.enabled``)."""
        return self.dataframe(plan).collect(engine=engine)

    def dataframe(self, plan: Union[str, dict]):
        from spark_rapids_tpu_torch.session import DataFrame

        if isinstance(plan, str):
            plan = json.loads(plan)
        return DataFrame(self._lower_root(plan), self.session)

    def explain(self, plan: Union[str, dict]) -> str:
        return self.dataframe(plan).explain()

    # -- rels -- #

    def _lower_root(self, plan: dict) -> L.LogicalPlan:
        fns = _extension_functions(plan)
        rels = plan.get("relations") or []
        if len(rels) != 1:
            raise SubstraitError(
                f"expected exactly 1 relation, got {len(rels)}")
        root = rels[0].get("root")
        if root is None:
            raise SubstraitError("relation has no root")
        out = self._lower_rel(root["input"], fns)
        names = root.get("names")
        if names:
            if len(names) != len(out.schema.fields):
                raise SubstraitError(
                    f"root names {names} do not match output arity "
                    f"{len(out.schema.fields)}")
            out = L.Project([B.ColumnReference(f.name).alias(n)
                             for f, n in zip(out.schema.fields, names)], out)
        return out

    def _lower_rel(self, rel: dict, fns: dict) -> L.LogicalPlan:
        if len(rel) != 1:
            raise SubstraitError(f"malformed rel object: {list(rel)}")
        (kind, body), = rel.items()
        lower = _RELS.get(kind)
        if lower is None:
            raise SubstraitError(f"rel type {kind!r} not supported")
        out = lower(self, body, fns)
        emit = (body.get("common") or {}).get("emit")
        if emit:
            fields = out.schema.fields
            out = _distinct_names(L.Project(
                [B.ColumnReference(fields[i].name)
                 for i in emit.get("outputMapping", [])], out))
        return out

    def _read(self, body: dict, fns: dict) -> L.LogicalPlan:
        nt = body.get("namedTable")
        if nt is not None:
            name = ".".join(nt.get("names", [])).lower()
            plan = self._tables.get(name)
            if plan is None:
                raise SubstraitError(
                    f"table {name!r} is not registered "
                    f"(have: {sorted(self._tables)})")
        else:
            lf = body.get("localFiles")
            if lf is None:
                raise SubstraitError(
                    "read rel needs namedTable or localFiles")
            paths = []
            for item in lf.get("items", []):
                uri = item.get("uriFile") or item.get("uriPath")
                if not uri:
                    raise SubstraitError("local_files item without uri")
                fmt = [k for k in item if k.endswith((
                    "parquet", "orc", "dwrf", "arrow", "text"))]
                if fmt and "parquet" not in fmt:
                    raise SubstraitError(
                        f"local_files format {fmt[0]!r} not supported "
                        "(parquet only)")
                paths.append(uri.removeprefix("file://"))
            plan = self.session.read_parquet(*paths)._plan
        base_names = (body.get("baseSchema") or {}).get("names")
        if base_names:
            missing = [n for n in base_names if n not in plan.schema.names]
            if missing:
                raise SubstraitError(
                    f"read schema names {missing} not in table")
            plan = L.Project([B.ColumnReference(n) for n in base_names],
                             plan)
        proj = body.get("projection")
        if proj is not None:
            names = plan.schema.names
            plan = L.Project([B.ColumnReference(names[int(r.get("field", 0))])
                              for r in proj.get("select", {})
                              .get("structItems", [])], plan)
        return plan

    def _filter(self, body: dict, fns: dict) -> L.LogicalPlan:
        child = self._lower_rel(body["input"], fns)
        return L.Filter(self._expr(body["condition"], child.schema, fns),
                        child)

    def _project(self, body: dict, fns: dict) -> L.LogicalPlan:
        child = self._lower_rel(body["input"], fns)
        names = list(child.schema.names)
        exprs: list = [B.ColumnReference(n) for n in names]
        for e in body.get("expressions", []):
            x = self._expr(e, child.schema, fns)
            name = output_field(B.bind_references(x, child.schema),
                                len(exprs)).name
            if name in names:
                name = _fresh(name, names)
                x = x.alias(name)
            names.append(name)
            exprs.append(x)
        return L.Project(exprs, child)

    def _aggregate(self, body: dict, fns: dict) -> L.LogicalPlan:
        child = self._lower_rel(body["input"], fns)
        groupings = body.get("groupings", [])
        if len(groupings) > 1:
            raise SubstraitError("grouping sets not supported")
        groups = [self._expr(g, child.schema, fns)
                  for g in (groupings[0].get("groupingExpressions", [])
                            if groupings else [])]
        aggs = []
        for i, m in enumerate(body.get("measures", [])):
            if "filter" in m:
                raise SubstraitError("measure-level FILTER is not supported")
            fn = m.get("measure", {})
            name = fns.get(fn.get("functionReference", 0))
            base = (name or "").split(":", 1)[0]
            ctor = _MEASURE_FNS.get(base)
            if ctor is None:
                raise SubstraitError(
                    f"aggregate function {name!r} not supported")
            args = [self._expr(a["value"], child.schema, fns)
                    for a in fn.get("arguments", [])]
            if len(args) != 1:
                raise SubstraitError(f"{base} expects 1 argument")
            aggs.append(AG.NamedAgg(ctor(args[0]), f"m{i}"))
        return _distinct_names(L.Aggregate(groups, aggs, child))

    def _sort(self, body: dict, fns: dict) -> L.LogicalPlan:
        child = self._lower_rel(body["input"], fns)
        keys = []
        for s in body.get("sorts", []):
            direction = s.get("direction", "SORT_DIRECTION_ASC_NULLS_FIRST")
            keys.append(SortKey(self._expr(s["expr"], child.schema, fns),
                                "DESC" in direction,
                                "NULLS_LAST" in direction))
        return L.Sort(keys, child)

    def _fetch(self, body: dict, fns: dict) -> L.LogicalPlan:
        child = self._lower_rel(body["input"], fns)
        off = int(body.get("offset", body.get("offsetExpr", {})
                           .get("literal", {}).get("i64", 0)))
        if off:
            raise SubstraitError("fetch offset is not supported")
        n = int(body.get("count", body.get("countExpr", {})
                         .get("literal", {}).get("i64", 0)))
        return child if n < 0 else L.Limit(n, child)

    def _join(self, body: dict, fns: dict) -> L.LogicalPlan:
        jt = _JOIN_TYPES.get(body.get("type"))
        if jt is None:
            raise SubstraitError(
                f"join type {body.get('type')!r} not supported")
        left = self._lower_rel(body["left"], fns)
        right = self._lower_rel(body["right"], fns)
        taken = set(left.schema.names)
        if taken & set(right.schema.names):
            # the joined row's names stay distinct: rename the right's
            names = []
            for n in right.schema.names:
                new = _fresh(n, taken) if n in taken else n
                taken.add(new)
                names.append(new)
            right = L.Project([B.ColumnReference(f.name).alias(n)
                               for f, n in zip(right.schema.fields, names)],
                              right)
        joined = T.Schema(list(left.schema.fields)
                          + list(right.schema.fields))
        cond = self._expr(body["expression"], joined, fns, by_name=False)
        lk, rk = _equi_keys(cond, left.schema, right.schema)
        return L.Join(left, right, lk, rk, jt, None)

    # -- expressions -- #

    def _expr(self, e: dict, schema: T.Schema, fns: dict,
              by_name: bool = True) -> B.Expression:
        """A Substrait expression over ``schema`` (distinct names): its
        field references by name, or with ``by_name`` False by
        position (a join's condition, split by ``_equi_keys``)."""
        if "selection" in e:
            sf = e["selection"].get("directReference", {}) \
                .get("structField", {})
            i = int(sf.get("field", 0))
            if i >= len(schema.fields):
                raise SubstraitError(
                    f"field reference {i} out of range "
                    f"({len(schema.fields)} fields)")
            f = schema.fields[i]
            if by_name:
                return B.ColumnReference(f.name)
            return B.BoundReference(i, f.dtype, f.nullable, f.name)
        if "literal" in e:
            return _literal(e["literal"])
        if "scalarFunction" in e:
            sf = e["scalarFunction"]
            name = fns.get(sf.get("functionReference", 0))
            base = (name or "").split(":", 1)[0]
            args = [self._expr(a["value"], schema, fns, by_name)
                    for a in sf.get("arguments", [])]
            if base in _VARIADIC_BOOL:
                if len(args) < 2:
                    raise SubstraitError(f"{base} needs >= 2 args")
                out = args[0]
                for a in args[1:]:
                    out = _VARIADIC_BOOL[base](out, a)
                return out
            if base in _BINARY_FNS:
                if len(args) != 2:
                    raise SubstraitError(f"{base} needs 2 args")
                return _BINARY_FNS[base](args[0], args[1])
            if base in _UNARY_FNS:
                if len(args) != 1:
                    raise SubstraitError(f"{base} needs 1 arg")
                return _UNARY_FNS[base](args[0])
            raise SubstraitError(f"scalar function {name!r} not supported")
        if "cast" in e:
            from spark_rapids_tpu_torch.exprs.cast import Cast

            c = e["cast"]
            return Cast(self._expr(c["input"], schema, fns, by_name),
                        _type_of(c.get("type", {})))
        raise SubstraitError(f"expression {list(e)} not supported")


_RELS = {
    "read": SubstraitFrontend._read,
    "filter": SubstraitFrontend._filter,
    "project": SubstraitFrontend._project,
    "aggregate": SubstraitFrontend._aggregate,
    "sort": SubstraitFrontend._sort,
    "fetch": SubstraitFrontend._fetch,
    "join": SubstraitFrontend._join,
}


def _fresh(name: str, taken) -> str:
    """``name_1``, ``name_2``, ...: the first not in ``taken``."""
    k = 1
    while f"{name}_{k}" in taken:
        k += 1
    return f"{name}_{k}"


def _distinct_names(plan: L.LogicalPlan) -> L.LogicalPlan:
    """``plan``, renamed by position where its output repeats a name."""
    names = plan.schema.names
    if len(set(names)) == len(names):
        return plan
    taken: set = set()
    exprs = []
    for i, f in enumerate(plan.schema.fields):
        new = _fresh(f.name, taken | set(names)) if f.name in taken \
            else f.name
        taken.add(new)
        exprs.append(B.BoundReference(i, f.dtype, f.nullable,
                                      f.name).alias(new))
    return L.Project(exprs, plan)


def _extension_functions(plan: dict) -> dict:
    fns: dict = {}
    for ext in plan.get("extensions", []):
        ef = ext.get("extensionFunction")
        if ef is not None:
            fns[ef.get("functionAnchor", 0)] = ef.get("name", "")
    return fns


def _literal(lit: dict) -> B.Literal:
    for key, dtype in _LITERAL_KEYS.items():
        if key in lit:
            v = lit[key]
            if dtype in (T.BYTE, T.SHORT, T.INT, T.LONG, T.DATE):
                v = int(v)
            elif dtype in (T.FLOAT, T.DOUBLE):
                v = float(v)
            return B.Literal.of(v, dtype)
    if "null" in lit:
        return B.Literal.of(None, _type_of(lit["null"]))
    raise SubstraitError(f"literal {list(lit)} not supported")


def _type_of(t: dict) -> T.DataType:
    for key, dtype in _TYPE_KEYS.items():
        if key in t:
            return dtype
    if "decimal" in t:
        d = t["decimal"]
        return T.DecimalType(int(d.get("precision", 10)),
                             int(d.get("scale", 0)))
    raise SubstraitError(f"type {list(t)} not supported")


def _equi_keys(cond: B.Expression, left: T.Schema, right: T.Schema
               ) -> tuple[list, list]:
    """An AND of equalities between the two sides' columns (bound to
    the joined row) -> (left keys, right keys) by name."""
    n_left = len(left.fields)
    conjs, stack = [], [cond]
    while stack:
        c = stack.pop()
        if isinstance(c, P.And):
            stack += [c.left, c.right]
        else:
            conjs.append(c)
    lk, rk = [], []
    for c in conjs:
        if not isinstance(c, P.EqualTo):
            raise SubstraitError("join expression must be AND of equalities")
        if not all(isinstance(e, B.BoundReference)
                   for e in (c.left, c.right)):
            raise SubstraitError("join keys must be field references")
        a, b = sorted((c.left, c.right), key=lambda e: e.ordinal)
        if not a.ordinal < n_left <= b.ordinal:
            raise SubstraitError(
                "join equality must reference one side each")
        lk.append(B.ColumnReference(left.fields[a.ordinal].name))
        rk.append(B.ColumnReference(right.fields[b.ordinal - n_left].name))
    return lk, rk


def _register() -> None:
    from spark_rapids_tpu_torch.plugin import register_frontend

    register_frontend("substrait", SubstraitFrontend)


_register()
