"""SQL-text frontend: run SQL strings through the port.

Counterpart of ``spark_rapids_tpu/frontends/sql.py``: the same
tokenizer, recursive-descent parser and lowering onto the DataFrame
surface, over the port's expressions and session.  A parsed query
lowers to a ``DataFrame`` of ``TorchSession``; planning and execution
are then the DataFrame API's, on the session's device (``cuda`` unless
the caller asks for the CPU).  A node the planner's tags keep off the
GPU runs on the CPU engine, and ``explain()`` names it with its
reasons (``plan/planner.py``).

Supported (enough to run the text of the store-channel TPC-DS queries
and the common shapes around them):

- SELECT projections with aliases, ``*``, DISTINCT;
- FROM with comma joins, derived tables and explicit [INNER | LEFT |
  RIGHT | FULL] [SEMI | ANTI] JOIN .. ON; single-table WHERE conjuncts
  are pushed to their table (when every join is inner) and cross-table
  equality conjuncts become equi-join keys, left-deep in FROM order;
  conjuncts common to every branch of an OR are factored out first;
- WITH (CTEs), UNION [ALL], WHERE, GROUP BY (plain, ROLLUP, CUBE,
  GROUPING SETS), HAVING, ORDER BY [ASC | DESC] [NULLS FIRST | LAST]
  (names, aliases, ordinals or aggregate calls), LIMIT;
- aggregates sum / avg / min / max / count / count(*) /
  count(DISTINCT x) over any input expression, and the window functions
  rank, dense_rank, row_number, lead, lag and aggregates ``OVER (...)``;
- expressions: arithmetic, comparisons, AND / OR / NOT, BETWEEN, IN
  (literal lists), [NOT] LIKE, IS [NOT] NULL, CASE (searched and
  simple), CAST(x AS t) (t also tinyint, smallint, float / real,
  timestamp and decimal(p, s)), EXTRACT of a DATE or TIMESTAMP field
  (hour, minute and second of a TIMESTAMP), the scalar functions
  of ``_SCALAR_FNS`` (upper, lower, length, substring, trim, concat,
  coalesce, abs, round, bround, pmod, year, month, day, quarter, nullif,
  if, least, greatest), ``||``, string, number and date literals, and
  ``date '...' +/- interval 'N' day / week / month / year``, folded at
  parse time (on a date column: DateAdd / DateSub / AddMonths);
- subqueries: uncorrelated scalar subqueries (run once by the planner's
  prepass), ``x IN (SELECT ...)`` as a LEFT SEMI join, ``x NOT IN
  (SELECT ...)`` as Spark's null-aware anti join, and [NOT] EXISTS with
  equality correlation as a LEFT SEMI / ANTI join;
- named parameters (``WHERE k = :k``, ``sql(text, params={"k": 5})``):
  each reference binds to a literal at parse time; unbound names raise
  SqlError with their position.

Identifiers resolve case-insensitively against the registered tables'
schemas; qualified references (``alias.col``) check the alias and lower
to the bare column name (TPC column names are unique across tables);
where a self-join makes two frames expose a name, the right frame's
copy is renamed ``__<alias>__<col>``.

Output column names are the JAX frontend's, letter for letter: an
unaliased aggregate is named for its function (``sum``), an unaliased
computed column ``col<i>``.

``SqlSession.prepare(text)`` returns the serving tier's
``PreparedQuery`` (``serving/prepared.py``): each binding of its named
parameters is parsed and lowered once, and its repeats drain the
cached plan.  ``DISABLED_FEATURES`` holds the sweep harness's
kill switches of three grammar fixes (``tools/sweep.py``); empty, as
production leaves it, it changes nothing.  What the JAX frontend
rejects, the port rejects with the same SqlError: ``hour()``,
``minute()``, ``date_format()``, ``unix_timestamp()`` and
``from_unixtime()`` as functions (the last two exist in the DataFrame
API), a ``timestamp '...'`` literal, and an interval of hours.  A
number literal with a fraction parses as a DOUBLE, where Spark makes a
DECIMAL (ROADMAP §3).
"""

from __future__ import annotations

import datetime as _dt
import re
from typing import Optional, Sequence

import calendar
import dataclasses as _dcs
from functools import reduce

import pyarrow as pa

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.execs.sort import SortKey
from spark_rapids_tpu_torch.exprs import aggregates as AG
from spark_rapids_tpu_torch.exprs import arithmetic as A
from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs import cast as C
from spark_rapids_tpu_torch.exprs import datetime as DT
from spark_rapids_tpu_torch.exprs import math as M
from spark_rapids_tpu_torch.exprs import predicates as P
from spark_rapids_tpu_torch.exprs import strings as S
from spark_rapids_tpu_torch.exprs import window as W
from spark_rapids_tpu_torch.exprs.base import expr_key
from spark_rapids_tpu_torch.exprs.subquery import ScalarSubquery
from spark_rapids_tpu_torch.session import TorchSession, count_distinct


def param_names(text: str) -> frozenset:
    """The named parameters (``:name``) a template references."""
    return frozenset(tok[1][1:] for tok in _tokenize(text)
                     if tok[0] == "param")


class SqlError(ValueError):
    """Query outside the supported SQL subset (with position info)."""


#: the grammar-fix kill switches of the sweep's fix probes
#: (``tools/sweep.py``): adding one of {"not_in_subquery",
#: "month_year_interval", "grouping_sets"} restores the rejection at that
#: production as it was before the fix, so the sweep measures which
#: TPC-DS texts each fix advances.  Production code never sets this.
DISABLED_FEATURES: set = set()


# ------------------------------------------------------------------ #
# Tokenizer
# ------------------------------------------------------------------ #

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?
           |\d+(?:[eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<qid>"(?:[^"]|"")*")
  | (?P<param>:[A-Za-z_][A-Za-z_0-9]*)
  | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><>|!=|>=|<=|=|<|>|\|\||[(),.*/%+\-;])
""", re.VERBOSE)


def _tokenize(text: str) -> list[tuple[str, str, int]]:
    out = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise SqlError(f"cannot tokenize at offset {pos}: "
                           f"{text[pos:pos + 20]!r}")
        kind = m.lastgroup
        if kind != "ws":
            out.append((kind, m.group(), pos))
        pos = m.end()
    out.append(("eof", "", len(text)))
    return out


def _param_literal(name: str, value, pos: int) -> B.Literal:
    """One parameter value as a literal: the lowered plan is the one
    inline-literal SQL would give."""
    if isinstance(value, _dt.datetime):
        raise SqlError(
            f"parameter :{name}: timestamp parameters are not "
            "supported yet (bind epoch seconds or a date)")
    if isinstance(value, _dt.date):
        return B.Literal((value - _EPOCH).days, T.DATE)
    try:
        return B.Literal.of(value)
    except TypeError:
        raise SqlError(
            f"parameter :{name} at offset {pos} has unsupported type "
            f"{type(value).__name__} (bind int/float/str/bool/date/"
            f"None)") from None


_AGG_FNS = {"sum": AG.Sum, "min": AG.Min, "max": AG.Max,
            "avg": AG.Average, "mean": AG.Average, "count": AG.Count}


_WINDOW_FNS = {"rank": W.rank, "dense_rank": W.dense_rank,
               "row_number": W.row_number}


class _SubqueryExpr(B.Expression):
    """Parse-time marker for an uncorrelated scalar subquery; the
    lowering pass replaces it with a ScalarSubquery over the lowered
    subplan (run once by the planner's prepass)."""

    def __init__(self, q: dict):
        self.q = q

    @property
    def dtype(self) -> T.DataType:
        raise RuntimeError("unresolved scalar subquery")

    @property
    def name(self) -> str:
        return "scalar_subquery"

    @property
    def children(self):
        return ()


class _ExistsSubquery(B.Expression):
    """Parse-time marker for [NOT] EXISTS (SELECT ... WHERE
    outer.col = inner.col ...); lowered to a LEFT SEMI / LEFT ANTI
    join on the correlated equality conjuncts (Spark's
    RewritePredicateSubquery)."""

    def __init__(self, q: dict, negated: bool):
        self.q = q
        self.negated = negated

    @property
    def dtype(self) -> T.DataType:
        return T.BOOLEAN

    @property
    def name(self) -> str:
        return "exists_subquery"

    @property
    def children(self):
        return ()


class _InSubquery(B.Expression):
    """Parse-time marker for `expr [NOT] IN (SELECT ...)`; IN lowers to
    a LEFT SEMI join (Spark's RewritePredicateSubquery), NOT IN to the
    null-aware anti-join shape: a LEFT ANTI equi-join plus the two
    scalar-subquery guards that reproduce Spark's
    NULL-aware semantics (empty subquery keeps every row; any NULL in
    the subquery, or a NULL probe value against a non-empty subquery,
    keeps none)."""

    def __init__(self, lhs, q: dict, negated: bool = False):
        self.lhs = lhs
        self.q = q
        self.negated = negated

    @property
    def dtype(self) -> T.DataType:
        return T.BOOLEAN

    @property
    def name(self) -> str:
        return "in_subquery"

    @property
    def children(self):
        return (self.lhs,)

def _lit_int(e, what: str) -> int:
    if isinstance(e, B.Literal) and isinstance(e.value, int):
        return e.value
    raise SqlError(f"{what} must be an integer literal")


#: scalar function name -> constructor over positional expr args
_SCALAR_FNS = {
    "upper": lambda x: S.Upper(x),
    "lower": lambda x: S.Lower(x),
    "length": lambda x: S.Length(x),
    "char_length": lambda x: S.Length(x),
    "substring": lambda x, p, n=None: S.Substring(
        x, _lit_int(p, "substring position"),
        None if n is None else _lit_int(n, "substring length")),
    "substr": lambda x, p, n=None: S.Substring(
        x, _lit_int(p, "substring position"),
        None if n is None else _lit_int(n, "substring length")),
    "trim": lambda x: S.StringTrim(x),
    "ltrim": lambda x: S.StringTrimLeft(x),
    "rtrim": lambda x: S.StringTrimRight(x),
    "concat": lambda *xs: S.Concat(*xs),
    "coalesce": lambda *xs: P.Coalesce(*xs),
    "abs": lambda x: A.Abs(x),
    "round": lambda x, n=None: M.Round(
        x, 0 if n is None else _lit_int(n, "round scale")),
    "bround": lambda x, n=None: M.BRound(
        x, 0 if n is None else _lit_int(n, "round scale")),
    "pmod": lambda a, b: A.Pmod(a, b),
    "year": lambda x: DT.Year(x),
    "month": lambda x: DT.Month(x),
    "day": lambda x: DT.DayOfMonth(x),
    "dayofmonth": lambda x: DT.DayOfMonth(x),
    "quarter": lambda x: DT.Quarter(x),
    "nullif": lambda a, b: P.If(P.EqualTo(a, b),
                                B.Literal(None, T.NULL), a),
    "if": lambda c, a, b: P.If(c, a, b),
    "least": lambda *xs: A.Least(*xs),
    "greatest": lambda *xs: A.Greatest(*xs),
}

_EXTRACT_FIELDS = {
    "year": DT.Year, "month": DT.Month, "day": DT.DayOfMonth,
    "quarter": DT.Quarter, "hour": DT.Hour, "minute": DT.Minute,
    "second": DT.Second, "dayofyear": DT.DayOfYear,
}

_CAST_TYPES = {
    "int": T.INT, "integer": T.INT, "bigint": T.LONG, "long": T.LONG,
    "smallint": T.SHORT, "tinyint": T.BYTE, "float": T.FLOAT,
    "real": T.FLOAT, "double": T.DOUBLE, "string": T.STRING,
    "varchar": T.STRING, "char": T.STRING, "boolean": T.BOOLEAN,
    "date": T.DATE, "timestamp": T.TIMESTAMP,
}

_EPOCH = _dt.date(1970, 1, 1)

class _Interval:
    """Parse-time interval value; only valid folded into date ± or as
    a calendar interval for month/year arithmetic."""

    def __init__(self, n: int, unit: str):
        self.n = n
        self.unit = unit.rstrip("s") if unit.endswith("s") else unit


def _fold_literal(e):
    """Constant-fold a literal-only arithmetic expression (the
    `IN (2001, 2001 + 1)` benchmark idiom) to a Literal, else None."""
    if isinstance(e, B.Literal):
        return e
    if isinstance(e, (A.Add, A.Subtract, A.Multiply)):
        l = _fold_literal(e.left)
        r = _fold_literal(e.right)
        if l is not None and r is not None \
                and isinstance(l.value, (int, float)) \
                and not isinstance(l.dtype, T.DateType) \
                and isinstance(r.value, (int, float)):
            op = {A.Add: lambda a, b: a + b,
                  A.Subtract: lambda a, b: a - b,
                  A.Multiply: lambda a, b: a * b}[type(e)]
            return B.Literal.of(op(l.value, r.value))
    return None


def _date_lit(s: str) -> B.Literal:
    d = _dt.date.fromisoformat(s)
    return B.Literal((d - _EPOCH).days, T.DATE)


def _shift_date(lit: B.Literal, iv: _Interval, sign: int) -> B.Literal:
    d = _EPOCH + _dt.timedelta(days=int(lit.value))
    if iv.unit == "day":
        d2 = d + _dt.timedelta(days=sign * iv.n)
    elif iv.unit == "week":
        d2 = d + _dt.timedelta(days=7 * sign * iv.n)
    elif iv.unit in ("month", "year"):
        months = iv.n * (12 if iv.unit == "year" else 1) * sign
        mi = d.year * 12 + (d.month - 1) + months
        y, m = divmod(mi, 12)
        day = min(d.day, calendar.monthrange(y, m + 1)[1])
        d2 = _dt.date(y, m + 1, day)
    else:
        raise SqlError(f"unsupported interval unit {iv.unit!r}")
    return B.Literal((d2 - _EPOCH).days, T.DATE)


# ------------------------------------------------------------------ #
# Parser
# ------------------------------------------------------------------ #


class _Parser:
    def __init__(self, text: str, params: Optional[dict] = None):
        self.toks = _tokenize(text)
        self.i = 0
        #: named-parameter bindings (:name -> python value); every
        #: reference binds to a literal at parse time, unbound names
        #: raise SqlError at their position
        self.params: dict = params or {}
        self.params_used: set = set()

    # -- token helpers -- #

    def peek(self, k: int = 0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def kw(self, k: int = 0) -> str:
        t = self.peek(k)
        return t[1].lower() if t[0] == "id" else ""

    def at(self, *words: str) -> bool:
        return self.kw() in words

    def accept(self, word: str) -> bool:
        if self.kw() == word:
            self.i += 1
            return True
        return False

    def accept_op(self, op: str) -> bool:
        t = self.peek()
        if t[0] == "op" and t[1] == op:
            self.i += 1
            return True
        return False

    def expect(self, word: str) -> None:
        if not self.accept(word):
            t = self.peek()
            raise SqlError(f"expected {word!r}, got {t[1]!r} at {t[2]}")

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            t = self.peek()
            raise SqlError(f"expected {op!r}, got {t[1]!r} at {t[2]}")

    def ident(self) -> str:
        t = self.peek()
        if t[0] == "id":
            self.i += 1
            return t[1].lower()
        if t[0] == "qid":
            self.i += 1
            return t[1][1:-1].replace('""', '"')
        raise SqlError(f"expected identifier, got {t[1]!r} at {t[2]}")

    # -- statement -- #

    def parse_select(self, sub: bool = False) -> dict:
        """One full query: [WITH name AS (...), ...]
        core (UNION [ALL] core)* ORDER BY/LIMIT.  `sub` parses a
        parenthesized subquery (stops at the closing paren instead of
        requiring end-of-input)."""
        ctes: list[tuple] = []
        if self.accept("with"):
            # common table expressions: each name scopes over the rest
            # of the statement (and later CTEs); lowered once per
            # statement and shared by every reference (Spark's
            # CTESubstitution)
            while True:
                cname = self.ident()
                self.expect("as")
                self.expect_op("(")
                if self.kw() not in ("select", "with"):
                    raise SqlError(
                        f"expected SELECT in WITH {cname!r} at "
                        f"{self.peek()[2]}")
                ctes.append((cname, self.parse_select(sub=True)))
                self.expect_op(")")
                if not self.accept_op(","):
                    break
        q = self._select_core()
        unions: list[tuple] = []  # (member q dict, dedup?)
        while self.at("union"):
            self.i += 1
            dedup = not self.accept("all")
            if self.peek()[0] == "op" and self.peek()[1] == "(":
                # parenthesized member: a full subquery (its own
                # ORDER BY/LIMIT/unions allowed inside the parens)
                self.i += 1
                member = self.parse_select(sub=True)
                self.expect_op(")")
            else:
                member = self._select_core()
            unions.append((member, dedup))
        q["unions"] = unions
        q["ctes"] = ctes
        q["order_by"] = self._order_by_clause()
        q["limit"] = None
        if self.accept("limit"):
            t = self.peek()
            if t[0] != "num":
                raise SqlError(f"expected LIMIT count at {t[2]}")
            q["limit"] = int(t[1])
            self.i += 1
        if not sub:
            self.accept_op(";")
            if self.peek()[0] != "eof":
                t = self.peek()
                raise SqlError(f"unexpected trailing {t[1]!r} at {t[2]}")
        return q

    def _order_by_clause(self) -> list[tuple]:
        order_by: list[tuple] = []
        if self.accept("order"):
            self.expect("by")
            while True:
                e = self.expr()
                desc = False
                if self.accept("desc"):
                    desc = True
                else:
                    self.accept("asc")
                nulls_last = desc
                if self.accept("nulls"):
                    if self.accept("last"):
                        nulls_last = True
                    else:
                        self.expect("first")
                        nulls_last = False
                order_by.append((e, desc, nulls_last))
                if not self.accept_op(","):
                    break
        return order_by

    def _select_core(self) -> dict:
        self.expect("select")
        distinct = self.accept("distinct")
        items: list[tuple] = []  # (expr|"*", alias|None)
        while True:
            if self.accept_op("*"):
                items.append(("*", None))
            else:
                e = self.expr()
                alias = None
                if self.accept("as"):
                    alias = self.ident()
                elif (self.peek()[0] in ("id", "qid")
                      and self.kw() not in _CLAUSE_KWS):
                    alias = self.ident()
                items.append((e, alias))
            if not self.accept_op(","):
                break
        self.expect("from")
        tables = [self.table_ref()]
        joins: list[tuple] = []  # ("cross"|how, table_ref, on_expr|None)
        while True:
            if self.accept_op(","):
                joins.append(("cross", self.table_ref(), None))
                continue
            how = None
            if self.at("inner") and self.kw(1) == "join":
                self.i += 2
                how = "inner"
            elif self.at("left", "right", "full"):
                how = {"left": "left_outer", "right": "right_outer",
                       "full": "full_outer"}[self.kw()]
                self.i += 1
                self.accept("outer")
                if self.accept("semi"):
                    how = "left_semi"
                elif self.accept("anti"):
                    how = "left_anti"
                self.expect("join")
            elif self.accept("join"):
                how = "inner"
            if how is None:
                break
            tr = self.table_ref()
            self.expect("on")
            joins.append((how, tr, self.expr()))
        where = self.expr() if self.accept("where") else None
        group_by: list = []
        group_kind = None  # None | "rollup" | "cube" | "sets"
        group_sets: list = []  # for "sets": list of per-set expr lists
        if self.accept("group"):
            self.expect("by")
            if self.at("rollup") or self.at("cube"):
                group_kind = self.kw()
                self.i += 1
                self.expect_op("(")
                while True:
                    group_by.append(self.expr())
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            elif self.at("grouping") and self.kw(1) == "sets" \
                    and "grouping_sets" not in DISABLED_FEATURES:
                # GROUP BY GROUPING SETS ((a, b), (a), (), b): the
                # general form of the rollup/cube sugar — each set is a
                # parenthesized (possibly empty) key list or a bare
                # expression; group_by becomes the first-appearance
                # union of the keys and lowers through the same
                # Expand-based machinery (session.grouping_sets)
                self.i += 2
                group_kind = "sets"
                self.expect_op("(")
                while True:
                    one: list = []
                    if self.accept_op("("):
                        if not self.accept_op(")"):
                            one.append(self.expr())
                            while self.accept_op(","):
                                one.append(self.expr())
                            self.expect_op(")")
                    else:
                        one.append(self.expr())
                    group_sets.append(one)
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                seen: set = set()
                for s in group_sets:
                    for e in s:
                        k = expr_key(e)
                        if k not in seen:
                            seen.add(k)
                            group_by.append(e)
            else:
                while True:
                    group_by.append(self.expr())
                    if not self.accept_op(","):
                        break
        having = self.expr() if self.accept("having") else None
        return {"items": items, "distinct": distinct, "tables": tables,
                "joins": joins, "where": where, "group_by": group_by,
                "group_kind": group_kind, "group_sets": group_sets,
                "having": having,
                "order_by": [], "limit": None, "unions": []}

    def table_ref(self) -> tuple:
        if self.peek()[0] == "op" and self.peek()[1] == "(":
            # derived table: FROM ( SELECT ... ) [AS] alias
            self.i += 1
            if self.kw() != "select":
                raise SqlError(
                    f"expected SELECT in derived table at "
                    f"{self.peek()[2]}")
            subq = self.parse_select(sub=True)
            self.expect_op(")")
            alias = None
            if self.accept("as"):
                alias = self.ident()
            elif (self.peek()[0] in ("id", "qid")
                  and self.kw() not in _TABLE_STOP_KWS):
                alias = self.ident()
            if alias is None:
                raise SqlError("derived table requires an alias")
            return (("__sub__", subq), alias)
        name = self.ident()
        alias = None
        if self.accept("as"):
            alias = self.ident()
        elif (self.peek()[0] in ("id", "qid")
              and self.kw() not in _TABLE_STOP_KWS):
            alias = self.ident()
        return (name, alias or name)

    # -- expressions (precedence climbing) -- #

    def expr(self):
        return self.or_expr()

    def or_expr(self):
        e = self.and_expr()
        while self.accept("or"):
            e = P.Or(e, self.and_expr())
        return e

    def and_expr(self):
        e = self.not_expr()
        while self.accept("and"):
            e = P.And(e, self.not_expr())
        return e

    def not_expr(self):
        if self.at("not") and self.kw(1) == "exists":
            self.i += 2
            return self._exists(negated=True)
        if self.accept("not"):
            return P.Not(self.not_expr())
        if self.accept("exists"):
            return self._exists(negated=False)
        return self.cmp_expr()

    def _exists(self, negated: bool):
        self.expect_op("(")
        if self.kw() != "select":
            raise SqlError(f"expected SELECT after EXISTS at "
                           f"{self.peek()[2]}")
        subq = self.parse_select(sub=True)
        self.expect_op(")")
        return _ExistsSubquery(subq, negated)

    def cmp_expr(self):
        e = self.add_expr()
        negate = False
        if self.at("not") and self.kw(1) in ("between", "in", "like"):
            self.i += 1
            negate = True
        if self.accept("between"):
            lo = self.add_expr()
            self.expect("and")
            hi = self.add_expr()
            out = P.And(P.GreaterThanOrEqual(e, lo),
                        P.LessThanOrEqual(e, hi))
            return P.Not(out) if negate else out
        if self.accept("in"):
            self.expect_op("(")
            if self.kw() == "select":
                subq = self.parse_select(sub=True)
                self.expect_op(")")
                if negate and "not_in_subquery" in DISABLED_FEATURES:
                    raise SqlError(
                        "NOT IN (subquery) is not supported (Spark's "
                        "null-aware anti-join semantics; rewrite with "
                        "NOT EXISTS or an explicit anti join)")
                return _InSubquery(e, subq, negated=negate)
            vals = [self.expr()]
            while self.accept_op(","):
                vals.append(self.expr())
            self.expect_op(")")
            folded = []
            for v in vals:
                fv = _fold_literal(v)
                if fv is None:
                    raise SqlError("IN list must be literals")
                folded.append(fv)
            out = P.In(e, tuple(v.value for v in folded))
            return P.Not(out) if negate else out
        if self.accept("like"):
            pat = self.add_expr()
            if not isinstance(pat, B.Literal):
                raise SqlError("LIKE pattern must be a literal")
            out = S.Like(e, str(pat.value))
            return P.Not(out) if negate else out
        if self.accept("is"):
            neg = self.accept("not")
            self.expect("null")
            return P.IsNotNull(e) if neg else P.IsNull(e)
        _ne = lambda a, b: P.Not(P.EqualTo(a, b))
        for op, ctor in (("=", P.EqualTo), ("<>", _ne),
                         ("!=", _ne), ("<=", P.LessThanOrEqual),
                         (">=", P.GreaterThanOrEqual), ("<", P.LessThan),
                         (">", P.GreaterThan)):
            if self.accept_op(op):
                return ctor(e, self.add_expr())
        return e

    def add_expr(self):
        e = self.mul_expr()
        while True:
            if self.accept_op("+"):
                r = self.mul_expr()
                e = self._plus_minus(e, r, +1)
            elif self.accept_op("-"):
                r = self.mul_expr()
                e = self._plus_minus(e, r, -1)
            elif self.accept_op("||"):
                e = S.Concat(e, self.mul_expr())
            else:
                return e

    @staticmethod
    def _plus_minus(left, right, sign: int):
        if isinstance(right, _Interval):
            if isinstance(left, B.Literal) \
                    and isinstance(left.dtype, T.DateType):
                return _shift_date(left, right, sign)
            # date column ± interval: day/week lower to DateAdd/DateSub
            days = right.n * (7 if right.unit == "week" else 1)
            if right.unit in ("day", "week"):
                ctor = DT.DateAdd if sign > 0 else DT.DateSub
                return ctor(left, B.Literal.of(days))
            if "month_year_interval" in DISABLED_FEATURES:
                raise SqlError("month/year interval arithmetic is only "
                               "supported on date literals")
            # month/year on a date COLUMN (or any non-literal date
            # expression): AddMonths-style calendar shift with
            # end-of-month clamping (exprs/datetime.AddMonths)
            months = right.n * (12 if right.unit == "year" else 1)
            return DT.AddMonths(left, sign * months)
        if isinstance(left, _Interval):
            raise SqlError("interval must be the right operand")
        return (A.Add if sign > 0 else A.Subtract)(left, right)

    def mul_expr(self):
        e = self.unary_expr()
        while True:
            if self.accept_op("*"):
                e = A.Multiply(e, self.unary_expr())
            elif self.accept_op("/"):
                e = A.Divide(e, self.unary_expr())
            elif self.accept_op("%"):
                e = A.Remainder(e, self.unary_expr())
            else:
                return e

    def unary_expr(self):
        if self.accept_op("-"):
            e = self.unary_expr()
            if isinstance(e, B.Literal) and not isinstance(
                    e.dtype, (T.StringType, T.DateType)):
                return B.Literal(-e.value, e.dtype)
            return A.UnaryMinus(e)
        self.accept_op("+")
        return self.primary()

    def primary(self):
        t = self.peek()
        if t[0] == "num":
            self.i += 1
            txt = t[1]
            if "." in txt or "e" in txt or "E" in txt:
                return B.Literal.of(float(txt))
            return B.Literal.of(int(txt))
        if t[0] == "str":
            self.i += 1
            return B.Literal.of(t[1][1:-1].replace("''", "'"))
        if t[0] == "param":
            self.i += 1
            name = t[1][1:]
            if name not in self.params:
                raise SqlError(
                    f"unbound parameter :{name} at offset {t[2]} — "
                    f"pass params={{'{name}': ...}} to sql()/execute()")
            self.params_used.add(name)
            return _param_literal(name, self.params[name], t[2])
        if self.accept_op("("):
            if self.kw() == "select":
                # uncorrelated scalar subquery: (SELECT <agg> FROM ...)
                subq = self.parse_select(sub=True)
                self.expect_op(")")
                return _SubqueryExpr(subq)
            e = self.expr()
            self.expect_op(")")
            return e
        if t[0] not in ("id", "qid"):
            raise SqlError(f"unexpected {t[1]!r} at {t[2]}")

        word = self.kw()
        if word == "date" and self.peek(1)[0] == "str":
            self.i += 1
            s = self.peek()
            self.i += 1
            return _date_lit(s[1][1:-1])
        if word == "interval":
            self.i += 1
            n_t = self.peek()
            if n_t[0] == "str":
                n = int(n_t[1][1:-1])
            elif n_t[0] == "num":
                n = int(n_t[1])
            else:
                raise SqlError(f"expected interval count at {n_t[2]}")
            self.i += 1
            unit = self.ident()
            if unit.rstrip("s") not in ("day", "week", "month", "year"):
                raise SqlError(f"unsupported interval unit {unit!r}")
            return _Interval(n, unit)
        if word == "case":
            return self._case()
        if word == "cast":
            self.i += 1
            self.expect_op("(")
            e = self.expr()
            self.expect("as")
            tname = self.ident()
            if tname == "decimal":
                # DECIMAL(p, s)
                self.expect_op("(")
                p = int(self.peek()[1])
                self.i += 1
                sc = 0
                if self.accept_op(","):
                    sc = int(self.peek()[1])
                    self.i += 1
                self.expect_op(")")
                dtype: T.DataType = T.DecimalType(p, sc)
            else:
                if tname not in _CAST_TYPES:
                    raise SqlError(f"unsupported cast type {tname!r}")
                dtype = _CAST_TYPES[tname]
                if self.accept_op("("):  # varchar(n) etc.
                    while not self.accept_op(")"):
                        self.i += 1
            self.expect_op(")")
            return C.Cast(e, dtype)
        if word == "extract":
            self.i += 1
            self.expect_op("(")
            field = self.ident()
            self.expect("from")
            e = self.expr()
            self.expect_op(")")
            if field not in _EXTRACT_FIELDS:
                raise SqlError(f"unsupported extract field {field!r}")
            return _EXTRACT_FIELDS[field](e)
        if word in ("null",):
            self.i += 1
            return B.Literal(None, T.NULL)
        if word in ("true", "false"):
            self.i += 1
            return B.Literal.of(word == "true")

        # function call or column reference
        if self.peek(1)[0] == "op" and self.peek(1)[1] == "(":
            fname = self.ident()
            self.expect_op("(")
            if fname == "count" and self.accept_op("*"):
                self.expect_op(")")
                star = AG.CountStar()
                if self.at("over"):
                    self.i += 1
                    return star.over(self._window_spec())
                return star
            distinct = self.accept("distinct")
            args: list = []
            if not self.accept_op(")"):
                args.append(self.expr())
                while self.accept_op(","):
                    args.append(self.expr())
                self.expect_op(")")
            if fname in _WINDOW_FNS:
                if args or distinct:
                    raise SqlError(f"{fname}() takes no arguments")
                self.expect("over")
                return _WINDOW_FNS[fname]().over(self._window_spec())
            if fname in ("lead", "lag"):
                if not 1 <= len(args) <= 3 or distinct:
                    raise SqlError(f"{fname}(expr[, offset[, default]])")
                off = 1
                if len(args) >= 2:
                    off = _lit_int(args[1], f"{fname} offset")
                dflt = None
                if len(args) == 3:
                    if not isinstance(args[2], B.Literal):
                        raise SqlError(
                            f"{fname} default must be a literal")
                    dflt = args[2].value
                fn = (W.lead if fname == "lead" else W.lag)(
                    args[0], off, dflt)
                self.expect("over")
                return fn.over(self._window_spec())
            if fname in _AGG_FNS:
                if len(args) != 1:
                    raise SqlError(f"{fname} takes one argument")
                if distinct:
                    if fname != "count":
                        raise SqlError(
                            f"DISTINCT unsupported for {fname}")
                    return count_distinct(args[0])
                agg = _AGG_FNS[fname](args[0])
                if self.at("over"):
                    self.i += 1
                    return agg.over(self._window_spec())
                return agg
            if fname in _SCALAR_FNS:
                try:
                    return _SCALAR_FNS[fname](*args)
                except TypeError as e:
                    raise SqlError(f"bad arguments for {fname}: {e}")
            raise SqlError(f"unknown function {fname!r}")

        name = self.ident()
        if self.accept_op("."):
            col = self.ident()
            return _QualifiedRef(name, col)
        return B.ColumnReference(name)

    def _window_spec(self):
        """OVER ( [PARTITION BY e,..] [ORDER BY e [ASC|DESC],..]
        [ROWS|RANGE BETWEEN <bound> AND <bound>] )"""
        self.expect_op("(")
        b = W.WindowSpecBuilder()
        if self.accept("partition"):
            self.expect("by")
            parts = [self.expr()]
            while self.accept_op(","):
                parts.append(self.expr())
            b.partition_by(*parts)
        if self.at("order"):
            b.order_by(*[SortKey(e, descending=d, nulls_last=n)
                         for e, d, n in self._order_by_clause()])
        if self.at("rows") or self.at("range"):
            mode = self.kw()
            self.i += 1
            self.expect("between")
            lo = self._frame_bound(start=True)
            self.expect("and")
            hi = self._frame_bound(start=False)
            if mode == "rows":
                b.rows_between(lo, hi)
            else:
                b.range_between(lo, hi)
        self.expect_op(")")
        return b

    def _frame_bound(self, start: bool):
        """UNBOUNDED PRECEDING/FOLLOWING | CURRENT ROW | n PRECEDING |
        n FOLLOWING -> the builder's signed-offset convention
        (None = unbounded, 0 = current row).  `start` validates the
        direction: a frame may not start at UNBOUNDED FOLLOWING nor end
        at UNBOUNDED PRECEDING."""
        if self.accept("unbounded"):
            if self.accept("preceding"):
                if not start:
                    raise SqlError(
                        "frame cannot end at UNBOUNDED PRECEDING")
            elif self.accept("following"):
                if start:
                    raise SqlError(
                        "frame cannot start at UNBOUNDED FOLLOWING")
            else:
                raise SqlError("expected PRECEDING/FOLLOWING after "
                               "UNBOUNDED")
            return None
        if self.accept("current"):
            self.expect("row")
            return 0
        t = self.peek()
        if t[0] != "num":
            raise SqlError(f"expected frame bound at {t[2]}")
        n = int(t[1])
        self.i += 1
        if self.accept("preceding"):
            return -n
        self.expect("following")
        return n

    def _case(self):
        self.expect("case")
        operand = None
        if not self.at("when"):
            operand = self.expr()
        branches: list[tuple] = []
        while self.accept("when"):
            cond = self.expr()
            if operand is not None:
                cond = P.EqualTo(operand, cond)
            self.expect("then")
            branches.append((cond, self.expr()))
        default = self.expr() if self.accept("else") \
            else B.Literal(None, T.NULL)
        self.expect("end")
        return P.CaseWhen(tuple(branches), default)


_CLAUSE_KWS = {"from", "where", "group", "having", "order", "limit",
               "as", "on", "join", "inner", "left", "right", "full",
               "and", "or", "not", "asc", "desc", "nulls", "union",
               "when", "then", "else", "end", "between", "in", "like",
               "is", "by"}
_TABLE_STOP_KWS = _CLAUSE_KWS


def _rebuild(e, vals: dict, changed: bool):
    """dataclasses.replace with a with_children fallback for expression
    classes whose custom *args __init__ rejects keyword field names
    (Concat, Coalesce, Least/Greatest)."""
    if not changed:
        return e
    try:
        return _dcs.replace(e, **vals)
    except TypeError:
        kids = [vals.get(f.name, getattr(e, f.name))
                for f in _dcs.fields(e)]
        flat = []
        for k in kids:
            if isinstance(k, (tuple, list)):
                flat.extend(k)
            else:
                flat.append(k)
        return e.with_children(flat)


class _QualifiedRef(B.ColumnReference):
    """alias.col — carries the qualifier for alias checking, lowers to
    a bare name reference (engine resolution is by column name)."""

    def __init__(self, qualifier: str, col: str):
        super().__init__(col)
        self.qualifier = qualifier


# ------------------------------------------------------------------ #
# Lowering onto the DataFrame surface
# ------------------------------------------------------------------ #


def _walk(e):
    """Every sub-node, crossing BOTH Expression children and aggregate
    functions hiding in expression slots (AggregateFunction is not an
    Expression, so `children` alone would miss e.g. the count(*) inside
    a HAVING comparison)."""
    yield e
    if isinstance(e, AG.AggregateFunction):
        if e.child is not None:
            yield from _walk(e.child)
        return
    for c in getattr(e, "children", ()):
        yield from _walk(c)
    if _dcs.is_dataclass(e):
        for f in _dcs.fields(e):
            v = getattr(e, f.name)
            vs = v if isinstance(v, (tuple, list)) else (v,)
            for x in vs:
                if isinstance(x, AG.AggregateFunction):
                    yield from _walk(x)


def _has_agg(e) -> bool:
    return any(isinstance(x, AG.AggregateFunction) for x in _walk(e))


def _refs(e) -> set:
    return {x.col_name for x in _walk(e)
            if isinstance(x, B.ColumnReference)}


def _qualifiers(e) -> set:
    """The table aliases qualifying references under ``e`` (empty for
    fully-unqualified expressions)."""
    return {x.qualifier.lower() for x in _walk(e)
            if isinstance(x, _QualifiedRef)}


def _conjuncts(e) -> list:
    if isinstance(e, P.And):
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _disjuncts(e) -> list:
    if isinstance(e, P.Or):
        return _disjuncts(e.left) + _disjuncts(e.right)
    return [e]


def _factor_common_conjuncts(e):
    """(A ∧ X ∧ ...) ∨ (A ∧ Y ∧ ...) -> A ∧ (X... ∨ Y...): Spark's
    common-conjunct extraction from disjunctive predicates (the rewrite
    that surfaces TPC-H q19's join condition out of its OR blocks)."""
    if not isinstance(e, P.Or):
        return e
    branches = [_conjuncts(b) for b in _disjuncts(e)]
    try:
        common = set.intersection(
            *({expr_key(c) for c in cs} for cs in branches))
    except TypeError:
        # a branch holds an unkeyable marker (e.g. an IN-subquery
        # inside OR): skip factoring; downstream checks report it
        return e
    if not common:
        return e
    kept = []
    seen0: set = set()
    for c in branches[0]:
        k = expr_key(c)
        if k in common and k not in seen0:
            seen0.add(k)
            kept.append(c)
    residues = []
    for cs in branches:
        seen: set = set()
        res = []
        for c in cs:
            k = expr_key(c)
            if k in common and k not in seen:
                seen.add(k)
                continue
            res.append(c)
        residues.append(_and_all(res))
    if any(r is None for r in residues):
        # some branch was ENTIRELY common conjuncts: the residue
        # disjunction is a tautology
        return _and_all(kept)
    return _and_all(kept + [reduce(P.Or, residues)])


def _and_all(es: Sequence):
    out = None
    for e in es:
        out = e if out is None else P.And(out, e)
    return out


class SqlSession:
    """Registers tables and runs SQL text over a ``TorchSession``.

    Registered tables are DataFrames (``register_parquet``,
    ``register_table``); a query's plan is then planned and run as any
    DataFrame's, on the session's device: the card
    ``spark.rapids.tpu.deviceOrdinal`` names unless the caller passes
    ``device`` (``"cpu"``: the CPU)."""

    def __init__(self, conf=None, device=None, tenant: str = "default",
                 priority=None, session=None):
        #: ``session`` given: its tables and queries run there (the
        #: other arguments are its own)
        self.session = session if session is not None else TorchSession(
            conf, device=device, tenant=tenant, priority=priority)
        self._tables: dict[str, object] = {}

    # -- registry -- #

    def register_parquet(self, name: str, *paths: str) -> None:
        self._tables[name.lower()] = self.session.read_parquet(*paths)

    def register_table(self, name: str, df) -> None:
        """Register a DataFrame, or a pyarrow Table."""
        if isinstance(df, pa.Table):
            df = self.session.create_dataframe(df)
        self._tables[name.lower()] = df

    def table(self, name: str):
        try:
            return self._tables[name.lower()]
        except KeyError:
            raise SqlError(f"table {name!r} is not registered "
                           f"(have: {sorted(self._tables)})") from None

    # -- execution -- #

    def sql(self, text: str, params: Optional[dict] = None):
        """Parse and lower one SELECT; returns a DataFrame.

        ``params`` binds named parameters (``WHERE k = :k`` with
        ``params={"k": 5}``) as literals at parse time.  Unbound
        references and unreferenced bindings both raise SqlError (a
        binding nothing reads is a typo)."""
        p = _Parser(text, params=params)
        q = p.parse_select()
        if params:
            unused = sorted(set(params) - p.params_used)
            if unused:
                raise SqlError(
                    "unknown parameter(s) "
                    + ", ".join(f":{n}" for n in unused)
                    + " — not referenced by the query")
        return self._lower(q)

    def prepare(self, text: str):
        """A ``PreparedQuery`` over ``text``, whose ``:name`` parameters
        bind at each ``execute(params=...)``: each binding is parsed and
        lowered once, and its repeats drain the cached plan.  A text
        without parameters is lowered here."""
        from spark_rapids_tpu_torch.serving.prepared import PreparedQuery

        names = param_names(text)
        pq = PreparedQuery(self.session, sql_text=text, sql_session=self,
                           param_names=names)
        if not names:
            pq._resolve(None)  # validate and warm the cache now
        return pq

    def _lower(self, q: dict, ctes: Optional[dict] = None):
        # CTE scope: outer names plus this statement's WITH list, each
        # lowered ONCE (left to right, so later CTEs and the body see
        # earlier ones) and shared by every reference
        scope = dict(ctes) if ctes else {}
        for cname, cq in q.get("ctes") or []:
            scope[cname.lower()] = self._lower(cq, scope)
        if q.get("unions"):
            # left-associative UNION chain; plain UNION dedups (Spark's
            # Distinct over Union), outer ORDER BY/LIMIT bind the chain
            core = dict(q, unions=[], order_by=[], limit=None, ctes=[])
            out = self._lower(core, scope)
            for member, dedup in q["unions"]:
                m = self._lower(member, scope)
                try:
                    # DataFrame.union checks the column counts and
                    # widens the types (WidenSetOperationTypes); its
                    # TypeError is the query's analysis error
                    out = out.union(m)
                except TypeError as e:
                    raise SqlError(str(e)) from None
                if dedup:
                    out = out.group_by(
                        *[B.ColumnReference(f.name)
                          for f in out.schema.fields]).agg()
            return self._order_and_limit(out, q)

        # resolve tables and alias -> column-set mapping (a table name
        # may be a parsed derived-table subquery)
        frames = []  # (alias, df, colnames)
        for name, alias in [q["tables"][0]] + [j[1] for j in q["joins"]]:
            if isinstance(name, tuple) and name[0] == "__sub__":
                df = self._lower(name[1], scope)
            elif isinstance(name, tuple) and name[0] == "__df__":
                df = name[1]  # pre-lowered derived table (EXISTS path)
            elif name in scope:
                df = scope[name]
            else:
                df = self.table(name)
            cols = {f.name.lower() for f in df.schema.fields}
            frames.append((alias.lower(), df, cols))
        self._check_qualifiers(q, frames)
        # qualifiers are kept through pushdown/join-key analysis (a
        # `t1.x = t2.x` self-join equality must not collapse into a
        # pushable tautology when both frames expose `x`); they strip
        # at each point an expression is handed to the engine, and
        # wholesale before projection
        self._resolve_scalar_subqueries(q, scope)

        if q["where"] is not None:
            q["where"] = _and_all([_factor_common_conjuncts(c)
                                   for c in _conjuncts(q["where"])])
        where_conjs = _conjuncts(q["where"]) if q["where"] is not None \
            else []
        # `x IN (SELECT ...)` and [NOT] EXISTS conjuncts become LEFT
        # SEMI / LEFT ANTI joins applied after the FROM joins (Spark's
        # RewritePredicateSubquery)
        in_subs = [cj for cj in where_conjs
                   if isinstance(cj, _InSubquery)]
        exists_subs = [cj for cj in where_conjs
                       if isinstance(cj, _ExistsSubquery)]
        where_conjs = [cj for cj in where_conjs
                       if not isinstance(cj, (_InSubquery,
                                              _ExistsSubquery))]
        for cj in where_conjs:
            if any(isinstance(x, (_InSubquery, _ExistsSubquery))
                   for x in _walk(cj)):
                raise SqlError("IN/EXISTS (subquery) is only supported "
                               "as a top-level AND condition")
        joins = q["joins"]

        # push single-table conjuncts down to their frame (the textbook
        # predicate-pushdown rewrite; lets the scan prefilter see them).
        # ONLY sound when every join is inner: a WHERE conjunct over the
        # null-producing side of an outer join filters post-join NULLs,
        # which a pre-join filter cannot reproduce — with any outer join
        # present, all WHERE conjuncts stay above the joins.
        all_inner = all(j[0] in ("cross", "inner") for j in joins)
        pushed_ids: set = set()
        frames2 = []
        for alias, df, cols in frames:
            mine = []
            if all_inner:
                for cj in where_conjs:
                    r = _refs(cj)
                    quals = _qualifiers(cj)
                    if id(cj) not in pushed_ids and r and r <= cols \
                            and quals <= {alias} \
                            and not _has_agg(cj):
                        mine.append(cj)
                        pushed_ids.add(id(cj))
            pushed = _and_all([self._strip_expr(c) for c in mine])
            if pushed is not None:
                df = df.where(pushed)
            frames2.append((alias, df, cols))
        remaining = [cj for cj in where_conjs
                     if id(cj) not in pushed_ids]

        # left-deep join in FROM order; comma joins consume equality
        # conjuncts from WHERE as join keys.  Self-join collisions
        # (both sides expose a column name) rename the RIGHT frame's
        # colliding columns to __<alias>__<col> before the join;
        # qualified references resolve through `renames` from then on
        # (the planner resolves by name, so duplicates must never
        # reach the joined schema).
        renames: dict = {}
        acc_alias, acc_df, acc_cols = frames2[0]
        acc_cols = set(acc_cols)
        acc_aliases = {acc_alias}
        for (how, _tr, on_expr), (alias, df, cols) in zip(
                joins, frames2[1:]):
            clash = cols & acc_cols
            if clash:
                exprs = []
                for f in df.schema.fields:
                    n = f.name.lower()
                    if n in clash:
                        renames[(alias, n)] = f"__{alias}__{n}"
                        exprs.append(B.Alias(
                            B.ColumnReference(f.name),
                            renames[(alias, n)]))
                    else:
                        exprs.append(B.ColumnReference(f.name))
                df = df.select(*exprs)
                cols = {f.name.lower() for f in df.schema.fields}
            lk, rk, extra = [], [], []
            if how == "cross":
                how = "inner"
                take_ids = set()
                for cj in remaining:
                    sides = self._equi_sides(cj, acc_cols, cols,
                                             acc_aliases, alias,
                                             renames)
                    if sides is not None:
                        lk.append(sides[0])
                        rk.append(sides[1])
                        # identity, NOT equality: self-join conjuncts
                        # (t1.x = t2.x, t1.x = t3.x) compare
                        # structurally equal once qualifiers are
                        # ignored — consuming one must not consume all
                        take_ids.add(id(cj))
                remaining = [c for c in remaining
                             if id(c) not in take_ids]
                if not lk:
                    raise SqlError(
                        f"no join condition links table "
                        f"{alias!r} to the preceding tables "
                        "(cartesian products are not supported)")
            else:
                for cj in _conjuncts(on_expr):
                    sides = self._equi_sides(cj, acc_cols, cols,
                                             acc_aliases, alias,
                                             renames)
                    if sides is not None:
                        lk.append(sides[0])
                        rk.append(sides[1])
                    else:
                        extra.append(self._strip_expr(cj, renames))
                if not lk:
                    raise SqlError("JOIN ON needs at least one "
                                   "equality condition")
            acc_df = acc_df.join(df, left_on=lk, right_on=rk, how=how,
                                 condition=_and_all(extra))
            acc_cols |= cols
            acc_aliases.add(alias)

        post_where = _and_all([self._strip_expr(c, renames)
                               for c in remaining])
        if post_where is not None:
            acc_df = acc_df.where(post_where)

        for isq in in_subs:
            sub = self._lower(isq.q, scope)
            if len(sub.schema.fields) != 1:
                raise SqlError(
                    "IN subquery must select exactly one column")
            rcol = B.ColumnReference(sub.schema.fields[0].name)
            lhs = self._strip_expr(isq.lhs, renames)
            if not isq.negated:
                acc_df = acc_df.join(sub, left_on=[lhs],
                                     right_on=[rcol], how="left_semi")
                continue
            # NOT IN (subquery): Spark's null-aware anti-join semantics
            # out of shapes the engine already executes — a LEFT ANTI
            # equi-join drops the definite matches, then two
            # uncorrelated scalar-subquery guards (evaluated once by
            # the planner prepass) restore the NULL cases: an EMPTY
            # subquery keeps every row (even NULL probes); any NULL in
            # the subquery, or a NULL probe against a non-empty
            # subquery, yields UNKNOWN and keeps none.
            n_rows = sub.agg((AG.CountStar(), "__nin_rows"))
            n_nulls = sub.where(P.IsNull(rcol)).agg(
                (AG.CountStar(), "__nin_nulls"))
            zero = B.Literal(0, T.LONG)
            acc_df = acc_df.join(sub, left_on=[lhs],
                                 right_on=[rcol], how="left_anti")
            acc_df = acc_df.where(P.Or(
                P.EqualTo(ScalarSubquery(n_rows._plan), zero),
                P.And(P.EqualTo(ScalarSubquery(n_nulls._plan), zero),
                      P.IsNotNull(lhs))))

        for ex in exists_subs:
            acc_df = self._lower_exists(acc_df, acc_cols, ex, scope)

        self._strip_qualifiers(q, renames)
        return self._project(q, acc_df)

    def _lower_exists(self, acc_df, acc_cols: set, ex: "_ExistsSubquery",
                      scope: Optional[dict] = None):
        """[NOT] EXISTS with equality correlation -> LEFT SEMI/ANTI
        join: correlated equality conjuncts in the subquery's WHERE
        become join keys; everything else must be inner-only and stays
        the subquery's filter."""
        q = ex.q
        if q.get("unions"):
            raise SqlError("EXISTS over UNION is not supported")
        if q["group_by"] or q["having"] is not None or any(
                it != "*" and _has_agg(it) for it, _a in q["items"]):
            # an ungrouped aggregate subquery always returns one row
            # (EXISTS trivially true) and a grouped one filters on
            # group existence — neither maps to the plain semi join
            # this rewrite produces
            raise SqlError("EXISTS over an aggregating subquery is "
                           "not supported")
        inner_cols: set = set()
        refs = [q["tables"][0]] + [j[1] for j in q["joins"]]
        resolved: list[tuple] = []  # table refs for q2: derived tables
        # pre-lowered ONCE here as ("__df__", df) entries, so the
        # _lower(q2) below reuses them instead of lowering them again
        for name, alias in refs:
            if isinstance(name, tuple) and name[0] == "__sub__":
                df = self._lower(name[1], scope)
                inner_cols |= {f.name.lower() for f in df.schema.fields}
                resolved.append((("__df__", df), alias))
            else:
                src = (scope or {}).get(name) or self.table(name)
                inner_cols |= {f.name.lower()
                               for f in src.schema.fields}
                resolved.append((name, alias))

        def colname(e):
            if isinstance(e, (B.ColumnReference, _QualifiedRef)):
                return e.col_name.lower()
            return None

        outer_keys, inner_keys, keep = [], [], []
        for cj in (_conjuncts(q["where"])
                   if q["where"] is not None else []):
            sides = None
            if isinstance(cj, P.EqualTo):
                an, bn = colname(cj.left), colname(cj.right)
                if an is not None and bn is not None:
                    if an in inner_cols and bn not in inner_cols \
                            and bn in acc_cols:
                        sides = (bn, an)
                    elif bn in inner_cols and an not in inner_cols \
                            and an in acc_cols:
                        sides = (an, bn)
            if sides is not None:
                outer_keys.append(B.ColumnReference(sides[0]))
                inner_keys.append(B.ColumnReference(sides[1]))
                continue
            for x in _walk(cj):
                n = colname(x)
                if n is not None and n not in inner_cols:
                    raise SqlError(
                        f"EXISTS correlation on {n!r} must be a plain "
                        "equality conjunct (non-equality correlated "
                        "predicates are not supported)")
            keep.append(cj)
        if not outer_keys:
            raise SqlError("EXISTS subquery must correlate with the "
                           "outer query through at least one equality")
        q2 = dict(q, where=_and_all(keep),
                  tables=[resolved[0]],
                  joins=[(how, r, on) for (how, _tr, on), r
                         in zip(q["joins"], resolved[1:])],
                  items=[(B.ColumnReference(n), None)
                         for n in dict.fromkeys(
                             k.col_name for k in inner_keys)],
                  distinct=False, order_by=[], limit=None)
        sub = self._lower(q2, scope)
        how = "left_anti" if ex.negated else "left_semi"
        return acc_df.join(sub, left_on=outer_keys,
                           right_on=inner_keys, how=how)

    def _resolve_scalar_subqueries(self, q: dict,
                                   scope: Optional[dict] = None) -> None:
        """Replace scalar-subquery markers with the engine's
        ScalarSubquery over the recursively lowered subplan."""
        def rw(e):
            if isinstance(e, _SubqueryExpr):
                sub = self._lower(e.q, scope)
                if len(sub.schema.fields) != 1:
                    raise SqlError("scalar subquery must select "
                                   "exactly one column")
                return ScalarSubquery(sub._plan)
            if isinstance(e, _InSubquery):
                return _InSubquery(rw(e.lhs), e.q, e.negated)
            if isinstance(e, _ExistsSubquery):
                return e
            if isinstance(e, AG.AggregateFunction):
                if _dcs.is_dataclass(e) and e.child is not None:
                    nc = rw(e.child)
                    return _dcs.replace(e, child=nc) \
                        if nc is not e.child else e
                return e
            if not _dcs.is_dataclass(e):
                return e
            vals = {}
            changed = False
            for f in _dcs.fields(e):
                v = getattr(e, f.name)
                if isinstance(v, (B.Expression, AG.AggregateFunction)):
                    nv = rw(v)
                elif isinstance(v, (tuple, list)):
                    nv = type(v)(
                        rw(x) if isinstance(
                            x, (B.Expression, AG.AggregateFunction))
                        else x for x in v)
                else:
                    nv = v
                vals[f.name] = nv
                changed = changed or nv is not v
            return _rebuild(e, vals, changed)

        q["items"] = [(it if it == "*" else rw(it), al)
                      for it, al in q["items"]]
        for part in ("where", "having"):
            if q[part] is not None:
                q[part] = rw(q[part])
        q["order_by"] = [(rw(e), d, n) for e, d, n in q["order_by"]]
        q["group_by"] = [rw(e) for e in q["group_by"]]
        q["group_sets"] = [[rw(e) for e in s]
                           for s in q.get("group_sets") or []]
        q["joins"] = [(how, tr, rw(on) if on is not None else None)
                      for how, tr, on in q["joins"]]
        # IN (subquery) lowers only from top-level WHERE conjuncts;
        # anywhere else would reach the engine as an unplannable marker
        def no_insub(e, where_word):
            if e is not None and any(isinstance(x, _InSubquery)
                                     for x in _walk(e)):
                raise SqlError("IN (subquery) is only supported as a "
                               f"top-level WHERE condition, not in "
                               f"{where_word}")

        for it, _al in q["items"]:
            if it != "*":
                no_insub(it, "the SELECT list")
        no_insub(q["having"], "HAVING")
        for e in q["group_by"]:
            no_insub(e, "GROUP BY")
        for e, _d, _n in q["order_by"]:
            no_insub(e, "ORDER BY")
        for _how, _tr, on in q["joins"]:
            no_insub(on, "JOIN ON")

    def _order_and_limit(self, out, q: dict):
        """Outer ORDER BY (names or 1-based ordinals) + LIMIT."""
        out_names = [f.name for f in out.schema.fields]
        if q["order_by"]:
            keys = []
            for e, desc, nulls_last in q["order_by"]:
                if isinstance(e, B.Literal) and isinstance(e.value, int) \
                        and 1 <= e.value <= len(out_names):
                    e = B.ColumnReference(out_names[e.value - 1])
                keys.append(SortKey(e, descending=desc,
                                    nulls_last=nulls_last))
            out = out.order_by(*keys)
        if q["limit"] is not None:
            out = out.limit(q["limit"])
        return out

    @staticmethod
    def _side_ok(e, cols: set, aliases: set, renames: dict) -> bool:
        """Every reference in ``e`` resolves within ONE join side:
        unqualified names must be in the side's columns, qualified
        names must ALSO name one of the side's table aliases (the
        self-join disambiguator: after stripping, ``t1.x`` and
        ``t2.x`` read the same, but the qualifier pins the frame).
        ``renames`` maps (alias, col) to its disambiguated output
        name for frames whose columns collided at join time."""
        for x in _walk(e):
            if isinstance(x, _QualifiedRef):
                qual = x.qualifier.lower()
                eff = renames.get((qual, x.col_name.lower()),
                                  x.col_name.lower())
                if qual not in aliases or eff not in cols:
                    return False
            elif isinstance(x, B.ColumnReference):
                if x.col_name.lower() not in cols:
                    return False
        return True

    def _equi_sides(self, cj, left_cols: set, right_cols: set,
                    left_aliases: set, right_alias: str,
                    renames: dict):
        """An equality whose two sides reference disjoint frames is an
        equi-join key pair — either side may be an EXPRESSION over one
        frame's columns (``d_week_seq1 = d_week_seq2 - 53``), the
        engine's join keys accept expressions.  Returns the key pair
        with qualifiers stripped through the rename map (engine
        resolution is by name; the right side's unqualified refs map
        through its own frame's renames)."""
        if not isinstance(cj, P.EqualTo):
            return None
        a, b = cj.left, cj.right
        ra, rb = _refs(a), _refs(b)
        if not ra or not rb or _has_agg(a) or _has_agg(b):
            return None
        right_aliases = {right_alias}

        def right_ok(e):
            for x in _walk(e):
                if isinstance(x, B.ColumnReference):
                    if isinstance(x, _QualifiedRef) \
                            and x.qualifier.lower() != right_alias:
                        return False
                    eff = renames.get((right_alias,
                                       x.col_name.lower()),
                                      x.col_name.lower())
                    if eff not in right_cols:
                        return False
            return True

        if self._side_ok(a, left_cols, left_aliases, renames) \
                and right_ok(b):
            return (self._strip_expr(a, renames),
                    self._strip_expr(b, renames, frame=right_alias))
        if self._side_ok(b, left_cols, left_aliases, renames) \
                and right_ok(a):
            return (self._strip_expr(b, renames),
                    self._strip_expr(a, renames, frame=right_alias))
        return None

    def _strip_expr(self, e, renames: Optional[dict] = None,
                    frame: Optional[str] = None):
        """Lower every alias.col reference in ``e`` to a plain
        ColumnReference (engine resolution is by name; expr_key embeds
        the class name, so a surviving _QualifiedRef would falsely
        split `select t.a ... group by a`).  ``renames`` maps
        (alias, col) to the disambiguated output name minted when a
        self-join collided; ``frame`` maps UNQUALIFIED refs through
        that frame's renames (used for right-side join keys, whose
        refs all resolve within one frame by construction)."""
        renames = renames or {}

        def rw(e):
            if isinstance(e, _QualifiedRef):
                return B.ColumnReference(renames.get(
                    (e.qualifier.lower(), e.col_name.lower()),
                    e.col_name))
            if isinstance(e, _InSubquery):
                return _InSubquery(rw(e.lhs), e.q, e.negated)
            if frame is not None and isinstance(e, B.ColumnReference):
                return B.ColumnReference(renames.get(
                    (frame, e.col_name.lower()), e.col_name))
            if isinstance(e, (_SubqueryExpr, _ExistsSubquery)):
                return e
            if not _dcs.is_dataclass(e):
                return e
            changed = False
            vals = {}
            for f in _dcs.fields(e):
                v = getattr(e, f.name)
                nv = rw_value(v)
                vals[f.name] = nv
                changed = changed or nv is not v
            return _rebuild(e, vals, changed)

        def rw_value(v):
            """A field's value rewritten, into nested tuples too (a
            CaseWhen's branches are (condition, value) pairs)."""
            if isinstance(v, (B.Expression, AG.AggregateFunction)):
                return rw(v)
            if isinstance(v, (tuple, list)):
                out = type(v)(rw_value(x) for x in v)
                return v if all(a is b for a, b in zip(out, v)) else out
            return v

        return rw(e)

    def _strip_qualifiers(self, q: dict,
                          renames: Optional[dict] = None) -> None:
        """Strip alias qualifiers from every clause of ``q`` — called
        AFTER pushdown/join analysis consumed WHERE (the qualifiers
        are the self-join disambiguators there, _side_ok).  ``renames``
        maps collided self-join columns to their disambiguated
        names."""
        def rw(e):
            return self._strip_expr(e, renames)

        def rwa(a):
            if a is None:
                return None
            if isinstance(a, AG.AggregateFunction):
                if a.child is not None:
                    return _dcs.replace(a, child=rw(a.child)) \
                        if _dcs.is_dataclass(a) else a
                return a
            return rw(a)

        q["items"] = [(it if it == "*" else rwa(it), al)
                      for it, al in q["items"]]
        for part in ("where", "having"):
            if q[part] is not None:
                q[part] = rwa(q[part])
        q["group_by"] = [rwa(e) for e in q["group_by"]]
        q["group_sets"] = [[rwa(e) for e in s]
                          for s in q.get("group_sets") or []]
        q["order_by"] = [(rwa(e), d, n) for e, d, n in q["order_by"]]
        q["joins"] = [(how, tr, rwa(on) if on is not None else None)
                      for how, tr, on in q["joins"]]

    def _check_qualifiers(self, q: dict, frames) -> None:
        alias_cols = {a: cols for a, _df, cols in frames}

        def check(e):
            for x in _walk(e):
                if isinstance(x, _QualifiedRef):
                    cols = alias_cols.get(x.qualifier.lower())
                    if cols is None:
                        raise SqlError(
                            f"unknown table alias {x.qualifier!r}")
                    if x.col_name.lower() not in cols:
                        raise SqlError(
                            f"column {x.col_name!r} not in table "
                            f"{x.qualifier!r}")

        for item, _alias in q["items"]:
            if item != "*":
                check(item)
        for part in ("where", "having"):
            if q[part] is not None:
                check(q[part])
        for e in q["group_by"]:
            check(e)
        for e, _d, _n in q["order_by"]:
            check(e)

    def _project(self, q: dict, df):
        items = q["items"]
        group_by = q["group_by"]
        has_aggs = any(item != "*" and _has_agg(item)
                       for item, _ in items) or q["having"] is not None

        plain = not group_by and not has_aggs
        pre_sorted = False
        if plain and q["order_by"]:
            # Spark resolves ORDER BY against the CHILD when a key is
            # not in the SELECT output (order by a dropped column):
            # sort BEFORE projecting in that case (a projection is
            # order-preserving), resolving select aliases to their
            # expressions
            out_names = {a.lower() for _it, a in items if a}
            in_names = {f.name.lower() for f in df.schema.fields}

            def post_resolvable(e) -> bool:
                if isinstance(e, B.Literal) and isinstance(e.value, int):
                    return True
                if isinstance(e, B.ColumnReference):
                    n = e.col_name.lower()
                    if n in out_names:
                        return True
                    return n in in_names and any(
                        it != "*" and (
                            (a is None and isinstance(
                                it, B.ColumnReference)
                             and it.col_name.lower() == n)
                            or a == e.col_name)
                        for it, a in items) or any(
                        it == "*" for it, _a in items)
                return False

            if not all(post_resolvable(e)
                       for e, _d, _n in q["order_by"]):
                if q["distinct"]:
                    raise SqlError("ORDER BY column must appear in "
                                   "SELECT DISTINCT output")
                aliases = {a.lower(): it for it, a in items
                           if a and it != "*"}
                # ordinals resolve against the STAR-EXPANDED output
                # layout (a bare `*` occupies one position per input
                # column)
                positions: list = []
                for it, _a in items:
                    if it == "*":
                        positions.extend(
                            B.ColumnReference(f.name)
                            for f in df.schema.fields)
                    else:
                        positions.append(it)
                keys = []
                for e, desc, nulls_last in q["order_by"]:
                    if isinstance(e, B.Literal) \
                            and isinstance(e.value, int) \
                            and 1 <= e.value <= len(positions):
                        # ordinal keys resolve to the select-list
                        # EXPRESSION when sorting pre-projection
                        e = positions[e.value - 1]
                    elif isinstance(e, B.ColumnReference) \
                            and e.col_name.lower() in aliases \
                            and e.col_name.lower() not in in_names:
                        e = aliases[e.col_name.lower()]
                    keys.append(SortKey(e, descending=desc,
                                        nulls_last=nulls_last))
                df = df.order_by(*keys)
                pre_sorted = True

        if plain:
            out = self._plain_select(items, df, q["distinct"])
        else:
            out = self._grouped_select(items, group_by, df, q)
            if q["order_by"]:
                # ORDER BY over aggregate calls (order by sum(x) desc):
                # Spark resolves these against the aggregate output —
                # rewrite each aggregate sub-expression to its output
                # column when the SELECT list computes it
                q["order_by"] = [
                    (self._resolve_order_agg(e, items), d, n)
                    for e, d, n in q["order_by"]]
            if q["distinct"]:
                # SELECT DISTINCT over an aggregate: dedup the result
                out = out.group_by(
                    *[B.ColumnReference(f.name)
                      for f in out.schema.fields]).agg()

        # ORDER BY: output names, aliases, 1-based ordinals, or (for
        # non-aggregate queries) arbitrary expressions over the input
        out_names = [f.name for f in out.schema.fields]
        if q["order_by"] and not pre_sorted:
            keys = []
            for e, desc, nulls_last in q["order_by"]:
                if isinstance(e, B.Literal) and isinstance(e.value, int) \
                        and 1 <= e.value <= len(out_names):
                    e = B.ColumnReference(out_names[e.value - 1])
                keys.append(SortKey(e, descending=desc,
                                    nulls_last=nulls_last))
            out = out.order_by(*keys)
        if q["limit"] is not None:
            out = out.limit(q["limit"])
        return out

    def _resolve_order_agg(self, e, items):
        """Rewrite aggregate calls inside an ORDER BY key to references
        to the matching SELECT-list aggregate's output column (the
        analyzer's ResolveAggregateFunctions for sort keys).  Unmatched
        aggregates are left alone and fail downstream with the normal
        diagnostic."""
        if not _has_agg(e):
            return e
        agg_names = {}
        for it, al in items:
            if it != "*" and isinstance(it, AG.AggregateFunction):
                agg_names[self._agg_key(it)] = al or it.name

        def rw(x):
            if isinstance(x, AG.AggregateFunction):
                name = agg_names.get(self._agg_key(x))
                return B.ColumnReference(name) if name else x
            if not _dcs.is_dataclass(x):
                return x
            vals = {}
            changed = False
            for f in _dcs.fields(x):
                v = getattr(x, f.name)
                if isinstance(v, (B.Expression, AG.AggregateFunction)):
                    nv = rw(v)
                elif isinstance(v, (tuple, list)):
                    nv = type(v)(
                        rw(y) if isinstance(
                            y, (B.Expression, AG.AggregateFunction))
                        else y for y in v)
                else:
                    nv = v
                vals[f.name] = nv
                changed = changed or nv is not v
            return _rebuild(x, vals, changed)

        return rw(e)

    @staticmethod
    def _agg_key(a) -> tuple:
        return (type(a).__name__,
                expr_key(a.child) if a.child is not None else None)

    def _rewrite_agg_refs(self, hv, aggs, hidden):
        """Replace aggregate calls inside an expression with references to the
        aggregate's output column, adding hidden aggregates for calls
        not already in the SELECT list (dropped by the re-projection)."""
        def ref_for(a):
            k = self._agg_key(a)
            for fn, name in aggs:
                if self._agg_key(fn) == k:
                    return B.ColumnReference(name)
            for fn, name in hidden:
                if self._agg_key(fn) == k:
                    return B.ColumnReference(name)
            name = f"__having{len(hidden)}"
            hidden.append((a, name))
            return B.ColumnReference(name)

        def rw(e):
            if isinstance(e, AG.AggregateFunction):
                return ref_for(e)
            if not _dcs.is_dataclass(e):
                return e
            changed = False
            vals = {}
            for f in _dcs.fields(e):
                v = getattr(e, f.name)
                if isinstance(v, (B.Expression, AG.AggregateFunction)):
                    nv = rw(v)
                elif isinstance(v, tuple):
                    nv = tuple(
                        rw(x) if isinstance(
                            x, (B.Expression, AG.AggregateFunction))
                        else x for x in v)
                else:
                    nv = v
                vals[f.name] = nv
                changed = changed or nv is not v
            return _rebuild(e, vals, changed)

        return rw(hv)

    def _plain_select(self, items, df, distinct):
        star = [f.name for f in df.schema.fields]
        exprs = []
        for item, alias in items:
            if item == "*":
                exprs.extend(B.ColumnReference(n) for n in star)
            elif alias:
                exprs.append(B.Alias(item, alias))
            else:
                exprs.append(item)
        out = df.select(*exprs)
        if distinct:
            out = out.group_by(
                *[B.ColumnReference(f.name)
                  for f in out.schema.fields]).agg()
        return out

    def _grouped_select(self, items, group_by, df, q):
        # SELECT items must be group keys or single aggregate calls
        # (arbitrary input expressions inside the aggregate are fine)
        aliases = {al.lower(): it for it, al in items
                   if al and it != "*"}
        # GROUP BY may name select ALIASES (Spark allows it)
        group_exprs = []
        for g in group_by:
            if isinstance(g, B.ColumnReference) \
                    and g.col_name.lower() in aliases \
                    and g.col_name.lower() not in {
                        f.name.lower() for f in df.schema.fields}:
                g = aliases[g.col_name.lower()]
            group_exprs.append(g)
        gkeys = {expr_key(e) for e in group_exprs}

        aggs = []
        #: per select item: ("agg", out_name) | ("post", rewritten
        #: expr, out_name) | ("key", idx)
        plan_items: list = []
        for item, alias in items:
            if item == "*":
                raise SqlError("SELECT * with GROUP BY is not supported")
            if _has_agg(item):
                if isinstance(item, AG.AggregateFunction):
                    aggs.append((item, alias or item.name))
                    plan_items.append(("agg", alias or item.name))
                else:
                    # arithmetic over aggregate results (sum(a)/sum(b),
                    # 100*sum(case..)/sum(x)): each aggregate call
                    # becomes a (possibly hidden) aggregate output and
                    # the arithmetic projects over those outputs —
                    # Spark's physical split between the aggregate and
                    # its result expressions
                    plan_items.append(("post", item,
                                       alias or item.name))
            else:
                if expr_key(item) not in gkeys:
                    if not _refs(item):
                        # constant select item ('s' sale_type): no
                        # column refs, foldable — projected over the
                        # aggregate output (Spark allows it)
                        plan_items.append(("post", item,
                                           alias or item.name))
                        continue
                    raise SqlError(
                        f"non-aggregate select item {item.name!r} must "
                        "appear in GROUP BY")
                idx = [i for i, g in enumerate(group_exprs)
                       if expr_key(g) == expr_key(item)][0]
                plan_items.append(("key", idx, alias))

        hidden: list = []
        plan_items = [
            ("post", self._rewrite_agg_refs(it[1], aggs, hidden), it[2])
            if it[0] == "post" else it
            for it in plan_items]
        having = q["having"]
        if having is not None and _has_agg(having):
            having = self._rewrite_agg_refs(having, aggs, hidden)
        if q.get("group_kind") == "sets":
            names = []
            for g in group_exprs:
                if not isinstance(g, B.ColumnReference):
                    raise SqlError("GROUPING SETS keys must be "
                                   "plain columns")
                if g.col_name not in names:
                    names.append(g.col_name)
            sets = []
            for s in q.get("group_sets") or []:
                one = []
                for g in s:
                    if not isinstance(g, B.ColumnReference):
                        raise SqlError("GROUPING SETS keys must be "
                                       "plain columns")
                    one.append(g.col_name)
                sets.append(one)
            grouped = df.grouping_sets(sets, names)
        elif q.get("group_kind"):
            names = []
            for g in group_exprs:
                if not isinstance(g, B.ColumnReference):
                    raise SqlError(f"{q['group_kind']} keys must be "
                                   "plain columns")
                names.append(g.col_name)
            grouped = getattr(df, q["group_kind"])(*names)
        else:
            grouped = df.group_by(*group_exprs)
        out = grouped.agg(*aggs, *hidden)
        if having is not None:
            out = out.where(having)

        # aggregate output = [group keys..., aggs...]; re-project when
        # the SELECT order/aliases differ from that layout
        out_fields = [f.name for f in out.schema.fields]
        sel = []
        for it in plan_items:
            if it[0] == "agg":
                sel.append(B.ColumnReference(it[1]))
            elif it[0] == "post":
                sel.append(B.Alias(it[1], it[2]))
            else:
                _k, idx, alias = it
                ref = B.ColumnReference(out_fields[idx])
                sel.append(B.Alias(ref, alias) if alias else ref)
        want = [a or (it.name if it != "*" else "*")
                for it, a in items]
        if want != out_fields or any(al for _it, al in items) \
                or any(it[0] == "post" for it in plan_items):
            out = out.select(*sel)
        return out
