"""Window expressions: functions, specs and frames.

Counterpart of ``spark_rapids_tpu/exprs/window.py``.  A
``WindowExpression`` is an Expression for planning (type, nullability,
the columns it reads) but never evaluates inline: ``DataFrame.select``
extracts it into a ``Window`` plan node, and ``TpuWindowExec`` computes
every window column of one (partition_by, order_by) group over one sort
of its input (``ops/window.py``).

Query errors (a ranking function or lead/lag without a window ORDER BY)
raise when the expression is built, as Spark's analysis does.  Windows
the device path cannot compute raise NotImplementedError from
``check_supported``; the planner turns that into a will-not-work reason
and runs the Window node on the CPU engine.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.execs.sort import SortKey
from spark_rapids_tpu_torch.exprs.aggregates import (
    AggregateFunction,
    Average,
    Count,
    CountStar,
    Max,
    Min,
    Sum,
)
from spark_rapids_tpu_torch.exprs.base import (
    Expression,
    _column,
    _expr,
    bind_references,
)

#: offset value meaning "unbounded" in a frame bound
UNBOUNDED = None
CURRENT_ROW = 0


@dataclasses.dataclass(frozen=True)
class WindowFrame:
    """ROWS/RANGE frame with offsets relative to the current row
    (negative = preceding, None = unbounded on that side).  Spark's
    default with an ORDER BY: RANGE UNBOUNDED PRECEDING .. CURRENT ROW;
    without one: the whole partition."""

    mode: str = "range"  # "rows" | "range"
    start: Optional[int] = UNBOUNDED
    end: Optional[int] = CURRENT_ROW

    def __post_init__(self):
        if self.mode not in ("rows", "range"):
            raise ValueError(f"window frame mode {self.mode!r}")

    def describe(self) -> str:
        def b(v, side):
            if v is None:
                return f"unbounded {side}"
            if v == 0:
                return "current row"
            return f"{-v} preceding" if v < 0 else f"{v} following"

        return (f"{self.mode} between {b(self.start, 'preceding')} "
                f"and {b(self.end, 'following')}")


WHOLE_PARTITION = WindowFrame("rows", UNBOUNDED, UNBOUNDED)
DEFAULT_ORDERED = WindowFrame("range", UNBOUNDED, CURRENT_ROW)


@dataclasses.dataclass(repr=False)
class WindowSpec:
    partition_by: tuple = ()
    order_by: tuple = ()  # of SortKey
    frame: Optional[WindowFrame] = None  # None = Spark's default

    def resolved_frame(self) -> WindowFrame:
        if self.frame is not None:
            return self.frame
        return DEFAULT_ORDERED if self.order_by else WHOLE_PARTITION

    def describe(self) -> str:
        ps = ", ".join(e.name for e in self.partition_by)
        os_ = ", ".join(f"{k.expr.name}{' DESC' if k.descending else ''}"
                        for k in self.order_by)
        return (f"partition by [{ps}] order by [{os_}] "
                f"{self.resolved_frame().describe()}")


class Window:
    """pyspark-shaped spec builder:
    ``Window.partition_by("k").order_by("ts").rows_between(-3, 0)``."""

    @staticmethod
    def partition_by(*cols) -> "WindowSpecBuilder":
        return WindowSpecBuilder().partition_by(*cols)

    @staticmethod
    def order_by(*keys, desc: bool = False) -> "WindowSpecBuilder":
        return WindowSpecBuilder().order_by(*keys, desc=desc)


class WindowSpecBuilder:
    def __init__(self):
        self._partition: list[Expression] = []
        self._order: list[SortKey] = []
        self._frame: Optional[WindowFrame] = None

    def partition_by(self, *cols) -> "WindowSpecBuilder":
        self._partition.extend(_column(c) for c in cols)
        return self

    def order_by(self, *keys, desc: bool = False) -> "WindowSpecBuilder":
        """Order keys (names, expressions or SortKeys); ``desc`` sorts
        descending with NULLs last, as Spark does."""
        for k in keys:
            self._order.append(k if isinstance(k, SortKey) else SortKey(
                _column(k), descending=desc, nulls_last=desc))
        return self

    def rows_between(self, start: Optional[int],
                     end: Optional[int]) -> "WindowSpecBuilder":
        self._frame = WindowFrame("rows", start, end)
        return self

    def range_between(self, start: Optional[int],
                      end: Optional[int]) -> "WindowSpecBuilder":
        self._frame = WindowFrame("range", start, end)
        return self

    def build(self) -> WindowSpec:
        return WindowSpec(tuple(self._partition), tuple(self._order),
                          self._frame)


def _spec(s: Union[WindowSpec, WindowSpecBuilder]) -> WindowSpec:
    return s.build() if isinstance(s, WindowSpecBuilder) else s


@dataclasses.dataclass(repr=False)
class WindowExpression(Expression):
    """``fn`` over ``spec``; planned into TpuWindowExec, never evaluated
    inline."""

    fn: "WindowFunction"
    spec: WindowSpec

    def __post_init__(self):
        self.fn.check_analysis(self.spec)

    @property
    def dtype(self) -> T.DataType:
        return self.fn.dtype

    @property
    def nullable(self) -> bool:
        return self.fn.nullable

    @property
    def name(self) -> str:
        return f"{self.fn.describe()} over ({self.spec.describe()})"

    def references(self) -> set[str]:
        exprs = (list(self.fn.inputs()) + list(self.spec.partition_by)
                 + [k.expr for k in self.spec.order_by])
        return set().union(*(e.references() for e in exprs))

    def bind(self, schema: T.Schema) -> "WindowExpression":
        spec = WindowSpec(
            tuple(bind_references(e, schema)
                  for e in self.spec.partition_by),
            tuple(SortKey(bind_references(k.expr, schema), k.descending,
                          k.nulls_last) for k in self.spec.order_by),
            self.spec.frame)
        return WindowExpression(self.fn.bind(schema), spec)

    def check_supported(self) -> None:
        self.fn.check_supported(self.spec)


class WindowFunction:
    """Base for the functions a window computes."""

    @property
    def dtype(self) -> T.DataType:
        raise NotImplementedError

    @property
    def nullable(self) -> bool:
        return True

    def inputs(self) -> list[Expression]:
        return []

    def bind(self, schema: T.Schema) -> "WindowFunction":
        return self

    def describe(self) -> str:
        return type(self).__name__.lower()

    def check_analysis(self, spec: WindowSpec) -> None:
        """Query-validity checks: raise ValueError on an invalid query."""

    def check_supported(self, spec: WindowSpec) -> None:
        """Over bound inputs: raise NotImplementedError where the port
        cannot compute this window."""

    def over(self, spec) -> WindowExpression:
        return WindowExpression(self, _spec(spec))


class _RankingFunction(WindowFunction):
    @property
    def dtype(self) -> T.DataType:
        return T.LONG

    @property
    def nullable(self) -> bool:
        return False

    def check_analysis(self, spec: WindowSpec) -> None:
        if not spec.order_by:
            raise ValueError(
                f"{self.describe()}() requires a window ORDER BY")


class RowNumber(_RankingFunction):
    pass


class Rank(_RankingFunction):
    pass


class DenseRank(_RankingFunction):
    def describe(self) -> str:
        return "dense_rank"


@dataclasses.dataclass(repr=False)
class Lead(WindowFunction):
    """lead(expr, offset, default): the value ``offset`` rows after the
    current row within its partition (Lag: before it), else
    ``default`` (NULL when there is none)."""

    child: Expression
    offset: int = 1
    default: Optional[Expression] = None

    _sign = 1

    @property
    def dtype(self) -> T.DataType:
        return self.child.dtype

    def inputs(self) -> list[Expression]:
        return [self.child] + ([self.default] if self.default is not None
                               else [])

    def bind(self, schema: T.Schema) -> "Lead":
        return type(self)(
            bind_references(self.child, schema), self.offset,
            bind_references(self.default, schema)
            if self.default is not None else None)

    def describe(self) -> str:
        return f"{type(self).__name__.lower()}({self.child.name}, " \
               f"{self.offset})"

    def check_analysis(self, spec: WindowSpec) -> None:
        if not spec.order_by:
            raise ValueError(f"{type(self).__name__.lower()}() requires a "
                             "window ORDER BY")

    def check_supported(self, spec: WindowSpec) -> None:
        if self.default is not None and isinstance(self.child.dtype,
                                                   T.StringType):
            raise NotImplementedError(
                "lead/lag with a default over STRING is not ported")

    @property
    def shift(self) -> int:
        return self._sign * self.offset


class Lag(Lead):
    _sign = -1


_NUMERIC_ORDER = (T.ByteType, T.ShortType, T.IntegerType, T.LongType,
                  T.FloatType, T.DoubleType, T.DateType, T.TimestampType)


@dataclasses.dataclass(repr=False)
class WindowAgg(WindowFunction):
    """An aggregate function evaluated over the window frame."""

    agg: AggregateFunction

    _SUPPORTED = (Sum, Count, CountStar, Min, Max, Average)

    @property
    def dtype(self) -> T.DataType:
        return self.agg.dtype

    @property
    def nullable(self) -> bool:
        return self.agg.nullable

    def inputs(self) -> list[Expression]:
        return self.agg.inputs()

    def bind(self, schema: T.Schema) -> "WindowAgg":
        return WindowAgg(self.agg.bind(schema))

    def describe(self) -> str:
        ins = ", ".join(e.name for e in self.agg.inputs())
        return f"{self.agg.name}({ins})"

    def check_supported(self, spec: WindowSpec) -> None:
        if not isinstance(self.agg, self._SUPPORTED):
            raise NotImplementedError(
                f"aggregate {self.agg.name} over a window is not ported")
        if any(isinstance(e.dtype, T.StringType) for e in self.agg.inputs()):
            raise NotImplementedError(
                "window aggregates over STRING are not ported")
        frame = spec.resolved_frame()
        if frame.mode == "range" and (frame.start is not UNBOUNDED or
                                      frame.end not in (CURRENT_ROW,
                                                        UNBOUNDED)):
            # a bounded value RANGE frame bisects one numeric order key
            if len(spec.order_by) != 1 or not isinstance(
                    spec.order_by[0].expr.dtype, _NUMERIC_ORDER):
                raise NotImplementedError(
                    "bounded RANGE frames need exactly one numeric or "
                    "date order key")
        if isinstance(self.agg, (Min, Max)) and (
                frame.start is not UNBOUNDED and frame.end is not UNBOUNDED):
            raise NotImplementedError(
                "min/max over a frame bounded on both sides is not ported")


def row_number() -> RowNumber:
    return RowNumber()


def rank() -> Rank:
    return Rank()


def dense_rank() -> DenseRank:
    return DenseRank()


def lead(e, offset: int = 1, default=None) -> Lead:
    return Lead(_column(e), offset,
                None if default is None else _expr(default))


def lag(e, offset: int = 1, default=None) -> Lag:
    return Lag(_column(e), offset,
               None if default is None else _expr(default))
