"""The port's static pushdown (``io/pushdown.py``) and compiled host
filter (``io/pa_filter.py``) against the JAX package's functions.

A grid of conjuncts (every comparison, both operand orders, IS NULL and
IS NOT NULL, over LONG, DOUBLE, DATE and STRING columns, with literals
at and around the statistics, NaN, +0.0 and -0.0) is built from each
package's classes and bound to the same schema.  ``row_group_may_match``
must give the JAX answer for every row group of a file whose groups
hold NULL-only, NaN-carrying, signed-zero and date statistics; where it
prunes, no row of the group may pass.  ``compile_filter`` must compile
exactly what the JAX one compiles, and the compiled forms must give the
same boolean arrays (NULLs included) over the same table, or both fail.
"""

import datetime

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs import predicates as JP
from spark_rapids_tpu.io import pa_filter as jpa_filter
from spark_rapids_tpu.io import pushdown as jpushdown

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.cpu.engine import cpu_eval
from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs import predicates as P
from spark_rapids_tpu_torch.io import pa_filter, pushdown

GROUP_ROWS = 4
NAN, INF = float("nan"), float("inf")

#: one row group a line: (i LONG, d DOUBLE, dt DATE as epoch days, s)
GROUPS = [
    [(1, 0.5, 100, "a"), (2, 1.5, 101, "b"), (3, 2.5, 102, "c"),
     (4, 3.5, 103, "d")],
    [(None, None, None, None)] * 4,                        # NULL only
    [(5, NAN, 200, "m"), (6, 1.0, None, "n"), (None, 2.0, 201, None),
     (8, NAN, 202, "p")],                                  # NaN inside
    [(-1, -0.0, -5, ""), (0, 0.0, 0, "zz"), (-2, -0.0, -3, "y"),
     (-3, 0.0, -1, "x")],                                  # signed zeros
    [(10, -INF, 18000, "é"), (11, INF, 18001, "日本"), (12, 7.0, None, "q"),
     (13, None, 18002, "r")],
]
PORT_SCHEMA = T.Schema([T.Field("i", T.LONG), T.Field("d", T.DOUBLE),
                        T.Field("dt", T.DATE), T.Field("s", T.STRING)])
JAX_SCHEMA = JT.Schema([JT.Field("i", JT.LONG), JT.Field("d", JT.DOUBLE),
                        JT.Field("dt", JT.DATE), JT.Field("s", JT.STRING)])


def _table() -> pa.Table:
    rows = [r for g in GROUPS for r in g]
    cols = list(zip(*rows))
    return pa.table({
        "i": pa.array(cols[0], pa.int64()),
        "d": pa.array(cols[1], pa.float64()),
        "dt": pa.array(cols[2], pa.int32()).cast(pa.date32()),
        "s": pa.array(cols[3], pa.string()),
    })


@pytest.fixture(scope="module")
def parquet_file(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("pushdown") / "grid.parquet")
    pq.write_table(_table(), p, row_group_size=GROUP_ROWS)
    return p


LITERALS = {
    "i": [(-3, None), (0, None), (2, None), (4, None), (5, None),
          (13, None), (100, None), (2.5, "double")],
    "d": [(0.0, None), (-0.0, None), (1.5, None), (NAN, None), (INF, None),
          (-INF, None), (2.0, None), (3, "long")],
    "dt": [(100, "date"), (103, "date"), (150, "date"), (201, "date"),
           (-5, "date"), (18002, "date")],
    "s": [("", None), ("a", None), ("c", None), ("zz", None), ("é", None)],
}
OPS = ["EqualTo", "LessThan", "LessThanOrEqual", "GreaterThan",
       "GreaterThanOrEqual"]


def _literal(ns, value, kind):
    types = T if ns is B else JT
    dtype = {None: None, "double": types.DOUBLE, "long": types.LONG,
             "date": types.DATE}[kind]
    return ns.Literal.of(value, dtype)


def _grid(ns, preds):
    """Every conjunct of the grid, from one package's classes."""
    out = []
    for name, lits in LITERALS.items():
        c = ns.ColumnReference(name)
        for value, kind in lits:
            lit = _literal(ns, value, kind)
            for op in OPS:
                cls = getattr(preds, op)
                out.append(cls(c, lit))
                out.append(cls(lit, c))
        out.append(preds.IsNull(c))
        out.append(preds.IsNotNull(c))
    return out


def _bound_grids():
    port = [B.bind_references(e, PORT_SCHEMA) for e in _grid(B, P)]
    jax = [JB.bind_references(e, JAX_SCHEMA) for e in _grid(JB, JP)]
    return list(zip(port, jax))


GRID = _bound_grids()


def test_the_grid_covers_every_column_and_op():
    assert len(GRID) == sum(len(v) * len(OPS) * 2 + 2
                            for v in LITERALS.values())


def _nan_passes(e) -> bool:
    """``d > v`` / ``d >= v`` in either operand order: NaN rows pass."""
    name = type(e).__name__
    col_left = isinstance(e.left, B.BoundReference)
    ref = e.left if col_left else e.right
    if not (isinstance(ref, B.BoundReference) and ref.col_name == "d"):
        return False
    return name.startswith("Greater" if col_left else "Less")


def test_row_group_may_match_equals_the_jax_function(parquet_file):
    """Equal to the JAX answer, but for ``>`` / ``>=`` on the floating
    column: NaN rows pass those and Parquet statistics leave NaN out,
    so the port keeps the group where the JAX function prunes it (and
    in the NaN group loses rows that pass)."""
    md = pq.ParquetFile(parquet_file).metadata
    table = _table()
    pruned, lost_by_jax = 0, []
    for g in range(md.num_row_groups):
        rg = md.row_group(g)
        rows = table.slice(g * GROUP_ROWS, GROUP_ROWS)
        for port, jax in GRID:
            got = pushdown.row_group_may_match([port], PORT_SCHEMA, rg)
            want = jpushdown.row_group_may_match([jax], JAX_SCHEMA, rg)
            hits = pc.any(pc.fill_null(cpu_eval(port, rows), False)).as_py()
            # sound: no row of a pruned group passes the conjunct
            assert got or not hits, (g, repr(port))
            if got != want:
                assert got and _nan_passes(port), (g, repr(port))
                if hits:
                    lost_by_jax.append((g, repr(port)))
            pruned += not got
    assert pruned > 50  # the grid prunes, not only keeps
    assert lost_by_jax and {g for g, _ in lost_by_jax} == {2}, lost_by_jax


def test_conjunct_lists_prune_as_the_jax_function(parquet_file):
    """Lists of three conjuncts: the JAX answer, or a kept group where a
    leg is a ``>`` / ``>=`` on the floating column."""
    md = pq.ParquetFile(parquet_file).metadata
    table = _table()
    rng = np.random.default_rng(3)
    for _ in range(200):
        pick = rng.choice(len(GRID), size=3, replace=False)
        port = [GRID[k][0] for k in pick]
        jax = [GRID[k][1] for k in pick]
        for g in range(md.num_row_groups):
            rg = md.row_group(g)
            got = pushdown.row_group_may_match(port, PORT_SCHEMA, rg)
            want = jpushdown.row_group_may_match(jax, JAX_SCHEMA, rg)
            if not got:  # sound: no row passes every leg
                rows = table.slice(g * GROUP_ROWS, GROUP_ROWS)
                every = np.ones(GROUP_ROWS, bool)
                for e in port:
                    every &= np.asarray(pc.fill_null(cpu_eval(e, rows),
                                                     False))
                assert not every.any(), (g, [repr(e) for e in port])
            if got != want:
                assert got and any(_nan_passes(e) for e in port), (
                    g, [repr(e) for e in port])


def test_split_conjuncts_and_the_literal_orientation():
    c, lit = B.ColumnReference("i"), B.Literal.of(3)
    e = P.And(P.And(P.LessThan(c, lit), P.IsNull(c)),
              P.GreaterThan(lit, c))
    legs = pushdown.split_conjuncts(e)
    assert [type(x).__name__ for x in legs] == ["LessThan", "IsNull",
                                                "GreaterThan"]
    assert pushdown._as_col_op_lit(legs[2], PORT_SCHEMA) == (
        "i", P.LessThan, 3)
    assert pushdown._as_col_op_lit(legs[1], PORT_SCHEMA) is None


@pytest.mark.parametrize("v,lo,hi", [(NAN, 0.0, 1.0), (0.5, NAN, 1.0),
                                     (0.5, 0.0, NAN), ("a", 0, 1)])
def test_a_nan_or_a_type_clash_keeps_the_group(v, lo, hi):
    for op in (P.EqualTo, P.LessThan, P.GreaterThan):
        assert pushdown._range_may_match(op, v, lo, hi)


def test_epoch_day_literals_meet_date_statistics():
    day = datetime.date(1970, 1, 1) + datetime.timedelta(days=18000)
    assert pushdown._coerce_like(18000, day) == day
    assert pushdown._coerce_like(18000, 5) == 18000
    assert pushdown._coerce_like(
        18000, datetime.datetime(2020, 1, 1)) == 18000


def _results(fn, table):
    try:
        out = fn(table)
    except (pa.ArrowException, TypeError, ValueError) as e:
        return type(e)
    if isinstance(out, pa.ChunkedArray):
        out = out.combine_chunks()
    if isinstance(out, pa.Scalar):
        out = pa.array([out.as_py()] * table.num_rows, pa.bool_())
    return out


def _composites(pairs):
    """And / Or / Not over pairs of grid entries, in both packages."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(60):
        (p1, j1), (p2, j2) = (pairs[k] for k in rng.choice(len(pairs), 2))
        out.append((P.And(p1, p2), JP.And(j1, j2)))
        out.append((P.Or(p1, p2), JP.Or(j1, j2)))
        out.append((P.Not(p1), JP.Not(j1)))
    return out


def test_compile_filter_equals_the_jax_function():
    table = _table()
    compiled = failed = 0
    for port, jax in GRID + _composites(GRID):
        pf = pa_filter.compile_filter(port)
        jf = jpa_filter.compile_filter(jax)
        assert (pf is None) == (jf is None), repr(port)
        if pf is None:
            continue
        compiled += 1
        got, want = _results(pf, table), _results(jf, table)
        if isinstance(want, type):
            assert got is want, repr(port)
            failed += 1
            continue
        assert got.equals(want), (repr(port), got, want)
    assert compiled > 300 and failed > 0  # date against int fails in both


def test_compiled_float_order_keeps_nan_rows_as_the_device_does():
    """NaN == NaN and NaN above every value: the rows a device Filter
    keeps, the compiled form keeps too."""
    table = pa.table({"d": pa.array([NAN, 1.0, -0.0, 0.0, None, INF])})
    schema = T.Schema([T.Field("d", T.DOUBLE)])
    c = B.ColumnReference("d")
    cases = [
        (P.EqualTo(c, B.Literal.of(NAN)), [True, False, False, False, None,
                                           False]),
        (P.GreaterThan(c, B.Literal.of(INF)), [True, False, False, False,
                                               None, False]),
        (P.LessThan(c, B.Literal.of(NAN)), [False, True, True, True, None,
                                            True]),
        (P.EqualTo(c, B.Literal.of(0.0)), [False, False, True, True, None,
                                           False]),
    ]
    for e, want in cases:
        fn = pa_filter.compile_filter(B.bind_references(e, schema))
        assert fn(table).to_pylist() == want, repr(e)
        assert cpu_eval(B.bind_references(e, schema),
                        table).to_pylist() == want, repr(e)


def test_in_and_unbound_references_do_not_compile():
    c = B.ColumnReference("i")
    assert pa_filter.compile_filter(P.In(c, (1, 2))) is None
    assert pa_filter.compile_filter(P.LessThan(c, B.Literal.of(1))) is None
    bound = B.bind_references(P.In(c, (1, 2)), PORT_SCHEMA)
    assert pa_filter.compile_filter(bound) is None
    assert jpa_filter.compile_filter(JB.bind_references(
        JP.In(JB.ColumnReference("i"), (1, 2)), JAX_SCHEMA)) is None
