"""The port's CPU engine (``cpu/engine.execute_cpu``) against the JAX
package's (``spark_rapids_tpu/cpu/engine.execute_cpu``) on the same
logical plans, each built once through each package's DataFrame API
from one seeded numpy input.

Every logical node of the port (Scan, InMemoryRelation, RangeRel,
Filter, Project, Aggregate, Expand, Join, Window, Sort, Limit, Union)
and every expression family (arithmetic, predicates and conditionals,
math, dates, strings, casts, hashing) runs over inputs with NULLs, NaN,
-0.0, infinities, strings with NUL bytes and UTF-8, and an empty
input.  The expression cases are the module tests' own
(``test_torch_arithmetic``, ``test_torch_predicates``,
``test_torch_math``, ``test_torch_datetime``, ``test_torch_strings``).
Results compare under ``differential.assert_tables_equal``: exact but
floats, which round to 12 significant digits (``_significant``) and 9
decimals (``approx_float``): the two engines may add in other orders.

Where the JAX engine departs from Spark or fails, the port's engine
follows Spark and is held against the port's device path on the CPU
instead (``ROADMAP.md`` section 3): greatest() (the JAX engine computes
least() for it), -0.0 IN (0.0) and NaN <=> NaN (false there, true in
Spark), a cast from the NULL type (ArrowInvalid there) and murmur3 of a
string whose tail holds a byte of 0x80 or more (OverflowError there:
numpy 2 refuses ``np.uint32`` of the sign-extended byte).
The column pruning the port's engine does (a scan reads only the
columns its plan reads; the rest are placeholders that cost nothing)
is checked against the unpruned plan's result.
"""

import types

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu_torch as P
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.cpu.engine import execute_cpu as jexecute
from spark_rapids_tpu.exprs import arithmetic as JA
from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs import datetime as JDT
from spark_rapids_tpu.exprs import math as JM
from spark_rapids_tpu.exprs import predicates as JPR
from spark_rapids_tpu.exprs import strings as JS
from spark_rapids_tpu.exprs import window as JWX
from spark_rapids_tpu.exprs.cast import Cast as JCast
from spark_rapids_tpu.exprs.hashing import Murmur3Hash as JMurmur3Hash
from spark_rapids_tpu.execs.sort import SortKey as JSortKey
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu import session as JSES

import test_torch_arithmetic
import test_torch_datetime
import test_torch_math
import test_torch_predicates
import test_torch_strings
from differential import assert_tables_equal
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.cpu.engine import execute_cpu
from spark_rapids_tpu_torch.execs.sort import SortKey
from spark_rapids_tpu_torch.exprs import arithmetic as A
from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs import datetime as DT
from spark_rapids_tpu_torch.exprs import math as M
from spark_rapids_tpu_torch.exprs import predicates as PR
from spark_rapids_tpu_torch.exprs import strings as S
from spark_rapids_tpu_torch.exprs import window as WX
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.hashing import Murmur3Hash
from spark_rapids_tpu_torch import session as SES
from test_torch_q1 import _significant
import torch_python_fns as PF

JAX = types.SimpleNamespace(
    session=TpuSession, col=JB.ColumnReference, lit=JB.Literal.of,
    A=JA, P=JPR, M=JM, DT=JDT, S=JS, WX=JWX, Cast=JCast, T=JT,
    Murmur3Hash=JMurmur3Hash, SortKey=JSortKey, F=JSES)
PORT = types.SimpleNamespace(
    session=lambda: P.TorchSession(device="cpu"), col=B.col,
    lit=B.Literal.of, A=A, P=PR, M=M, DT=DT, S=S, WX=WX, Cast=Cast, T=T,
    Murmur3Hash=Murmur3Hash, SortKey=SortKey, F=SES)

N = 200
WORDS = ["", "a", "a\0", "a\0b", "ab", "abc", "b", "é", "日本", "  pad  ",
         "12", "-7", " 3.5 ", "x\0y"]
DOUBLES = [-0.0, 0.0, float("nan"), 1.5, -2.0, float("inf"),
           float("-inf"), 3.0, 1e300, -1e-300]


def _mask(rng, n, share=0.12):
    return rng.random(n) < share


def _general(seed=23, n=N) -> pa.Table:
    """Every type, NULLs in every column but one."""
    rng = np.random.default_rng(seed)
    days = rng.integers(-800, 20000, n).astype(np.int32)
    return pa.table({
        "k": pa.array(rng.integers(0, 6, n), pa.int64(), mask=_mask(rng, n)),
        "j": pa.array(rng.integers(0, 4, n).astype(np.int32), pa.int32()),
        "v": pa.array(np.array(DOUBLES)[rng.integers(0, len(DOUBLES), n)],
                      mask=_mask(rng, n)),
        "w": pa.array(np.round(rng.normal(0, 10, n), 3), mask=_mask(rng, n)),
        "s": pa.array(np.array(WORDS, dtype=object)[
            rng.integers(0, len(WORDS), n)], pa.string(), mask=_mask(rng, n)),
        "b": pa.array(rng.random(n) < 0.5, mask=_mask(rng, n)),
        "d": pa.array(days, pa.int32(), mask=_mask(rng, n)).cast(pa.date32()),
        "x": pa.array(rng.integers(-1000, 1000, n), pa.int64(),
                      mask=_mask(rng, n)),
    })


def _both(make, engines=("jax",)):
    """The port's engine on ``make(PORT)``'s plan, and the JAX engine on
    ``make(JAX)``'s (or the port's device path where ``engines`` names
    it)."""
    got = execute_cpu(make(PORT)._plan)
    if "device" in engines:
        return got, make(PORT).collect()
    return got, jexecute(make(JAX)._plan)


def _equal(got, want, ordered=False):
    assert_tables_equal(_significant(got), _significant(want),
                        approx_float=True, ignore_order=not ordered)


# --------------------------------------------------------------------- #
# Expression families: the module tests' cases through both engines
# --------------------------------------------------------------------- #

def _family_tables():
    """family -> (table, the module's case builder, the cases the JAX
    engine computes otherwise than Spark)."""
    rng = np.random.default_rng(17)
    n = 240
    signs = test_torch_arithmetic.SIGNS
    a = np.concatenate([[x for x, _ in signs],
                        rng.integers(-1000, 1000, n - len(signs))])
    b = np.concatenate([[y for _, y in signs],
                        rng.integers(-12, 12, n - len(signs))])
    dbl = np.array(test_torch_arithmetic.DOUBLES)
    arith = pa.table({
        "a": pa.array(a, pa.int64(), mask=_mask(rng, n, 0.08)),
        "b": pa.array(b, pa.int64(), mask=_mask(rng, n, 0.08)),
        "i": pa.array(b.astype(np.int32), pa.int32()),
        "d": pa.array(dbl[rng.integers(0, len(dbl), n)],
                      mask=_mask(rng, n, 0.08)),
        "e": pa.array(dbl[rng.integers(0, len(dbl), n)])})
    x = np.concatenate([rng.normal(0, 50, n - len(test_torch_math.SPECIAL)),
                        test_torch_math.SPECIAL])
    math_t = pa.table({
        "x": pa.array(x, mask=_mask(rng, n, 0.1)),
        "y": pa.array(rng.permutation(x)),
        "u": pa.array(rng.uniform(-1.2, 1.2, n), mask=_mask(rng, n, 0.1)),
        "l": pa.array(np.concatenate([rng.integers(-10_000, 10_000, n - 8),
                                      [15, -15, 25, -25, 5, -5, 150, -150]]),
                      pa.int64(), mask=_mask(rng, n, 0.1))})
    days = rng.integers(-25567, 47482, n).astype(np.int32)
    dates = pa.table({
        "d": pa.array(days, pa.int32(), mask=_mask(rng, n, 0.1)).cast(
            pa.date32()),
        "e": pa.array(rng.permutation(days), pa.int32()).cast(pa.date32()),
        "k": pa.array(rng.integers(-400, 400, n), pa.int64(),
                      mask=_mask(rng, n, 0.1))})
    words = np.array(test_torch_strings.WORDS, dtype=object)
    strings = pa.table({
        "s": pa.array(words[rng.integers(0, len(words), n)], pa.string(),
                      mask=_mask(rng, n, 0.15)),
        "t": pa.array(words[rng.integers(0, len(words), n)], pa.string(),
                      mask=_mask(rng, n, 0.15)),
        "e": pa.array([""] * n, mask=_mask(rng, n, 0.2))})
    return {
        "arithmetic": (arith, test_torch_arithmetic._cases,
                       {"least_greatest"}),
        "predicates": (test_torch_predicates._table(), _predicate_cases,
                       set()),
        "math_exact": (math_t, test_torch_math._exact, set()),
        "math_transcendental": (math_t, test_torch_math._transcendental,
                                set()),
        "dates": (dates, test_torch_datetime._cases, set()),
        "strings": (strings, test_torch_strings._cases, set()),
        "casts": (_general(), _cast_cases, {"from_null"}),
        "hashing": (_general(), _hash_cases, {"murmur3"}),
        "arithmetic_basic": (_general(), _basic_cases, set()),
    }


def _predicate_cases(ns):
    return test_torch_predicates._cases(types.SimpleNamespace(
        col=ns.col, lit=ns.lit, P=ns.P))


def _cast_cases(ns):
    c, C, T_ = ns.col, ns.Cast, ns.T
    k, j, v, w, s, b, d, x = (c(n) for n in "kjvwsbdx")
    return {
        "numeric": [C(k, T_.INT), C(x, T_.DOUBLE), C(j, T_.LONG),
                    C(v, T_.LONG), C(w, T_.INT), C(b, T_.INT),
                    C(x, T_.BOOLEAN)],
        "to_string": [C(k, T_.STRING), C(j, T_.STRING), C(b, T_.STRING),
                      C(d, T_.STRING)],
        "from_string": [C(s, T_.INT), C(s, T_.LONG), C(s, T_.DOUBLE)],
        "from_null": [C(ns.lit(None), T_.LONG), C(ns.lit(None), T_.DOUBLE)],
    }


def _hash_cases(ns):
    c, H = ns.col, ns.Murmur3Hash
    k, j, v, s, b, d = (c(n) for n in "kjvsbd")
    return {"murmur3": [H(k), H(j), H(v), H(s), H(b), H(d),
                        H(k, s, v, d, seed=7)]}


def _basic_cases(ns):
    c, A_, lit = ns.col, ns.A, ns.lit
    k, j, v, w, x = (c(n) for n in "kjvwx")
    return {"add_sub_mul_div": [A_.Add(k, x), A_.Subtract(x, j),
                                A_.Multiply(v, w), A_.Divide(x, k),
                                A_.Divide(v, lit(0.0)), A_.Add(v, w),
                                A_.Multiply(x, lit(3))],
            "logic": [ns.P.And(c("b"), k > lit(2)),
                      ns.P.Or(c("b"), ns.P.IsNull(k)),
                      ns.P.Not(c("b"))]}


FAMILIES = _family_tables()
CASES = [(f, case) for f, (t, cases, _) in FAMILIES.items()
         for case in cases(PORT)]


@pytest.mark.parametrize("family,case", CASES)
def test_expressions_equal_the_jax_engine(family, case):
    table, cases, departs = FAMILIES[family]

    def make(ns):
        exprs = cases(ns)[case]
        return ns.session().create_dataframe(table).select(
            *[e.alias(f"c{i}") for i, e in enumerate(exprs)])

    got, want = _both(make, ("device",) if case in departs else ("jax",))
    assert got.num_rows == table.num_rows
    _equal(got, want, ordered=True)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_expressions_over_an_empty_input(family):
    table, cases, _ = FAMILIES[family]
    empty = table.slice(0, 0)
    for case in cases(PORT):
        exprs = cases(PORT)[case]
        df = PORT.session().create_dataframe(empty).select(
            *[e.alias(f"c{i}") for i, e in enumerate(exprs)])
        got = execute_cpu(df._plan)
        assert got.num_rows == 0
        assert got.schema.names == [f"c{i}" for i in range(len(exprs))]


def test_spark_semantics_where_the_jax_engine_departs():
    """greatest() is the largest value, -0.0 IN (0.0) and NaN <=> NaN
    are true: the port's engine equals its device path."""
    t = pa.table({"v": [-0.0, 0.0, float("nan"), 1.0, None],
                  "w": [1.0, -0.0, float("nan"), None, None]})

    def make(ns):
        v, w = ns.col("v"), ns.col("w")
        return ns.session().create_dataframe(t).select(
            ns.A.Greatest(v, w, ns.lit(-5.0)).alias("g"),
            ns.P.In(v, (0.0,)).alias("z"),
            ns.P.In(v, (float("nan"), 2.0)).alias("n"),
            ns.P.EqualNullSafe(v, w).alias("e"))

    got, want = _both(make, ("device",))
    _equal(got, want, ordered=True)
    assert got["z"].to_pylist() == [True, True, False, False, None]
    assert got["e"].to_pylist() == [False, True, True, False, True]


# --------------------------------------------------------------------- #
# Logical nodes
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cpu_engine")
    t = _general(31, 600)
    paths = []
    for i in range(3):
        p = str(d / f"g-{i}.parquet")
        pq.write_table(t.slice(i * 200, 200), p)
        paths.append(p)
    return paths


def _twins(paths, ext: str) -> list:
    """ORC or CSV copies of the Parquet files ``paths`` (columns k, v,
    s and x), written beside them once."""
    import pyarrow.csv as pacsv
    import pyarrow.orc as paorc

    out = []
    for p in paths:
        twin = p[:-len(".parquet")] + ext
        if not os.path.exists(twin):
            t = pq.read_table(p, columns=["k", "v", "s", "x"])
            if ext == ".orc":
                paorc.write_table(t, twin)
            else:
                pacsv.write_csv(t, twin)
        out.append(twin)
    return out


def _nodes(ns, paths):
    """node -> a DataFrame over that node (and the ones under it)."""
    F, c, lit = ns.F, ns.col, ns.lit
    s = ns.session()
    g = s.read_parquet(*paths)
    mem = s.create_dataframe(_general(5, 40))
    dim = s.create_dataframe(pa.table({
        "k2": pa.array([0, 1, 2, 2, 3, None, 9], pa.int64()),
        "name": ["zero", "one", "two", "deux", "three", "none", "nine"]}))
    kw = g.select(c("k"), c("w"))
    W = ns.WX.Window
    spec = W.partition_by("k").order_by("w")
    aggs = [(F.sum_(c("w")), "sw"), (F.sum_(c("j")), "sj"),
            (F.count(c("s")), "n"), (F.count_star(), "cs"),
            (F.min_(c("v")), "mn"), (F.max_(c("v")), "mx"),
            (F.avg(c("x")), "ax"), (F.min_(c("s")), "ms"),
            (F.max_(c("d")), "md"), (F.first(c("x"), True), "fx"),
            (F.last(c("w"), True), "lw")]
    return {
        "scan": g,
        "in_memory": mem,
        "range": s.range(-7, 40, 3),
        "filter": g.where(ns.P.And(c("w") > lit(0.0),
                                   ns.P.IsNotNull(c("s")))),
        "project": g.select(c("k"), (c("x") * lit(2)).alias("x2"),
                            c("s")),
        "aggregate_grouped": g.group_by(c("k"), c("b")).agg(*aggs),
        "aggregate_double_key": g.group_by(c("v")).agg(
            (F.count_star(), "n")),
        "aggregate_grand": g.agg(*aggs),
        "expand": g.rollup("k", "b").agg((F.sum_(c("x")), "sx"),
                                         (F.count_star(), "n")),
        "join_inner": g.join(dim, left_on=[c("k")], right_on=[c("k2")]),
        "join_left_outer": g.join(dim, left_on=[c("k")],
                                  right_on=[c("k2")], how="left_outer"),
        "join_right_outer": g.join(dim, left_on=[c("k")],
                                   right_on=[c("k2")], how="right_outer"),
        "join_full_outer": g.join(dim, left_on=[c("k")],
                                  right_on=[c("k2")], how="full_outer"),
        "join_semi": g.join(dim, left_on=[c("k")], right_on=[c("k2")],
                            how="left_semi"),
        "join_anti": g.join(dim, left_on=[c("k")], right_on=[c("k2")],
                            how="left_anti"),
        "join_inner_condition": g.join(
            dim, left_on=[c("k")], right_on=[c("k2")],
            condition=c("x") > lit(0)),
        "join_cross": mem.select(c("k"), c("s")).join(
            dim, how="cross"),
        "window": g.select(
            c("k"), c("w"), c("x"),
            ns.WX.rank().over(spec).alias("r"),
            ns.WX.dense_rank().over(spec).alias("dr"),
            ns.WX.row_number().over(W.partition_by("k").order_by(
                "w", "x")).alias("rn"),
            ns.WX.lead(c("x"), 1).over(spec).alias("ld"),
            ns.WX.lag(c("x"), 2, lit(-1)).over(spec).alias("lg"),
            F.sum_(c("x")).over(spec).alias("run"),
            F.count(c("x")).over(W.partition_by("k").order_by("w")
                                 .rows_between(-2, 1)).alias("rc"),
            F.max_(c("x")).over(W.partition_by("k")).alias("pm")),
        "sort": g.order_by(
            ns.SortKey(c("v"), descending=True, nulls_last=True),
            ns.SortKey(c("s")), ns.SortKey(c("x"))),
        "limit": g.order_by(c("x"), c("w"), c("s")).limit(17),
        "union": g.select(c("k"), c("s")).union(
            dim.select(c("k2"), c("name"))),
        "generate": g.select(c("k"), c("s"), F.posexplode_outer(F.array(
            c("k"), c("j")))),
        "cached": g.where(c("x") > lit(0)).cache(),
        "map_in_arrow": kw.map_in_arrow(PF.double_w, kw.schema),
        "grouped_pandas": kw.group_by(c("k")).agg_in_pandas(
            ("m", PF.mean, "w")),
        "cogrouped_pandas": kw.group_by(c("k")).cogroup(dim.group_by(
            c("k2"))).apply_in_pandas(PF.count_sides, COUNT_SIDES),
        "orc_scan": s.read_orc(*_twins(paths, ".orc")).where(
            c("x") > lit(0)),
        "csv_scan": s.read_csv(*_twins(paths, ".csv"), schema=ns.T.Schema(
            [ns.T.Field("k", ns.T.LONG), ns.T.Field("v", ns.T.DOUBLE),
             ns.T.Field("s", ns.T.STRING), ns.T.Field("x", ns.T.LONG)])
        ).select(c("k"), c("s"), c("x")),
    }


#: count_sides' declared output
COUNT_SIDES = pa.schema([("k", pa.int64()), ("nl", pa.int64()),
                         ("nr", pa.int64())])


NODES = ["scan", "in_memory", "range", "filter", "project",
         "aggregate_grouped", "aggregate_double_key", "aggregate_grand",
         "expand", "join_inner", "join_left_outer", "join_right_outer",
         "join_full_outer", "join_semi", "join_anti", "join_inner_condition",
         "join_cross", "window", "sort", "limit", "union", "generate",
         "cached", "map_in_arrow", "grouped_pandas", "cogrouped_pandas",
         "orc_scan", "csv_scan"]
ORDERED = {"sort", "limit"}


@pytest.mark.parametrize("node", NODES)
def test_nodes_equal_the_jax_engine(node, files):
    got, want = _both(lambda ns: _nodes(ns, files)[node])
    assert got.num_rows > 0
    _equal(got, want, ordered=node in ORDERED)


@pytest.mark.parametrize("node", ["filter", "aggregate_grouped", "join_inner",
                                  "window", "union"])
def test_nodes_over_an_empty_input(node, tmp_path):
    p = str(tmp_path / "empty.parquet")
    pq.write_table(_general(3, 10).slice(0, 0), p)
    got, want = _both(lambda ns: _nodes(ns, [p])[node])
    _equal(got, want)


def test_every_logical_node_class_is_covered(files):
    from spark_rapids_tpu_torch.plan import logical as L

    seen = set()

    def walk(p):
        seen.add(type(p))
        for ch in p.children:
            walk(ch)

    for df in _nodes(PORT, files).values():
        walk(df._plan)
    classes = {v for v in vars(L).values() if isinstance(v, type)
               and issubclass(v, L.LogicalPlan) and v is not L.LogicalPlan}
    assert classes <= seen


def test_pruned_columns_give_the_unpruned_result(files):
    """A scan under a projection reads only what it needs; the result is
    the same as over the whole table run first."""
    s = PORT.session()
    g = s.read_parquet(*files)
    df = g.join(g.select(B.col("k").alias("k9"), B.col("s").alias("s9")),
                left_on=[B.col("k")], right_on=[B.col("k9")]).group_by(
        B.col("s9")).agg((SES.sum_(B.col("x")), "sx"))
    whole = P.TorchSession(device="cpu").create_dataframe(
        execute_cpu(g._plan))
    ref = whole.join(whole.select(B.col("k").alias("k9"),
                                  B.col("s").alias("s9")),
                     left_on=[B.col("k")], right_on=[B.col("k9")]).group_by(
        B.col("s9")).agg((SES.sum_(B.col("x")), "sx"))
    _equal(execute_cpu(df._plan), execute_cpu(ref._plan))


def test_the_engine_uses_no_torch_and_no_device_path():
    import ast
    import inspect

    from spark_rapids_tpu_torch.cpu import engine

    tree = ast.parse(inspect.getsource(engine))
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
    assert not any(m == "torch" or m.startswith("torch.") for m in mods)
    for part in ("ops", "execs", "columnar"):
        assert not any(m.startswith(f"spark_rapids_tpu_torch.{part}")
                       for m in mods), part


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
