"""Arrays, structs and maps in the port, against the JAX package.

Every case runs the same DataFrame, built from numpy-seeded Arrow
tables, through the port's ``TorchSession(device="cpu")``, the JAX
package's ``TpuSession`` on its device engine (the JAX CPU backend) and
its CPU engine; results are Arrow tables, compared as multisets of rows
(integers, strings and NULLs exact, floats to 9 decimal places where a
float is computed, else exact).

- The Arrow round trip (``columnar/arrow.py``): a struct with NULL rows
  and NULL fields, a map, an array, a sliced map whose children hold
  absolute offsets, and an array whose NULL slot spans elements; each
  comes back equal, and the port's ``from_arrow_type`` maps every
  nested Arrow type both ways.
- The extractors and constructors (``exprs/complex.py``): getField in
  a projection, a filter and an aggregate, named_struct, getMapValue,
  element_at over maps and arrays.
- Nested columns through the Parquet scan, several batches, a
  shuffled join whose stream side carries an array, and a seeded fuzz
  of extraction pipelines (one parametrised test, a seed a case).
- What falls back: a map with STRING values, an array of structs, an
  alias of a map: the port's ``explain()`` marks the nodes the JAX
  package marks, with its reasons ("on TPU" reads "on the GPU").
"""

import math
import types

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs.complex import CreateNamedStruct as JNamedStruct
from spark_rapids_tpu import session as JS

from differential import gen_table
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import session as PS
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import from_arrow, to_arrow
from spark_rapids_tpu_torch.execs.fallback import CpuFallbackExec
from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs.complex import CreateNamedStruct
from spark_rapids_tpu_torch.plan.planner import collect_exec
from torch_quiet import quiet_ladder  # noqa: F401

CPU = torch.device("cpu")
TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
BCAST = "spark.rapids.tpu.sql.autoBroadcastJoinThresholdBytes"
ADAPTIVE = "spark.rapids.tpu.sql.adaptive.enabled"

#: the two packages' DataFrame functions under one set of names
PORT = types.SimpleNamespace(col=PS.col, lit=B.lit, sum_=PS.sum_,
                             named_struct=CreateNamedStruct)
JAX = types.SimpleNamespace(col=JS.col, lit=JB.lit, sum_=JS.sum_,
                            named_struct=JNamedStruct)


def struct_table(n=500, seed=3):
    rng = np.random.default_rng(seed)
    nulls = rng.random(n) < 0.15
    inner_null = rng.random(n) < 0.2
    x = pa.array(rng.integers(0, 100, n), pa.int64(), mask=inner_null)
    y = pa.array(rng.random(n), pa.float64())
    s = pa.StructArray.from_arrays([x, y], names=["x", "y"],
                                   mask=pa.array(nulls))
    return pa.table({"s": s, "w": pa.array(rng.integers(0, 9, n))})


def map_table(n=400, seed=5):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        if rng.random() < 0.12:
            rows.append(None)
        else:
            k = rng.integers(0, 6, rng.integers(0, 4))
            rows.append([(int(kk), float(rng.random()))
                         for kk in dict.fromkeys(k.tolist())])
    return pa.table({"m": pa.array(rows, pa.map_(pa.int64(), pa.float64())),
                     "v": pa.array(np.arange(n))})


def list_table(n=300, seed=9):
    rng = np.random.default_rng(seed)
    rows = [None if rng.random() < 0.1 else
            [None if rng.random() < 0.1 else int(x)
             for x in rng.integers(0, 50, rng.integers(0, 5))]
            for _ in range(n)]
    return pa.table({"a": pa.array(rows, pa.list_(pa.int64())),
                     "k": pa.array(rng.integers(0, 7, n))})


def spanning_null_table():
    """An array whose NULL slot spans two elements (Arrow allows it)."""
    a = pa.ListArray.from_arrays(pa.array([0, 2, 4, 4, 6], pa.int32()),
                                 pa.array([1, None, 3, 4, 5, 6], pa.int64()),
                                 mask=pa.array([False, True, False, False]))
    return pa.table({"a": a, "k": pa.array([1, 2, 3, 4])})


def sliced_map_table():
    m = pa.array([[(1, 1.0)], [(2, 2.0), (3, 3.0)], [(4, 4.0)], [(5, 5.0)]],
                 pa.map_(pa.int64(), pa.float64()))
    return pa.table({"m": m.slice(2, 2)})


def canon(v, approx_float: bool = False):
    """A value as a sortable key: NULL, NaN, floats (exact with the sign
    of a zero, or to 9 places with ``approx_float``), and arrays,
    structs and maps element by element (a map's entries, pairs, in
    their order)."""
    if v is None:
        return (0,)
    if isinstance(v, float):
        if math.isnan(v):
            return (1,)
        if approx_float:
            return (2, round(v, 9), 0.0)
        return (2, v, math.copysign(1.0, v))
    if isinstance(v, dict):
        return (3, tuple((k, canon(x, approx_float)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return (4, tuple(canon(x, approx_float) for x in v))
    return (5, type(v).__name__, v)


def assert_tables_equal(got: pa.Table, want: pa.Table,
                        approx_float: bool = False,
                        ignore_order: bool = True) -> None:
    """Equal names and equal rows, as multisets unless ``ignore_order``
    is False."""
    assert got.schema.names == want.schema.names, \
        (got.schema.names, want.schema.names)
    g = [canon(tuple(r.values()), approx_float) for r in got.to_pylist()]
    w = [canon(tuple(r.values()), approx_float) for r in want.to_pylist()]
    if ignore_order:
        g, w = sorted(g), sorted(w)
    assert g == w, f"\nport: {g[:6]}\nwant: {w[:6]}"


def run_all(table, build, approx_float=False):
    """``build(session, api)`` over ``table`` in the port and both JAX
    engines; the port's result, after holding it against both."""
    port = build(TorchSession(device="cpu").create_dataframe(table),
                 PORT).collect()
    jdf = build(JS.TpuSession().create_dataframe(table), JAX)
    assert_tables_equal(port, jdf.collect(engine="tpu"),
                        approx_float=approx_float)
    assert_tables_equal(port, jdf.collect(engine="cpu"),
                        approx_float=approx_float)
    return port


def tagged_off(explain: str) -> list:
    """The lines ``explain()`` marks off the accelerator, with the JAX
    wording brought to the port's."""
    return [ln.replace("on TPU", "on the GPU").rstrip()
            for ln in explain.splitlines() if ln.lstrip().startswith("!")]


ROUND_TRIPS = {"struct": struct_table, "map": map_table,
               "list": list_table, "sliced_map": sliced_map_table,
               "spanning_null": spanning_null_table}


@pytest.mark.parametrize("name", sorted(ROUND_TRIPS))
def test_arrow_round_trip(name):
    t = ROUND_TRIPS[name]()
    back = to_arrow(from_arrow(t, CPU))
    for c in t.column_names:
        assert back.column(c).combine_chunks().equals(
            t.column(c).combine_chunks()), c
    got = TorchSession(device="cpu").create_dataframe(t).collect()
    assert got.to_pylist() == t.to_pylist()
    assert JS.TpuSession().create_dataframe(t).collect(
        engine="tpu").to_pylist() == got.to_pylist()


def test_sliced_map_decodes_its_own_entries():
    b = from_arrow(sliced_map_table(), CPU)
    assert to_arrow(b).column("m").to_pylist() == [[(4, 4.0)], [(5, 5.0)]]
    assert b.columns[0].offsets.tolist() == [0, 1, 2]


def test_from_arrow_type_maps_nested_types_both_ways():
    at = pa.struct([pa.field("a", pa.list_(pa.int32())),
                    pa.field("m", pa.map_(pa.int64(), pa.float64())),
                    pa.field("s", pa.string(), nullable=False)])
    dt = T.from_arrow_type(at)
    assert dt == T.StructType([
        T.Field("a", T.ListType(T.INT)),
        T.Field("m", T.MapType(T.LONG, T.DOUBLE)),
        T.Field("s", T.STRING, False)])
    assert T.to_arrow_type(dt) == at
    assert dt.field_index("m") == 1
    assert T.from_arrow_type(pa.large_list(pa.float64())) == \
        T.ListType(T.DOUBLE)
    with pytest.raises(TypeError, match="no nested lists"):
        T.ListType(T.ListType(T.LONG))


def test_get_struct_field():
    run_all(struct_table(), lambda df, a: df.select(
        a.col("s").get_field("x").alias("sx"),
        (a.col("s").get_field("y") * 2.0).alias("sy2"), a.col("w")),
        approx_float=True)


def test_struct_field_in_filter_and_aggregate():
    run_all(struct_table(), lambda df, a: df.where(
        a.col("s").get_field("x") > a.lit(50)).agg(
        (a.sum_(a.col("s").get_field("y")), "total")), approx_float=True)


def test_create_named_struct_then_extract():
    def build(df, a):
        ns = a.named_struct(("a", "b"), (a.col("w"),
                                         a.col("s").get_field("x")))
        return df.select(ns.alias("st")).select(
            a.col("st").get_field("a").alias("a"),
            a.col("st").get_field("b").alias("b"))

    run_all(struct_table(), build)


def test_named_struct_function_builds_a_struct():
    t = struct_table(50)
    df = TorchSession(device="cpu").create_dataframe(t)
    got = df.select(PS.named_struct("w", PS.col("w"), "x",
                                    PS.col("s").get_field("x"))
                    .get_field("x").alias("x")).collect()
    want = [None if r["s"] is None else r["s"]["x"] for r in t.to_pylist()]
    assert got.column("x").to_pylist() == want


def test_get_map_value_and_element_at_over_maps():
    run_all(map_table(), lambda df, a: df.select(
        a.col("m").get_map_value(a.lit(2)).alias("m2"),
        a.col("m").element_at(a.lit(4)).alias("m4"), a.col("v")))


def test_element_at_over_arrays():
    run_all(list_table(), lambda df, a: df.select(
        a.col("a").element_at(a.lit(1)).alias("first"),
        a.col("a").element_at(a.lit(-1)).alias("last"),
        a.col("a").element_at(a.lit(3)).alias("third")))


def test_element_at_index_zero_is_an_analysis_error():
    df = TorchSession(device="cpu").create_dataframe(list_table(10))
    with pytest.raises(ValueError, match="start at 1"):
        df.select(PS.col("a").element_at(0).alias("z")).collect()


def test_spanning_null_slot_is_no_part_of_its_row():
    got = run_all(spanning_null_table(), lambda df, a: df.select(
        a.col("k"), a.col("a").element_at(a.lit(1)).alias("e1"),
        a.col("a").element_at(a.lit(-1)).alias("e9")))
    assert got.sort_by("k").column("e1").to_pylist() == [1, None, None, 5]


def test_nested_columns_through_the_parquet_scan(tmp_path):
    paths = []
    for i, seed in enumerate((3, 4, 5)):
        t = struct_table(300, seed).append_column(
            "m", map_table(300, seed).column("m")).append_column(
            "a", list_table(300, seed).column("a"))
        paths.append(str(tmp_path / f"n{i}.parquet"))
        pq.write_table(t, paths[-1])

    def build(s, a):
        return s.read_parquet(*paths).where(a.col("w") > a.lit(3)).select(
            a.col("s").get_field("y").alias("y"), a.col("w"),
            a.col("m").element_at(a.lit(3)).alias("m3"),
            a.col("a").element_at(a.lit(2)).alias("a2"), a.col("s"))

    port_s = TorchSession({TTB: 1}, device="cpu")
    plan = build(port_s, PORT).physical_plan()
    assert plan.children[0].num_partitions == 3
    assert not any(isinstance(n, CpuFallbackExec) for n in plan.walk())
    port = build(port_s, PORT).collect()
    jdf = build(JS.TpuSession(), JAX)
    assert_tables_equal(port, jdf.collect(engine="tpu"))
    assert_tables_equal(port, jdf.collect(engine="cpu"))


def test_struct_columns_over_several_batches():
    t = struct_table(700, seed=11)
    s = TorchSession({"spark.rapids.tpu.sql.batchSizeRows": 100},
                     device="cpu")
    got = s.create_dataframe(t).select(PS.col("s").get_field("x").alias("x"),
                                       PS.col("s")).collect()
    jdf = JS.TpuSession().create_dataframe(t).select(
        JS.col("s").get_field("x").alias("x"), JS.col("s"))
    assert_tables_equal(got, jdf.collect(engine="tpu"))
    assert got.column("s").to_pylist() == t.column("s").to_pylist()


def _array_join_files(tmp_path):
    """Three files of a list table and one dimension file."""
    lt = list_table(600, 21)
    rng = np.random.default_rng(22)
    rt = pa.table({"k2": pa.array(np.arange(7)),
                   "name": pa.array([f"n{i}" for i in range(7)]),
                   "w": pa.array(rng.random(7))})
    lpaths = []
    for i in range(3):
        lpaths.append(str(tmp_path / f"l{i}.parquet"))
        pq.write_table(lt.slice(i * 200, 200), lpaths[-1])
    rpath = str(tmp_path / "r.parquet")
    pq.write_table(rt, rpath)
    return lt, lpaths, rpath


def test_adaptive_join_carries_an_array_on_its_stream_side(tmp_path):
    """The default plan of the test below: an adaptive join over the two
    exchanges, decided shuffled (broadcast off), whose coalesced reader
    concatenates the arrays; the rows are the JAX device engine's."""
    from spark_rapids_tpu_torch.execs.adaptive import TpuAdaptiveJoinExec

    lt, lpaths, rpath = _array_join_files(tmp_path)
    s = TorchSession({TTB: 1, BCAST: -1}, device="cpu")

    def build(sess, a):
        return sess.read_parquet(*lpaths).join(
            sess.read_parquet(rpath), left_on=[a.col("k")],
            right_on=[a.col("k2")]).select(a.col("k"), a.col("a"),
                                           a.col("name"))

    plan = build(s, PORT).physical_plan()
    [join] = [n for n in plan.walk() if isinstance(n, TpuAdaptiveJoinExec)]
    got = collect_exec(plan, s.conf)
    assert join.decision.startswith("shuffled"), join.decision
    assert_tables_equal(got, build(JS.TpuSession(), JAX).collect(
        engine="tpu"))
    assert got.num_rows == sum(1 for r in lt.to_pylist()
                               if r["k"] is not None and 0 <= r["k"] < 7)


def test_shuffled_join_carries_an_array_on_its_stream_side(tmp_path):
    """Arrays gathered into partitions by a hash exchange, parked in the
    store and concatenated on the reduce side of a partition-wise
    join."""
    lt = list_table(600, 21)
    rng = np.random.default_rng(22)
    rt = pa.table({"k2": pa.array(np.arange(7)),
                   "name": pa.array([f"n{i}" for i in range(7)]),
                   "w": pa.array(rng.random(7))})
    lpaths, rpaths = [], []
    for i in range(3):
        lpaths.append(str(tmp_path / f"l{i}.parquet"))
        pq.write_table(lt.slice(i * 200, 200), lpaths[-1])
    rpaths.append(str(tmp_path / "r.parquet"))
    pq.write_table(rt, rpaths[0])
    # the static plan; the adaptive join's is the test above
    s = TorchSession({TTB: 1, BCAST: -1, ADAPTIVE: False}, device="cpu")

    def build(sess, a):
        return sess.read_parquet(*lpaths).join(
            sess.read_parquet(*rpaths), left_on=[a.col("k")],
            right_on=[a.col("k2")]).select(a.col("k"), a.col("a"),
                                           a.col("name"))

    plan = build(s, PORT).physical_plan()
    tree = plan.tree_string()
    assert "partition_wise" in tree or "TpuShuffleExchangeExec" in tree, tree
    join = [n for n in plan.walk()
            if type(n).__name__ == "TpuShuffledHashJoinExec"]
    assert join and join[0].partition_wise, tree
    got = build(s, PORT).collect()
    # the JAX CPU engine's pyarrow join takes no array payload
    assert_tables_equal(got, build(JS.TpuSession(), JAX).collect(
        engine="tpu"))
    want = {}
    for r in lt.to_pylist():
        if r["k"] is not None:
            want.setdefault(r["k"], []).append(r["a"])
    seen = {}
    for r in got.to_pylist():
        seen.setdefault(r["k"], []).append(r["a"])
    assert {k: sorted(map(str, v)) for k, v in seen.items()} == \
        {k: sorted(map(str, v)) for k, v in want.items()}


def _string_map_table():
    rows = [[("a", "x")], None, [("b", "y"), ("c", None)]] * 30
    return pa.table({"m": pa.array(rows, pa.map_(pa.string(), pa.string())),
                     "v": pa.array(np.arange(90))})


def _list_of_struct_table():
    rows = [[{"a": 1}], None, [{"a": 2}, {"a": 3}]] * 20
    return pa.table({
        "x": pa.array(rows, pa.list_(pa.struct([("a", pa.int64())]))),
        "v": pa.array(np.arange(60))})


FALLBACKS = {
    "map_string_values": (_string_map_table,
                          lambda df, a: df.select(a.col("v"))),
    "list_of_struct": (_list_of_struct_table,
                       lambda df, a: df.select(a.col("v"))),
    "alias_of_map": (map_table, lambda df, a: df.select(
        a.col("m").alias("mm"), a.col("v"))),
    "alias_of_struct": (struct_table, lambda df, a: df.select(
        a.named_struct(("w",), (a.col("w"),)).alias("st"))),
}


@pytest.mark.parametrize("name", sorted(FALLBACKS))
def test_fallbacks_mark_what_the_jax_package_marks(name):
    make, build = FALLBACKS[name]
    t = make()
    port = build(TorchSession(device="cpu").create_dataframe(t), PORT)
    jdf = build(JS.TpuSession().create_dataframe(t), JAX)
    ours = tagged_off(port.explain())
    assert ours and ours == tagged_off(jdf.explain())
    assert any(isinstance(n, CpuFallbackExec)
               for n in port.physical_plan().walk())
    assert_tables_equal(port.collect(), jdf.collect(engine="tpu"))


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_nested_extract_pipeline(seed):
    t = gen_table({"s": "struct", "m": "map", "k": "smallint64"}, 400,
                  seed=seed)
    run_all(t, lambda df, a: df.select(
        a.col("s").get_field("a").alias("sa"),
        a.col("s").get_field("b").alias("sb"),
        a.col("m").element_at(a.lit(int(seed) % 8)).alias("mv"),
        a.col("k")).where(a.col("sa").is_not_null() | a.col("k").is_null()),
        approx_float=True)


@pytest.mark.parametrize("fast", [False, True])
def test_the_native_decoder_leaves_nested_columns_to_pyarrow(tmp_path, fast):
    """With ``scan.fastDecode`` on, a scan that reads a nested column
    decodes on pyarrow's path, as the JAX scan does; one reading only
    the file's scalar columns stays on the native decoder."""
    t = struct_table(300, 7).append_column("m", map_table(300, 7).column("m"))
    p = str(tmp_path / "f.parquet")
    pq.write_table(t, p)
    s = TorchSession({"spark.rapids.tpu.sql.scan.fastDecode": fast},
                     device="cpu")

    def scan_counts(df):
        plan = df.physical_plan()
        got = collect_exec(plan, s.conf)
        (scan,) = [n for n in plan.walk()
                   if type(n).__name__ == "ParquetScanExec"]
        return got, (scan.metrics["fastDecodedFiles"],
                     scan.metrics["standardDecodedFiles"])

    nested, counts = scan_counts(s.read_parquet(p).select(
        PS.col("w"), PS.col("m").element_at(2).alias("m2")))
    assert counts == (0, 1)
    assert_tables_equal(nested, JS.TpuSession().read_parquet(p).select(
        JS.col("w"), JS.col("m").element_at(JB.lit(2)).alias("m2")).collect(
        engine="cpu"))
    flat, counts = scan_counts(s.read_parquet(p).select(PS.col("w")))
    assert counts == ((1, 0) if fast else (0, 1))
    assert flat.column("w").to_pylist() == t.column("w").to_pylist()


def test_count_of_an_array_through_a_rollup():
    """An array payload rides the Expand of a rollup and is counted (held
    against the JAX CPU engine: the JAX device Expand has no layout for
    it and raises)."""
    t = list_table(200, 12).append_column(
        "b", pa.array(np.arange(200) % 3))
    got = TorchSession(device="cpu").create_dataframe(t).rollup(
        "k", "b").agg((PS.count(PS.col("a")), "n")).collect()
    want = JS.TpuSession().create_dataframe(t).rollup("k", "b").agg(
        (JS.count(JS.col("a")), "n")).collect(engine="cpu")
    assert_tables_equal(got, want)


def _payload_window(df, a):
    from spark_rapids_tpu.exprs.window import Window as JW
    from spark_rapids_tpu.exprs.window import rank as jrank
    from spark_rapids_tpu_torch import Window as PW
    from spark_rapids_tpu_torch.exprs.window import rank as prank

    W, rank = (PW, prank) if a is PORT else (JW, jrank)
    return df.select(a.col("w"), a.col("a"), a.col("s"), a.col("m"),
                     rank().over(W.partition_by("w").order_by("w"))
                     .alias("r"))


PAYLOADS = {
    "sort": lambda df, a: df.order_by(a.col("w")),
    "filter": lambda df, a: df.where(a.col("w") > a.lit(4)),
    "union": lambda df, a: df.union(df),
    "window": _payload_window,
    "join": lambda df, a: df.join(df.select(a.col("w").alias("w2")).limit(3),
                                  left_on=[a.col("w")],
                                  right_on=[a.col("w2")]),
    "topn": lambda df, a: df.order_by(a.col("w")).limit(20),
}


@pytest.mark.parametrize("op", sorted(PAYLOADS))
def test_operators_carry_nested_payloads(op):
    """A struct, a map and an array ride a sort, a filter, a union, a
    window, a join and a top-n unchanged (against the JAX device engine;
    a top-n's ties at its edge may differ, so only its keys compare)."""
    t = struct_table(300, 2).append_column(
        "m", map_table(300, 2).column("m")).append_column(
        "a", list_table(300, 2).column("a"))
    port = PAYLOADS[op](TorchSession(device="cpu").create_dataframe(t),
                        PORT)
    assert not any(isinstance(n, CpuFallbackExec)
                   for n in port.physical_plan().walk())
    got = port.collect()
    want = PAYLOADS[op](JS.TpuSession().create_dataframe(t), JAX).collect(
        engine="tpu")
    if op == "topn":
        got, want = got.select(["w"]), want.select(["w"])
    assert_tables_equal(got, want)
