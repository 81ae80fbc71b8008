"""collect_list / collect_set and pivot in the port, against the JAX
package.

The same numpy-seeded tables go through the port's
``TorchSession(device="cpu")`` and the JAX package's ``TpuSession`` on
its device engine (the JAX CPU backend) and its CPU engine.

- ``ops/collect.py`` / ``execs/collect_agg.py``: grouped, grand, empty
  and multi-partition collects.  Where one value is collected the
  port's arrays equal the JAX device's element for element (ascending:
  -0.0 before 0.0, NaN last; a set keeps one NaN and one of -0.0 and
  0.0); against the JAX CPU engine, which keeps input order, arrays
  compare as sorted multisets.  Two collects in one aggregate: each of
  the port's is its value's own (sorted, deduplicated), held against
  pyarrow; the JAX device sorts by every collected value at once and
  its second set keeps repeats (``ROADMAP.md`` section 3).
- The plans: several input partitions hash-exchange on the group keys
  and collect per partition; a child already distributed so is not
  exchanged again; a grand collect coalesces.
- What falls back, as in the JAX package: a collect over a STRING (the
  JAX reasons in ``explain()``), a GPU parent over it (no device layout
  for array<string>), a collect beside a scalar aggregate (tagged here,
  decided at lowering there); a collect over an array is a construction
  error.
- ``GroupedData.pivot`` and ``PivotFirst``: one masked aggregate per
  value, a masked NULL never wins a First, a None value matches NULL
  pivot keys, names ``{value}`` or ``{value}_{agg}``; integer sums exact,
  float sums within 1e-9 relative.
"""

import math

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import session as JS
from spark_rapids_tpu.exprs import aggregates as JAG

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import session as PS
from spark_rapids_tpu_torch.execs.collect_agg import TpuCollectAggExec
from spark_rapids_tpu_torch.execs.fallback import CpuFallbackExec
from spark_rapids_tpu_torch.exprs import aggregates as AG
from test_torch_nested import JAX, PORT, assert_tables_equal, canon
from torch_quiet import quiet_ladder  # noqa: F401

for _api, _mod in ((PORT, PS), (JAX, JS)):
    for _fn in ("collect_list", "collect_set", "count", "first"):
        setattr(_api, _fn, getattr(_mod, _fn))
PORT.NamedAgg, JAX.NamedAgg = AG.NamedAgg, JAG.NamedAgg
PORT.PivotFirst, JAX.PivotFirst = AG.PivotFirst, JAG.PivotFirst
PORT.First, JAX.First = AG.First, JAG.First

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
BATCH = "spark.rapids.tpu.sql.batchSizeRows"


def sorted_lists(table: pa.Table) -> pa.Table:
    """Each array cell sorted (NaN last): element order is Spark's
    choice, so the CPU engines compare this way."""
    out = {}
    for name in table.column_names:
        vals = table.column(name).to_pylist()
        if pa.types.is_list(table.schema.field(name).type):
            vals = [None if v is None else sorted(v, key=canon)
                    for v in vals]
        out[name] = pa.array(vals, table.schema.field(name).type)
    return pa.table(out)


def run_collect(table, build, conf=None, jconf=None):
    """The port's result; held exactly against the JAX device's and,
    with arrays sorted, against the JAX CPU engine's (which of -0.0 and
    0.0 a set keeps follows its input order there: zeros compare
    without their sign)."""
    port = build(TorchSession(conf, device="cpu").create_dataframe(table),
                 PORT).collect()
    jdf = build(JS.TpuSession(jconf).create_dataframe(table), JAX)
    assert_tables_equal(port, jdf.collect(engine="tpu"))
    assert_tables_equal(sorted_lists(port),
                        sorted_lists(jdf.collect(engine="cpu")),
                        approx_float=True)
    return port


def _ints(n, seed, null=0.15, hi=50):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, 12, n),
        "v": pa.array([None if rng.random() < null else int(x)
                       for x in rng.integers(0, hi, n)], pa.int64())})


def _floats(n, seed):
    rng = np.random.default_rng(seed)
    vals = [None if rng.random() < 0.1 else float(rng.integers(0, 5))
            for _ in range(n)]
    for i in range(0, n, 37):
        vals[i] = float("nan")
    for i in range(5, n, 41):
        vals[i] = -0.0
    for i in range(9, n, 43):
        vals[i] = 0.0
    return pa.table({"k": rng.integers(0, 6, n),
                     "v": pa.array(vals, pa.float64())})


@pytest.mark.parametrize("kind", ["collect_list", "collect_set"])
@pytest.mark.parametrize("seed", [61, 62])
def test_grouped_collect_over_integers(kind, seed):
    def build(df, a):
        return df.group_by(a.col("k")).agg((getattr(a, kind)(a.col("v")),
                                            "vs"))

    got = run_collect(_ints(3000, seed), build)
    for vs in got.column("vs").to_pylist():
        assert vs == sorted(vs)
        assert kind == "collect_list" or len(set(vs)) == len(vs)
    plan = build(TorchSession(device="cpu").create_dataframe(
        _ints(10, seed)), PORT).physical_plan()
    assert isinstance(plan, TpuCollectAggExec)


@pytest.mark.parametrize("kind", ["collect_list", "collect_set"])
def test_collect_of_nan_and_signed_zeros(kind):
    got = run_collect(_floats(2000, 63), lambda df, a: df.group_by(
        a.col("k")).agg((getattr(a, kind)(a.col("v")), "vs")))
    for vs in got.column("vs").to_pylist():
        nans = sum(1 for x in vs if math.isnan(x))
        zeros = [math.copysign(1, x) for x in vs if x == 0]
        assert zeros == sorted(zeros)  # -0.0 first
        if kind == "collect_set":
            assert nans <= 1 and len(zeros) <= 1


@pytest.mark.parametrize("kind", ["collect_list", "collect_set"])
def test_grand_collect_and_empty_input(kind):
    t = pa.table({"v": pa.array([3, 1, None, 2, 3], pa.int64())})
    got = run_collect(t, lambda df, a: df.agg(
        (getattr(a, kind)(a.col("v")), "vs")))
    assert got.column("vs").to_pylist() == [
        [1, 2, 3, 3] if kind == "collect_list" else [1, 2, 3]]
    empty = pa.table({"v": pa.array([], pa.int64())})
    got = run_collect(empty, lambda df, a: df.agg(
        (getattr(a, kind)(a.col("v")), "vs")))
    assert got.column("vs").to_pylist() == [[]]
    grouped = run_collect(empty.append_column("k", pa.array([], pa.int64())),
                          lambda df, a: df.group_by(a.col("k")).agg(
                              (getattr(a, kind)(a.col("v")), "vs")))
    assert grouped.num_rows == 0


def test_an_all_null_group_collects_an_empty_array():
    t = pa.table({"k": [1, 1, 2], "v": pa.array([None, None, 4],
                                                pa.int64())})
    got = run_collect(t, lambda df, a: df.group_by(a.col("k")).agg(
        (a.collect_list(a.col("v")), "l"), ))
    assert dict(zip(*got.to_pydict().values())) == {1: [], 2: [4]}


def test_two_collects_each_sort_their_own_value():
    t = pa.table({"k": [1, 1, 1, 1, 2, 2], "a": [4, 3, 2, 1, 5, 6],
                  "b": [7, 8, 7, 8, 1, 1]})

    def build(df, a):
        return df.group_by(a.col("k")).agg(
            (a.collect_list(a.col("a")), "l"), (a.collect_set(a.col("b")),
                                                "s"))

    got = build(TorchSession(device="cpu").create_dataframe(t),
                PORT).collect()
    assert got.sort_by("k").to_pylist() == [
        {"k": 1, "l": [1, 2, 3, 4], "s": [7, 8]},
        {"k": 2, "l": [5, 6], "s": [1]}]
    ref = t.group_by("k").aggregate([("a", "list"), ("b", "distinct")])
    assert sorted_lists(got.sort_by("k")).column("s").to_pylist() == \
        sorted_lists(ref.sort_by("k")).column("b_distinct").to_pylist()
    jcpu = build(JS.TpuSession().create_dataframe(t), JAX).collect(
        engine="cpu")
    assert_tables_equal(sorted_lists(got), sorted_lists(jcpu))


def _parquet_parts(tmp_path, t, n_files):
    paths = []
    rows = -(-t.num_rows // n_files)
    for i in range(n_files):
        paths.append(str(tmp_path / f"c{i}.parquet"))
        pq.write_table(t.slice(i * rows, rows), paths[-1])
    return paths


@pytest.mark.parametrize("kind", ["collect_list", "collect_set"])
def test_multi_partition_grouped_collect(tmp_path, kind):
    t = _ints(3000, 77)
    paths = _parquet_parts(tmp_path, t, 5)

    def build(s, a):
        return s.read_parquet(*paths).group_by(a.col("k")).agg(
            (getattr(a, kind)(a.col("v")), "vs"))

    s = TorchSession({TTB: 1}, device="cpu")
    plan = build(s, PORT).physical_plan()
    assert isinstance(plan, TpuCollectAggExec) and plan.partitioned
    assert type(plan.children[0]).__name__ == "TpuShuffleExchangeExec"
    assert not any(isinstance(n, CpuFallbackExec) for n in plan.walk())
    got = build(s, PORT).collect()
    assert_tables_equal(got, build(JS.TpuSession(), JAX).collect(
        engine="tpu"))
    want = t.group_by("k").aggregate(
        [("v", "list" if kind == "collect_list" else "distinct")])
    want = want.rename_columns(["k", "vs"])
    want = want.set_column(1, "vs", pa.array(
        [[x for x in v if x is not None] for v in want.column(1).to_pylist()],
        pa.list_(pa.int64())))
    assert_tables_equal(sorted_lists(got), sorted_lists(want))


def test_multi_partition_collect_over_a_hash_distributed_child(tmp_path):
    """A collect over a final aggregate keyed alike takes no second
    exchange."""
    paths = _parquet_parts(tmp_path, _ints(1200, 78), 3)

    def build(s, a):
        return s.read_parquet(*paths).group_by(a.col("k"), a.col("v")).agg(
            (a.count(a.col("v")), "n")).group_by(a.col("k")).agg(
            (a.collect_list(a.col("v")), "vs"))

    s = TorchSession({TTB: 1}, device="cpu")
    plan = build(s, PORT).physical_plan()
    exchanges = [n for n in plan.walk()
                 if type(n).__name__ == "TpuShuffleExchangeExec"]
    assert isinstance(plan, TpuCollectAggExec) and plan.partitioned
    assert len(exchanges) == 2, plan.tree_string()
    assert_tables_equal(build(s, PORT).collect(),
                        build(JS.TpuSession(), JAX).collect(engine="tpu"))


def test_multi_partition_grand_collect(tmp_path):
    t = _ints(900, 79)
    paths = _parquet_parts(tmp_path, t, 3)

    def build(s, a):
        return s.read_parquet(*paths).agg((a.collect_list(a.col("v")), "vs"))

    s = TorchSession({TTB: 1}, device="cpu")
    plan = build(s, PORT).physical_plan()
    assert isinstance(plan, TpuCollectAggExec) and not plan.partitioned
    got = build(s, PORT).collect()
    assert_tables_equal(got, build(JS.TpuSession(), JAX).collect(
        engine="tpu"))
    assert got.column("vs").to_pylist() == [
        sorted(x for x in t.column("v").to_pylist() if x is not None)]


def test_multi_batch_collect_in_one_partition():
    got = run_collect(_ints(1000, 80), lambda df, a: df.group_by(
        a.col("k")).agg((a.collect_set(a.col("v")), "vs")),
        conf={BATCH: 100})
    assert got.num_rows == 12


def test_collect_over_strings_falls_back_with_the_jax_reason():
    t = pa.table({"k": [1, 1, 2], "s": ["a", "b", "a"]})

    def build(df, a):
        return df.group_by(a.col("k")).agg((a.collect_list(a.col("s")), "vs"))

    port = build(TorchSession(device="cpu").create_dataframe(t), PORT)
    jdf = build(JS.TpuSession().create_dataframe(t), JAX)
    off = [ln.replace("on TPU", "on the GPU")
           for ln in jdf.explain().splitlines() if "!" in ln]
    assert [ln for ln in port.explain().splitlines()
            if ln.lstrip().startswith("!")] == off
    assert isinstance(port.physical_plan(), CpuFallbackExec)
    assert_tables_equal(sorted_lists(port.collect()),
                        sorted_lists(jdf.collect(engine="tpu")))


def test_string_collect_below_a_gpu_parent_moves_it_to_the_cpu():
    t = pa.table({"k": [1, 1, 2], "s": ["a", "b", "a"]})

    def build(df, a):
        return df.group_by(a.col("k")).agg(
            (a.collect_list(a.col("s")), "l")).select(a.col("k"))

    port = build(TorchSession(device="cpu").create_dataframe(t), PORT)
    jdf = build(JS.TpuSession().create_dataframe(t), JAX)
    ours = [ln for ln in port.explain().splitlines()
            if ln.lstrip().startswith("!")]
    assert ours == [ln.replace("on TPU", "on the GPU")
                    for ln in jdf.explain().splitlines()
                    if ln.lstrip().startswith("!")]
    assert "child output type has no device layout" in ours[0]
    assert isinstance(port.physical_plan(), CpuFallbackExec)
    assert sorted(port.collect().column("k").to_pylist()) == [1, 2]


def test_collect_beside_a_scalar_aggregate_runs_on_the_cpu_engine():
    t = _ints(600, 81)

    def build(df, a):
        return df.group_by(a.col("k")).agg(
            (a.collect_set(a.col("v")), "vs"), (a.sum_(a.col("v")), "s"))

    port = build(TorchSession(device="cpu").create_dataframe(t), PORT)
    off = [ln for ln in port.explain().splitlines()
           if ln.lstrip().startswith("!")]
    assert len(off) == 1 and "beside other aggregates" in off[0]
    assert isinstance(port.physical_plan(), CpuFallbackExec)
    jdf = build(JS.TpuSession().create_dataframe(t), JAX)
    assert_tables_equal(sorted_lists(port.collect()),
                        sorted_lists(jdf.collect(engine="tpu")))


def test_collect_over_an_array_is_a_construction_error():
    t = pa.table({"k": [1, 1], "x": pa.array([[1, 2], [3]],
                                             pa.list_(pa.int64()))})
    with pytest.raises(TypeError, match="array column"):
        TorchSession(device="cpu").create_dataframe(t).group_by(
            PS.col("k")).agg((PS.collect_list(PS.col("x")), "l"))


def _pivot_table(n=2000, seed=21):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, 4, n),
        "p": pa.array(np.array(["x", "y", "z"])[rng.integers(0, 3, n)]),
        "v": rng.integers(0, 100, n),
        "d": rng.random(n)})


def test_pivot_single_aggregate():
    t = _pivot_table()
    got = run_collect(t, lambda df, a: df.group_by(a.col("k")).pivot(
        a.col("p"), ["x", "y"]).agg((a.sum_(a.col("v")), "s")))
    assert got.column_names == ["k", "x", "y"]
    want = {}
    for r in t.to_pylist():
        if r["p"] in ("x", "y"):
            w = want.setdefault(r["k"], {"x": 0, "y": 0})
            w[r["p"]] += r["v"]
    assert {r["k"]: {"x": r["x"], "y": r["y"]}
            for r in got.to_pylist()} == want


def test_pivot_first_expression():
    t = pa.table({"k": pa.array([1, 1, 2, 2, 1]),
                  "p": pa.array(["a", "b", "a", "c", "a"]),
                  "v": pa.array([10, 20, 30, 40, 50])})
    got = run_collect(t, lambda df, a: df.group_by(a.col("k")).agg(
        a.NamedAgg(a.PivotFirst(a.col("v"), a.col("p"), ("a", "b")),
                   "__pivot")))
    assert {r["k"]: (r["a"], r["b"]) for r in got.to_pylist()} == \
        {1: (10, 20), 2: (30, None)}


def test_pivot_multi_aggregate_names():
    t = pa.table({"k": pa.array([1, 1, 2]), "p": pa.array(["a", "b", "a"]),
                  "v": pa.array([5, 6, 7])})
    got = run_collect(t, lambda df, a: df.group_by(a.col("k")).pivot(
        a.col("p"), ["a", "b"]).agg((a.sum_(a.col("v")), "s"),
                                    (a.count(a.col("v")), "c")))
    assert got.column_names == ["k", "a_s", "a_c", "b_s", "b_c"]


def test_pivot_first_semantics_regressions():
    t = pa.table({"k": pa.array([1, 1]), "p": pa.array(["b", "a"]),
                  "v": pa.array([10, 20])})
    got = run_collect(t, lambda df, a: df.group_by(a.col("k")).pivot(
        a.col("p"), ["a"]).agg(a.NamedAgg(a.First(a.col("v")), "f")))
    assert got.to_pylist() == [{"k": 1, "a": 20}]
    t2 = pa.table({"k": pa.array([1, 1, 1]),
                   "p": pa.array(["x", None, None]),
                   "v": pa.array([1, 2, 3])})
    got = run_collect(t2, lambda df, a: df.group_by(a.col("k")).pivot(
        a.col("p"), ["x", None]).agg((a.sum_(a.col("v")), "s")))
    row = got.to_pylist()[0]
    assert row["x"] == 1 and row["None"] == 5


def test_pivot_over_an_exchange(tmp_path):
    t = _pivot_table(3000, 22)
    paths = _parquet_parts(tmp_path, t, 3)

    def build(s, a):
        return s.read_parquet(*paths).group_by(a.col("k")).pivot(
            a.col("p"), ["x", "y", "z"]).agg((a.sum_(a.col("d")), "s"))

    s = TorchSession({TTB: 1}, device="cpu")
    assert "TpuShuffleExchangeExec" in build(s, PORT).physical_plan(
    ).tree_string()
    got = build(s, PORT).collect()
    jgot = build(JS.TpuSession(), JAX).collect(engine="tpu")
    assert_tables_equal(got, jgot, approx_float=True)
    for name in "xyz":
        want = pc.sum(t.filter(pc.equal(t["p"], name))["d"]).as_py()
        have = pc.sum(got[name]).as_py()
        assert abs(have - want) <= 1e-9 * abs(want)
