"""explode / posexplode (Generate) and the array expressions in the port,
against the JAX package.

Each case runs one DataFrame through the port's
``TorchSession(device="cpu")`` and the JAX package's ``TpuSession`` on
its device engine (the JAX CPU backend) and its CPU engine, over
numpy-seeded or hand-written arrays: rows must be equal exactly, and in
the cases with a known order, in that order (parent rows, then
elements).

- ``execs/generate.py``: explode, explode_outer, posexplode and
  posexplode_outer (``pos`` NULL on an outer row), over empty arrays,
  NULL arrays, NULL elements and a NULL slot that spans elements;
  explode then aggregate; explode over several scan tasks and an
  exchange; with its switch off the Generate runs on the CPU engine.
- ``exprs/collections.py``: size, getItem, array_contains (NULL when
  absent and the array holds a NULL), array(); size of a NULL array is
  NULL, as the JAX package has it (Spark 3.x's default gives -1).
- The analysis errors: a nested generator, two generators, an alias of
  posexplode, explode of a non-array.
"""

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import session as JS

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import session as PS
from spark_rapids_tpu_torch.execs.fallback import CpuFallbackExec
from test_torch_nested import (
    JAX,
    PORT,
    assert_tables_equal,
    list_table,
    spanning_null_table,
)
from torch_quiet import quiet_ladder  # noqa: F401

for _api, _mod in ((PORT, PS), (JAX, JS)):
    for _fn in ("explode", "explode_outer", "posexplode", "posexplode_outer",
                "array", "array_size", "get_item", "array_contains",
                "count"):
        setattr(_api, _fn, getattr(_mod, _fn))

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
LISTS = pa.table({
    "id": pa.array([1, 2, 3, 4, 5], pa.int64()),
    "xs": pa.array([[10, 20], [], None, [30], [40, None, 50]],
                   pa.list_(pa.int64())),
})


def both(table, build, conf=None):
    """The port's rows, after holding them, in order, against the JAX
    device engine's and, as a multiset, its CPU engine's."""
    port = build(TorchSession(conf, device="cpu").create_dataframe(table),
                 PORT).collect()
    jdf = build(JS.TpuSession().create_dataframe(table), JAX)
    assert_tables_equal(port, jdf.collect(engine="tpu"), ignore_order=False)
    assert_tables_equal(port, jdf.collect(engine="cpu"))
    return port.to_pydict()


def test_explode():
    out = both(LISTS, lambda df, a: df.select(
        a.col("id"), a.explode(a.col("xs")).alias("x")))
    assert list(zip(out["id"], out["x"])) == [
        (1, 10), (1, 20), (4, 30), (5, 40), (5, None), (5, 50)]


def test_explode_outer():
    out = both(LISTS, lambda df, a: df.select(
        a.col("id"), a.explode_outer(a.col("xs")).alias("x")))
    assert list(zip(out["id"], out["x"])) == [
        (1, 10), (1, 20), (2, None), (3, None), (4, 30), (5, 40),
        (5, None), (5, 50)]


def test_posexplode():
    out = both(LISTS, lambda df, a: df.select(
        a.col("id"), a.posexplode(a.col("xs"))))
    assert list(zip(out["id"], out["pos"], out["col"])) == [
        (1, 0, 10), (1, 1, 20), (4, 0, 30), (5, 0, 40), (5, 1, None),
        (5, 2, 50)]


def test_posexplode_outer_has_a_null_pos_on_its_outer_rows():
    out = both(LISTS, lambda df, a: df.select(
        a.col("id"), a.posexplode_outer(a.col("xs"))))
    assert list(zip(out["id"], out["pos"], out["col"])) == [
        (1, 0, 10), (1, 1, 20), (2, None, None), (3, None, None),
        (4, 0, 30), (5, 0, 40), (5, 1, None), (5, 2, 50)]


@pytest.mark.parametrize("form", ["explode", "explode_outer", "posexplode",
                                  "posexplode_outer"])
@pytest.mark.parametrize("seed", [0, 1])
def test_explode_forms_over_seeded_arrays(form, seed):
    def build(df, a):
        gen = getattr(a, form)(a.col("a"))
        return df.select(a.col("k"), gen if form.startswith("pos")
                         else gen.alias("e"))

    both(list_table(400, seed), build)


@pytest.mark.parametrize("form", ["explode", "explode_outer"])
def test_explode_skips_the_elements_a_null_slot_spans(form):
    out = both(spanning_null_table(), lambda df, a: df.select(
        a.col("k"), getattr(a, form)(a.col("a")).alias("e")))
    # rows: [1, NULL], NULL over [3, 4], [], [5, 6]
    want = [(1, 1), (1, None), (4, 5), (4, 6)] if form == "explode" else \
        [(1, 1), (1, None), (2, None), (3, None), (4, 5), (4, 6)]
    assert list(zip(out["k"], out["e"])) == want


def test_explode_then_aggregate():
    out = both(LISTS, lambda df, a: df.select(
        a.col("id"), a.explode(a.col("xs")).alias("x")).group_by(
        a.col("id")).agg((a.sum_(a.col("x")), "s")))
    assert dict(zip(out["id"], out["s"])) == {1: 30, 4: 30, 5: 90}


def test_collection_exprs():
    out = both(LISTS, lambda df, a: df.select(
        a.col("id"), a.array_size(a.col("xs")).alias("n"),
        a.get_item(a.col("xs"), 1).alias("second"),
        a.array_contains(a.col("xs"), 30).alias("has30"),
        a.array(a.col("id"), a.lit(7)).alias("pair")))
    assert out["n"] == [2, 0, None, 1, 3]
    assert out["second"] == [20, None, None, None, None]
    assert out["has30"] == [False, False, None, True, None]
    assert out["pair"] == [[1, 7], [2, 7], [3, 7], [4, 7], [5, 7]]


@pytest.mark.parametrize("seed", [3, 4])
def test_collection_exprs_over_seeded_arrays(seed):
    both(list_table(500, seed), lambda df, a: df.select(
        a.col("k"), a.array_size(a.col("a")).alias("n"),
        a.get_item(a.col("a"), 0).alias("g0"),
        a.get_item(a.col("a"), 2).alias("g2"),
        a.get_item(a.col("a"), -1).alias("gneg"),
        a.array_contains(a.col("a"), 7).alias("c7"),
        a.array(a.col("k"), a.col("k") * a.lit(2)).alias("arr")))


def test_explode_floats_round_trip_through_parquet(tmp_path):
    t = pa.table({"xs": pa.array([[1.5, 2.5], [3.25]],
                                 pa.list_(pa.float64()))})
    p = str(tmp_path / "f.parquet")
    pq.write_table(t, p)
    df = TorchSession(device="cpu").read_parquet(p).select(
        PS.explode(PS.col("xs")).alias("x"))
    assert df.collect().to_pydict() == {"x": [1.5, 2.5, 3.25]}


def test_explode_over_scan_tasks_and_an_exchange(tmp_path):
    t = list_table(900, 31)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"e{i}.parquet"))
        pq.write_table(t.slice(i * 300, 300), paths[-1])

    def build(s, a):
        return s.read_parquet(*paths).select(
            a.col("k"), a.explode(a.col("a")).alias("x")).group_by(
            a.col("x")).agg((a.count(a.col("k")), "n"))

    s = TorchSession({TTB: 1}, device="cpu")
    plan = build(s, PORT).physical_plan()
    tree = plan.tree_string()
    assert "TpuGenerateExec" in tree and "TpuShuffleExchangeExec" in tree
    got = build(s, PORT).collect()
    assert_tables_equal(got, build(JS.TpuSession(), JAX).collect(
        engine="tpu"))
    want = {}
    for r in t.to_pylist():
        for x in r["a"] or []:
            want[x] = want.get(x, 0) + 1
    assert dict(zip(*got.to_pydict().values())) == want


def test_generate_switch_off_runs_on_the_cpu_engine():
    s = TorchSession({"spark.rapids.tpu.sql.exec.Generate": False},
                     device="cpu")
    df = s.create_dataframe(LISTS).select(
        PS.col("id"), PS.posexplode_outer(PS.col("xs")))
    off = [ln for ln in df.explain().splitlines()
           if ln.lstrip().startswith("!")]
    assert len(off) == 1 and "Generate [posexplode_outer(xs)]" in off[0]
    assert "disabled by spark.rapids.tpu.sql.exec.Generate" in off[0]
    fb = [n for n in df.physical_plan().walk()
          if isinstance(n, CpuFallbackExec)]
    assert len(fb) == 1 and fb[0].streaming
    on = TorchSession(device="cpu").create_dataframe(LISTS).select(
        PS.col("id"), PS.posexplode_outer(PS.col("xs")))
    assert df.collect().equals(on.collect())


def test_nested_explode_is_rejected():
    df = TorchSession(device="cpu").create_dataframe(LISTS)
    with pytest.raises(ValueError, match="top level"):
        df.select((PS.explode(PS.col("xs")) + PS.col("id")).alias("bad"))
    with pytest.raises(ValueError, match="one explode"):
        df.select(PS.explode(PS.col("xs")), PS.explode(PS.col("xs")))
    with pytest.raises(ValueError, match="two columns"):
        df.select(PS.posexplode(PS.col("xs")).alias("p"))


def test_explode_of_a_non_array_is_an_analysis_error():
    t = pa.table({"x": pa.array([1], pa.int64())})
    with pytest.raises(TypeError, match="requires an array"):
        TorchSession(device="cpu").create_dataframe(t).select(
            PS.explode(PS.col("x")).alias("e"))


def test_generate_repeats_only_the_columns_read_above():
    """The exploded array, read by the generator alone, is not repeated
    a row per element (Spark's Generate drops unrequired child columns);
    an array the parent reads is."""
    from spark_rapids_tpu_torch.execs.generate import TpuGenerateExec

    t = LISTS.append_column("ys", LISTS.column("xs"))
    df = TorchSession(device="cpu").create_dataframe(t)
    for exprs, kept in (((PS.col("id"),), ["id"]),
                        ((PS.col("id"), PS.col("ys")), ["id", "ys"])):
        q = df.select(*exprs, PS.posexplode(PS.col("xs")))
        (gen,) = [n for n in q.physical_plan().walk()
                  if isinstance(n, TpuGenerateExec)]
        assert gen.schema.names == kept + ["pos", "col"]
        assert q.collect().column("pos").to_pylist() == [0, 1, 0, 0, 1, 2]
