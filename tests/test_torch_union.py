"""UNION ALL, the in-memory and range sources, ``with_column`` and the
numeric casts: the port against both JAX engines.

- ``DataFrame.union`` widens each column to the members' common type
  (INT < LONG < DOUBLE; a NULL column, here a NULL literal, takes the
  other's type) by a ``Cast`` over the member; names come from the
  first member, by position; pruning under the union goes by position
  too, so members whose names differ read the right columns.
- ``Cast`` among INT, LONG and DOUBLE with Spark's non-ANSI results (a
  LONG narrows to its low 32 bits, a DOUBLE truncates toward zero, NaN
  -> 0, out of range and +/-inf saturate), and from NULL.
- ``create_dataframe``, ``range`` and ``with_column``.
- A union under an aggregate, pooled, equals its serial run bit for bit.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.config import get_conf, set_conf
from spark_rapids_tpu.exprs.cast import Cast as JCast
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import count_star as jcount_star
from spark_rapids_tpu.session import lit as jlit
from spark_rapids_tpu.session import sum_ as jsum

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import session as P
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.execs.basic import TpuProjectExec, TpuUnionExec
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.io.scan import ArrowSourceExec, ParquetScanExec
from spark_rapids_tpu_torch.plan import logical as L

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
BATCH = "spark.rapids.tpu.sql.batchSizeRows"
N = 50


def _columns(seed: int) -> dict:
    """Seeded columns of every numeric type with NULLs, and strings."""
    rng = np.random.default_rng(seed)
    mask = rng.random(N) < 0.2
    return {
        "i": pa.array(rng.integers(-1000, 1000, N).astype(np.int32),
                      mask=mask),
        "l": pa.array(rng.integers(-(1 << 40), 1 << 40, N), mask=mask),
        "d": pa.array(rng.integers(-4000, 4000, N) / 4.0, mask=mask),
        "s": pa.array([f"w{x}" for x in rng.integers(0, 5, N)]),
    }


@pytest.fixture(scope="module")
def jax_conf():
    conf = get_conf()
    saved = dict(conf._values)
    yield conf
    conf._values.clear()
    conf._values.update(saved)
    set_conf(conf)


def _both(jax_conf, build, port_conf=None):
    """``build(session, col)`` in the port and in the JAX session: the
    port's table, and each JAX engine's."""
    port = build(TorchSession(port_conf or {}, device="cpu"),
                 P.col).collect()
    set_conf(jax_conf)
    jdf = build(TpuSession(jax_conf), jcol)
    return port, {e: jdf.collect(engine=e) for e in ("tpu", "cpu")}


#: (left column, right column) pairs of the widening matrix; "n" is a
#: NULL literal, which the JAX package cannot collect (ROADMAP §3)
PAIRS = [("i", "l"), ("l", "i"), ("i", "d"), ("d", "l"), ("l", "d"),
         ("i", "i")]
NULL_PAIRS = [("n", "i"), ("l", "n"), ("n", "d"), ("s", "n")]


def _member(s, c, cols, name, k):
    lit = P.lit if c is P.col else jlit
    df = s.create_dataframe(pa.table({"v": cols["l" if name == "n"
                                                else name],
                                      "k": cols["s"]}))
    return df.select((lit(None) if name == "n" else c("v")).alias("x"),
                     c("k").alias(k))


@pytest.mark.parametrize("left,right", PAIRS)
def test_union_widens_as_both_jax_engines_do(left, right, jax_conf):
    a, b = _columns(1), _columns(2)

    def build(s, c):
        return _member(s, c, a, left, "k").union(
            _member(s, c, b, right, "k2"))

    port, jax = _both(jax_conf, build)
    assert port.schema.names == ["x", "k"]
    assert port.num_rows == 2 * N
    for want in jax.values():
        assert port.schema.field("x").type == want.schema.field("x").type
        assert_tables_equal(port, want, ignore_order=False)


@pytest.mark.parametrize("left,right", NULL_PAIRS)
def test_a_null_member_takes_the_other_type(left, right):
    a, b = _columns(1), _columns(2)
    s = TorchSession(device="cpu")
    port = _member(s, P.col, a, left, "k").union(
        _member(s, P.col, b, right, "k2")).collect()
    other = right if left == "n" else left
    vals = (a if other == left else b)[other]
    nulls = pa.nulls(N, vals.type)
    want = pa.concat_arrays([vals, nulls] if other == left
                            else [nulls, vals])
    assert port.schema.names == ["x", "k"]
    assert port["x"].combine_chunks().equals(want)
    assert port["k"].to_pylist() == a["s"].to_pylist() + b["s"].to_pylist()


def test_union_of_no_common_type_raises():
    s = TorchSession(device="cpu")
    a = s.create_dataframe(pa.table({"x": pa.array([1])}))
    b = s.create_dataframe(pa.table({"x": pa.array(["a"])}))
    with pytest.raises(TypeError):
        a.union(b)
    with pytest.raises(TypeError):
        a.union(s.create_dataframe(pa.table({"x": [1], "y": [2]})))
    with pytest.raises(TypeError):
        L.Union([a._plan, b._plan])


@pytest.fixture(scope="module")
def member_files(tmp_path_factory):
    """Two tables of other names, three files each."""
    d = tmp_path_factory.mktemp("union")
    out = {"a": [], "b": []}
    for i in range(3):
        c = _columns(10 + i)
        pa_ = str(d / f"a-{i}.parquet")
        pq.write_table(pa.table({"ka": c["s"], "va": c["d"], "wa": c["i"],
                                 "pad": c["l"]}), pa_)
        out["a"].append(pa_)
        c = _columns(20 + i)
        pb = str(d / f"b-{i}.parquet")
        pq.write_table(pa.table({"pad_b": c["l"], "kb": c["s"],
                                 "vb": c["l"], "wb": c["i"]}), pb)
        out["b"].append(pb)
    return out


def _members(s, files, c):
    a = s.read_parquet(*files["a"]).select(c("ka"), c("va"), c("wa"))
    b = s.read_parquet(*files["b"]).select(c("kb"), c("vb"), c("wb"))
    return a.union(b)


def test_union_under_an_aggregate_matches_both_jax_engines(member_files,
                                                           jax_conf):
    jax_conf.set(TTB, 1)

    def build(s, c):
        agg = (jsum, jcount_star) if c is jcol else (P.sum_, P.count_star)
        return (_members(s, member_files, c).group_by(c("ka"))
                .agg((agg[0](c("va")), "sv"), (agg[0](c("wa")), "sw"),
                     (agg[1](), "n")))

    port, jax = _both(jax_conf, build, {TTB: 1})
    assert port.num_rows == 5
    for want in jax.values():
        assert_tables_equal(port, want)


def test_pruning_goes_by_position(member_files):
    s = TorchSession({TTB: 1}, device="cpu")
    a = s.read_parquet(*member_files["a"])
    b = s.read_parquet(*member_files["b"]).select(P.col("kb"), P.col("vb"),
                                                  P.col("wb"), P.col("pad_b"))
    plan = a.union(b).group_by(P.col("ka")).agg(
        (P.sum_(P.col("pad")), "sp")).physical_plan()
    [union] = [n for n in plan.walk() if isinstance(n, TpuUnionExec)]
    assert union.schema.names == ["ka", "pad"]
    assert union.num_partitions == 6
    left, right = union.children
    # the bare scan reads the kept positions; the member whose own
    # lowering kept more is projected to them
    assert isinstance(left, ParquetScanExec) and \
        left.schema.names == ["ka", "pad"]
    assert isinstance(right, TpuProjectExec) and \
        right.schema.names == ["kb", "pad_b"]
    [scan_b] = [n for n in right.walk() if isinstance(n, ParquetScanExec)]
    assert scan_b.schema.names == ["pad_b", "kb", "vb", "wb"]
    t = pa.concat_tables(
        [pq.read_table(p, columns=["ka", "pad"]) for p in member_files["a"]]
        + [pq.read_table(p, columns=["kb", "pad_b"])
           .rename_columns(["ka", "pad"]) for p in member_files["b"]])
    want = {r["ka"]: r["pad_sum"] for r in t.group_by("ka").aggregate(
        [("pad", "sum")]).to_pylist()}
    got = {r["ka"]: r["sp"] for r in a.union(b).group_by(P.col("ka")).agg(
        (P.sum_(P.col("pad")), "sp")).collect().to_pylist()}
    assert got == pytest.approx(want)


def test_a_member_with_a_name_twice_projects_by_position():
    s = TorchSession(device="cpu")
    t = pa.table({"x": pa.array([1, 2], pa.int32()),
                  "z": pa.array([10, 20], pa.int32())})
    twice = s.create_dataframe(t).select(P.col("x"), P.col("z"),
                                         P.col("x").alias("z2"))
    twice = twice.select(P.col("x"), P.col("z"), P.col("z2").alias("x"))
    other = s.create_dataframe(pa.table({"a": [5], "b": [6], "c": [7]}))
    out = twice.union(other).select(P.col("z")).collect()
    assert out["z"].to_pylist() == [10, 20, 6]
    got = twice.union(other).collect()
    assert got.schema.names == ["x", "z", "x"]
    assert [c.to_pylist() for c in got.columns] == [[1, 2, 5], [10, 20, 6],
                                                    [1, 2, 7]]


@pytest.mark.parametrize("src,dst", [("i", "l"), ("l", "i"), ("i", "d"),
                                     ("l", "d"), ("d", "i"), ("d", "l"),
                                     ("n", "s")])
def test_cast_matches_both_jax_engines(src, dst, jax_conf):
    dt = {"i": (T.INT, JT.INT), "l": (T.LONG, JT.LONG),
          "d": (T.DOUBLE, JT.DOUBLE), "s": (T.STRING, JT.STRING)}[dst]
    vals = _columns(3)["l" if src == "n" else src]
    if src == "d":
        vals = pa.array([1.9, -1.9, float("nan"), float("inf"),
                         -float("inf"), 3e9, -3e9, 1e19, -1e19, -0.0, None])
    elif src == "l":
        vals = pa.array([1, -1, (1 << 31) + 5, -(1 << 31) - 5, (1 << 53) + 1,
                         (1 << 63) - 1, None], pa.int64())

    def build(s, c):
        cast, lit = (JCast, jlit) if c is jcol else (Cast, P.lit)
        child = lit(None) if src == "n" else c("v")
        return s.create_dataframe(pa.table({"v": vals})).select(
            cast(child, dt[0 if c is P.col else 1]).alias("c"))

    port, jax = _both(jax_conf, build)
    assert port.num_rows == len(vals)
    for want in jax.values():
        assert_tables_equal(port, want, ignore_order=False)


@pytest.mark.parametrize("dst", [T.INT, T.LONG, T.DOUBLE, T.STRING])
def test_cast_from_null_is_all_null(dst):
    """The JAX package fails these but for STRING (ROADMAP §3)."""
    s = TorchSession(device="cpu")
    got = s.range(4).select(Cast(P.lit(None), dst).alias("c")).collect()
    assert got["c"].type == T.to_arrow_type(dst)
    assert got["c"].null_count == 4


@pytest.mark.parametrize("source", ["create_dataframe", "range"])
def test_sources_and_with_column_match_both_jax_engines(source, jax_conf):
    t = pa.table(_columns(4))

    def build(s, c):
        lit = jlit if c is jcol else P.lit
        if source == "range":
            return s.range(3, 3 + N).with_column("half", c("id") * lit(0.5))
        df = s.create_dataframe(t).with_column("i", c("i") * lit(3))
        return df.with_column("w", c("l") + c("i"))

    port, jax = _both(jax_conf, build, {BATCH: 16})
    assert port.num_rows == N
    assert port.schema.names == (["id", "half"] if source == "range"
                                 else ["l", "d", "s", "i", "w"])
    for want in jax.values():
        assert_tables_equal(port, want, ignore_order=False)


def test_sources_split_into_batches_of_the_batch_rows():
    s = TorchSession({BATCH: 16}, device="cpu")
    src = s.create_dataframe(pa.table({"x": list(range(40))}))
    [leaf] = list(src.physical_plan().walk())
    assert isinstance(leaf, ArrowSourceExec) and leaf.num_partitions == 3
    r = s.range(0, 40, 3).physical_plan()
    assert r.num_partitions == 1 and r.total == 14
    assert [b.num_rows for b in s.range(0, 40).physical_plan().execute()] \
        == [16, 16, 8]
    assert s.range(10, 0, -4).collect()["id"].to_pylist() == [10, 6, 2]
    assert s.range(5, 5).collect().num_rows == 0
    assert s.range(0).agg((P.count_star(), "n")).collect().to_pylist() == \
        [{"n": 0}]


def test_pooled_union_equals_serial_bit_for_bit(member_files):
    def run(conf):
        s = TorchSession({TTB: 1, **conf}, device="cpu")
        return (_members(s, member_files, P.col).group_by(P.col("wa"))
                .agg((P.sum_(P.col("va")), "s"), (P.first(P.col("va")), "f"))
                .collect())

    assert run({}).equals(run(C.SERIAL))


def test_estimates_sum_the_members_and_count_the_sources():
    s = TorchSession(device="cpu")
    a = s.create_dataframe(pa.table({"x": list(range(30))}))
    r = s.range(0, 100, 7)
    u = a.union(r)
    assert a._plan.estimated_rows() == 30
    assert r._plan.estimated_rows() == 15
    assert u._plan.estimated_rows() == 45
    assert L.RangeRel(10, 0, -3).estimated_rows() == 4
    from spark_rapids_tpu_torch.plan.cost import exec_estimated_rows

    assert exec_estimated_rows(u.physical_plan()) == 45
    # a union small enough is broadcast as a join's build side
    big = s.range(0, 1 << 20)
    plan = big.join(u, left_on=[P.col("id")], right_on=[P.col("x")])\
        .physical_plan()
    assert type(plan).__name__ == "TpuBroadcastHashJoinExec" and \
        plan.build_is_right


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
