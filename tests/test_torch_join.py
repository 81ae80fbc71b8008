"""Join parity: the port's ``ops/join.py`` against the JAX package's, on
the same numpy-seeded batches, pair for pair; then the port's join exec
through the session (exchanges, chunked output, empty sides) against
the JAX functions on the same rows.

A two-column key that leads with a DOUBLE is left out of the parity
cases: the JAX package sorts -0.0 strictly below 0.0 before it compares
adjacent rows, so (-0.0, "a") and (0.0, "a") end up apart when a
(-0.0, "b") sorts between them, and do not match.  The port ranks
grouping keys with -0.0 folded into 0.0 and matches them, as Spark
does; ``test_negative_zero_matches_zero_in_a_tuple`` holds it to that.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import column_to_numpy
from spark_rapids_tpu.ops import join as JJ

from spark_rapids_tpu_torch import TorchSession, col, lit, sum_
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import from_numpy_columns, to_arrow
from spark_rapids_tpu_torch.columnar.column import Column, StringColumn
from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
from spark_rapids_tpu_torch.execs.join import TpuShuffledHashJoinExec
from spark_rapids_tpu_torch.ops import join as J

#: kind -> (JAX type, port type)
KINDS = {"long": (JT.LONG, T.LONG), "int": (JT.INT, T.INT),
         "double": (JT.DOUBLE, T.DOUBLE), "string": (JT.STRING, T.STRING)}
WORDS = np.array(["", "a", "ab", "abc", "b", "ünï", "abcdefghij"],
                 dtype=object)
DOUBLES = np.array([-0.0, 0.0, np.nan, 1.5, -2.25, np.inf, -np.inf, 3.0])
#: (key kinds, ...) of the parity cases
KEYS = {"long": ["long"], "int": ["int"], "double": ["double"],
        "string": ["string"], "long_string": ["long", "string"]}
OPS_TYPES = ["inner", "left_outer", "full_outer", "left_semi", "left_anti"]
TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
CHUNK = "spark.rapids.tpu.sql.join.outputChunkRows"
#: -1 turns broadcast joins off: these small tables would broadcast
BCAST = "spark.rapids.tpu.sql.autoBroadcastJoinThresholdBytes"
ADAPTIVE = "spark.rapids.tpu.sql.adaptive.enabled"


def _values(kind, n, rng):
    if kind in ("long", "int"):
        return rng.integers(0, 25, n).astype(
            np.int64 if kind == "long" else np.int32)
    if kind == "double":
        return DOUBLES[rng.integers(0, len(DOUBLES), n)]
    return WORDS[rng.integers(0, len(WORDS), n)]


def _side(kinds, n, rng, prefix, null_share=0.15):
    """Key columns k0.. of ``kinds`` and a payload column, as numpy."""
    data = {f"{prefix}k{i}": _values(k, n, rng) for i, k in enumerate(kinds)}
    data[f"{prefix}v"] = rng.integers(-1000, 1000, n).astype(np.int64)
    validity = {c: rng.random(n) >= null_share for c in data}
    fields = [(f"{prefix}k{i}", *KINDS[k]) for i, k in enumerate(kinds)]
    fields.append((f"{prefix}v", JT.LONG, T.LONG))
    return data, validity, fields


def _both(data, validity, fields):
    """The same rows as a JAX batch and a port batch."""
    n = len(next(iter(data.values())))
    jschema = JT.Schema([JT.Field(f, jt) for f, jt, _ in fields])
    jb = JBatch.from_numpy(data, jschema, validity)
    host = {f: column_to_numpy(c, n) for (f, _, _), c in
            zip(fields, jb.columns)}
    pschema = T.Schema([T.Field(f, pt) for f, _, pt in fields])
    return jb, from_numpy_columns(host, pschema, "cpu")


def _canon(v):
    if isinstance(v, float) and np.isnan(v):
        return ("nan",)
    return v


def _rows(d: dict):
    return [tuple(_canon(v) for v in r) for r in zip(*d.values())]


def _jax_join(jbuild, jstream, n_keys, jt, n_b, n_s):
    """The JAX package's pairs and joined rows (stream ++ build)."""
    st = JJ.join_state(jbuild, jstream, jbuild.columns[:n_keys],
                       jstream.columns[:n_keys], jt)
    total = int(np.asarray(st.cnt_s).sum())
    s, b, live, m = JJ.expand_pairs(st, max(total, 1), 0)
    schema = JT.Schema(list(jstream.schema.fields)
                       + list(jbuild.schema.fields))
    out = JJ.gather_joined(jbuild, jstream, s, b, live, m, total, schema)
    return {"total": total, "s": np.asarray(s)[:total],
            "b": np.asarray(b)[:total], "m": np.asarray(m)[:total],
            "matched_s": np.asarray(st.matched_s)[:n_s],
            "matched_b": np.asarray(st.matched_b)[:n_b],
            "rows": _rows(out.to_pydict())}


def _port_join(build, stream, n_keys, jt):
    st = J.join_state(build.columns[:n_keys], stream.columns[:n_keys], jt)
    total = int(st.total)
    s, b, live, m = J.expand_pairs(st, total, 0)
    assert bool(live.all())
    schema = T.Schema(list(stream.schema.fields)
                      + list(build.schema.fields))
    out = J.gather_joined(build, stream, s, b, live, m, schema)
    return {"total": total, "s": s.numpy(), "b": b.numpy(),
            "m": m.numpy(), "matched_s": st.matched_s.numpy(),
            "matched_b": st.matched_b.numpy(),
            "rows": _rows(to_arrow(out).to_pydict())}


def _assert_same(got, want):
    assert got["total"] == want["total"]
    np.testing.assert_array_equal(got["s"], want["s"])
    np.testing.assert_array_equal(got["m"], want["m"])
    # a pair without a build match has no build row to compare
    np.testing.assert_array_equal(got["b"][got["m"]], want["b"][want["m"]])
    np.testing.assert_array_equal(got["matched_s"], want["matched_s"])
    np.testing.assert_array_equal(got["matched_b"], want["matched_b"])
    assert got["rows"] == want["rows"]


def _sides(kinds, n_b, n_s, seed):
    rng = np.random.default_rng(seed)
    jb, pb = _both(*_side(kinds, n_b, rng, "b_"))
    js, ps = _both(*_side(kinds, n_s, rng, "s_"))
    return jb, pb, js, ps


@pytest.mark.parametrize("keys", list(KEYS))
@pytest.mark.parametrize("jt", OPS_TYPES)
def test_join_ops_match_jax(keys, jt):
    kinds = KEYS[keys]
    jb, pb, js, ps = _sides(kinds, 300, 400, seed=len(keys) + len(jt))
    want = _jax_join(jb, js, len(kinds), jt, 300, 400)
    got = _port_join(pb, ps, len(kinds), jt)
    assert want["total"] > 100
    _assert_same(got, want)


@pytest.mark.parametrize("empty", ["build", "stream"])
@pytest.mark.parametrize("jt", OPS_TYPES)
def test_join_ops_with_an_empty_side_match_jax(empty, jt):
    n_b, n_s = (0, 50) if empty == "build" else (50, 0)
    jb, pb, js, ps = _sides(["long", "string"], n_b, n_s, seed=3)
    want = _jax_join(jb, js, 2, jt, n_b, n_s)
    got = _port_join(pb, ps, 2, jt)
    _assert_same(got, want)


def test_expand_pairs_windows_tile_the_whole_expansion():
    _, pb, _, ps = _sides(["int"], 200, 300, seed=11)
    st = J.join_state(pb.columns[:1], ps.columns[:1], "left_outer")
    total = int(st.total)
    whole = J.expand_pairs(st, total)
    parts = [J.expand_pairs(st, 97, off) for off in range(0, total, 97)]
    for i in (0, 1, 3):
        joined = torch.cat([p[i] for p in parts])
        assert torch.equal(joined[:total], whole[i])
    # the last window runs past the total: those pairs are not live
    assert int(parts[-1][2].sum()) == total - 97 * (len(parts) - 1)


def test_negative_zero_matches_zero_in_a_tuple():
    def side(d, s):
        n = len(d)
        ok = torch.ones(n, dtype=torch.bool)
        chars = torch.tensor([[ord(c)] for c in s], dtype=torch.uint8)
        return [Column(torch.tensor(d, dtype=torch.float64), ok, T.DOUBLE),
                StringColumn(chars, torch.ones(n, dtype=torch.int32), ok)]

    nan = float("nan")
    build = side([-0.0, -0.0, nan], "abc")
    stream = side([0.0, 0.0, nan, -0.0], "bacc")
    st = J.join_state(build, stream, "inner")
    assert st.cnt_s.tolist() == [1, 1, 1, 0]


def test_join_keys_of_different_types_compare_widened():
    ok = torch.ones(3, dtype=torch.bool)
    ints = Column(torch.tensor([1, 2, 3], dtype=torch.int32), ok, T.INT)
    longs = Column(torch.tensor([3, 1, 1 << 40]), ok, T.LONG)
    doubles = Column(torch.tensor([2.0, 2.5, 1.0], dtype=torch.float64), ok,
                     T.DOUBLE)
    assert J.join_state([ints], [longs], "inner").cnt_s.tolist() == [1, 1, 0]
    assert J.join_state([ints], [doubles], "inner").cnt_s.tolist() == \
        [1, 0, 1]
    strings = StringColumn(torch.zeros((3, 1), dtype=torch.uint8),
                           torch.zeros(3, dtype=torch.int32), ok)
    with pytest.raises(TypeError):
        J.join_state([ints], [strings], "inner")


# --------------------------------------------------------------------- #
# The exec, through the session
# --------------------------------------------------------------------- #


def _write(path, data, validity):
    t = pa.table({k: pa.array(v, mask=~validity[k])
                  for k, v in data.items()})
    pq.write_table(t, path)
    return str(path)


def _tables(tmp_path, seed, n_files=2, rows=150, kinds=("long", "string")):
    """Left (stream) and right (build) Parquet files, and the same rows
    as JAX batches."""
    rng = np.random.default_rng(seed)
    out = {}
    for side, prefix in (("left", "l_"), ("right", "r_")):
        paths, datas = [], []
        for i in range(n_files):
            data, validity, fields = _side(list(kinds), rows, rng, prefix)
            paths.append(_write(tmp_path / f"{side}{i}.parquet", data,
                                validity))
            datas.append((data, validity))
        data = {k: np.concatenate([d[k] for d, _ in datas]) for k in
                datas[0][0]}
        validity = {k: np.concatenate([v[k] for _, v in datas]) for k in
                    datas[0][1]}
        out[side] = (paths, _both(data, validity, fields)[0])
    return out


def _expected(jleft, jright, n_keys, jt):
    """Row multiset of a join through the JAX functions: left ++ right
    columns (right_outer builds the left side)."""
    if jt == "right_outer":
        st = JJ.join_state(jleft, jright, jleft.columns[:n_keys],
                           jright.columns[:n_keys], "left_outer")
        build, stream, first = jleft, jright, False
    else:
        st = JJ.join_state(jright, jleft, jright.columns[:n_keys],
                           jleft.columns[:n_keys], jt)
        build, stream, first = jright, jleft, True
    if jt in ("left_semi", "left_anti"):
        keep = st.matched_s if jt == "left_semi" \
            else st.live_s & ~st.matched_s
        n = int(np.asarray(keep).sum())
        return sorted(_rows(jleft.compact(keep).to_pydict()), key=repr), n
    total = int(np.asarray(st.cnt_s).sum())
    s, b, live, m = JJ.expand_pairs(st, max(total, 1), 0)
    schema = JT.Schema(list(jleft.schema.fields)
                       + list(jright.schema.fields))
    out = JJ.gather_joined(build, stream, s, b, live, m, total, schema,
                           stream_first=first)
    rows = _rows(out.to_pydict())
    if jt == "full_outer":
        unmatched = jright.compact(jright.row_mask() & ~st.matched_b)
        n_left = len(jleft.schema.fields)
        rows += [(None,) * n_left + r for r in _rows(unmatched.to_pydict())]
    return sorted(rows, key=repr), len(rows)


JOIN_TYPES = ["inner", "left_outer", "right_outer", "full_outer",
              "left_semi", "left_anti"]


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_partition_wise_join_through_the_session(tmp_path, jt):
    # the static plan; the adaptive join's case is the test below
    t = _tables(tmp_path, seed=len(jt))
    s = TorchSession({TTB: 1, BCAST: -1, ADAPTIVE: False}, device="cpu")
    left = s.read_parquet(*t["left"][0])
    right = s.read_parquet(*t["right"][0])
    df = left.join(right, how=jt, left_on=[col("l_k0"), col("l_k1")],
                   right_on=[col("r_k0"), col("r_k1")])
    plan = df.physical_plan()
    assert isinstance(plan, TpuShuffledHashJoinExec) and plan.partition_wise
    assert all(isinstance(c, TpuShuffleExchangeExec) for c in plan.children)
    got = sorted(_rows(df.collect().to_pydict()), key=repr)
    want, n = _expected(t["left"][1], t["right"][1], 2, jt)
    assert n > 0 and got == want


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_adaptive_join_through_the_session(tmp_path, jt):
    """The default plan: a TpuAdaptiveJoinExec over two exchanges, which
    with broadcast off decides on a shuffled join and gives the same
    rows."""
    from spark_rapids_tpu_torch.execs.adaptive import TpuAdaptiveJoinExec
    from spark_rapids_tpu_torch.plan.planner import collect_exec

    t = _tables(tmp_path, seed=len(jt))
    s = TorchSession({TTB: 1, BCAST: -1}, device="cpu")
    df = s.read_parquet(*t["left"][0]).join(
        s.read_parquet(*t["right"][0]), how=jt,
        left_on=[col("l_k0"), col("l_k1")],
        right_on=[col("r_k0"), col("r_k1")])
    plan = df.physical_plan()
    assert isinstance(plan, TpuAdaptiveJoinExec)
    assert plan.decision == "undecided"
    assert all(isinstance(c, TpuShuffleExchangeExec) for c in plan.children)
    got = sorted(_rows(collect_exec(plan, s.conf).to_pydict()), key=repr)
    assert plan.decision.startswith("shuffled"), plan.decision
    want, n = _expected(t["left"][1], t["right"][1], 2, jt)
    assert n > 0 and got == want


@pytest.mark.parametrize("jt", JOIN_TYPES)
@pytest.mark.parametrize("empty", ["left", "right"])
def test_join_with_a_side_filtered_empty(tmp_path, jt, empty):
    t = _tables(tmp_path, seed=5, n_files=1)
    s = TorchSession({BCAST: -1}, device="cpu")
    left = s.read_parquet(*t["left"][0])
    right = s.read_parquet(*t["right"][0])
    if empty == "left":
        left = left.where(col("l_v") > lit(5000))
        jleft = JBatch.empty(t["left"][1].schema)
        jright = t["right"][1]
    else:
        right = right.where(col("r_v") > lit(5000))
        jleft, jright = t["left"][1], JBatch.empty(t["right"][1].schema)
    df = left.join(right, how=jt, left_on=[col("l_k0"), col("l_k1")],
                   right_on=[col("r_k0"), col("r_k1")])
    assert not df.physical_plan().partition_wise  # one partition a side
    got = sorted(_rows(df.collect().to_pydict()), key=repr)
    want, _ = _expected(jleft, jright, 2, jt)
    assert got == want


def test_skewed_key_comes_out_in_bounded_chunks(tmp_path):
    rng = np.random.default_rng(9)
    # the build key 7 repeats 1000 times; the stream holds it 5 times
    rk = np.concatenate([np.full(1000, 7), rng.integers(0, 50, 200)])
    lk = np.concatenate([np.full(5, 7), rng.integers(0, 50, 300)])
    rng.shuffle(rk)
    rng.shuffle(lk)
    left = {"l_k0": lk.astype(np.int64),
            "l_v": rng.integers(0, 100, len(lk)).astype(np.int64)}
    right = {"r_k0": rk.astype(np.int64),
             "r_v": rng.integers(0, 100, len(rk)).astype(np.int64)}
    lvalid = {k: np.ones(len(lk), bool) for k in left}
    rvalid = {k: np.ones(len(rk), bool) for k in right}
    lf = [("l_k0", JT.LONG, T.LONG), ("l_v", JT.LONG, T.LONG)]
    rf = [("r_k0", JT.LONG, T.LONG), ("r_v", JT.LONG, T.LONG)]
    jleft, jright = _both(left, lvalid, lf)[0], _both(right, rvalid, rf)[0]
    want = _jax_join(jright, jleft, 1, "inner", len(rk), len(lk))
    assert want["total"] > 5000

    s = TorchSession({CHUNK: 700, BCAST: -1}, device="cpu")
    df = s.read_parquet(_write(tmp_path / "l.parquet", left, lvalid)).join(
        s.read_parquet(_write(tmp_path / "r.parquet", right, rvalid)),
        left_on=[col("l_k0")], right_on=[col("r_k0")])
    plan = df.physical_plan()
    batches = list(plan.execute())
    assert len(batches) == -(-want["total"] // 700)
    assert all(b.num_rows <= 700 for b in batches)
    rows = [r for b in batches for r in _rows(to_arrow(b).to_pydict())]
    assert rows == want["rows"]  # chunks in order: the JAX pair order


def test_join_on_an_aggregate_reuses_its_exchange(tmp_path):
    t = _tables(tmp_path, seed=2)
    s = TorchSession({TTB: 1, BCAST: -1}, device="cpu")
    agg = (s.read_parquet(*t["left"][0])
           .group_by(col("l_k0")).agg((sum_(col("l_v")), "n")))
    right = s.read_parquet(*t["right"][0])
    df = agg.join(right, left_on=[col("l_k0")], right_on=[col("r_k0")])
    plan = df.physical_plan()
    lchild, rchild = plan.children
    assert plan.partition_wise
    assert not isinstance(lchild, TpuShuffleExchangeExec)  # reused
    assert isinstance(rchild, TpuShuffleExchangeExec)
    assert rchild.num_partitions == lchild.num_partitions
    # one partition a side: a wide join
    one = TorchSession({BCAST: -1}, device="cpu")
    wide = (one.read_parquet(*t["left"][0])
            .group_by(col("l_k0")).agg((sum_(col("l_v")), "n"))
            .join(one.read_parquet(*t["right"][0]),
                  left_on=[col("l_k0")], right_on=[col("r_k0")]))
    assert not wide.physical_plan().partition_wise
    assert sorted(_rows(df.collect().to_pydict()), key=repr) == \
        sorted(_rows(wide.collect().to_pydict()), key=repr)


def test_keys_of_other_types_take_the_wide_join(tmp_path):
    a = _write(tmp_path / "a.parquet",
               {"x": np.array([1, 2, 2, 5], np.int32)},
               {"x": np.ones(4, bool)})
    b = _write(tmp_path / "b.parquet",
               {"y": np.array([2, 5, 9], np.int64)}, {"y": np.ones(3, bool)})
    s = TorchSession({TTB: 1, BCAST: -1}, device="cpu")
    left = s.read_parquet(a, a)
    df = left.join(s.read_parquet(b), left_on=[col("x")],
                   right_on=[col("y")])
    plan = df.physical_plan()
    assert not plan.partition_wise
    assert not any(isinstance(n, TpuShuffleExchangeExec)
                   for n in plan.walk())
    assert sorted(df.collect().to_pylist(), key=repr) == sorted(
        [{"x": 2, "y": 2}] * 4 + [{"x": 5, "y": 5}] * 2, key=repr)


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
