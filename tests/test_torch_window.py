"""Window functions: the port's ``ops/window.py`` against the JAX
package's functions, and ``TpuWindowExec`` against both JAX engines.

The ops run on the same numpy-seeded inputs: the JAX function with an
all-live mask and capacity = rows, the port's on the live rows.
Integers and positions must be equal; floats within rel 1e-12.

The exec tests run one select with many window columns through
``TpuSession`` (its TPU engine on the JAX CPU backend, and its CPU
oracle) and through the port, on one Parquet file and on the same rows
split over three files (``scan.taskTargetBytes`` = 1: a hash exchange
on the partition keys under a per-partition window).  Window output
order is unspecified, so the tables compare as sorted rows.  Summed
values are multiples of 0.25 and small, so every sum is exact whatever
the order the engines add in.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.exprs import window as JWX
from spark_rapids_tpu.ops import window as JW
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import avg as javg
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import count as jcount
from spark_rapids_tpu.session import count_star as jcount_star
from spark_rapids_tpu.session import lit as jlit
from spark_rapids_tpu.session import max_ as jmax
from spark_rapids_tpu.session import min_ as jmin
from spark_rapids_tpu.session import sum_ as jsum

import spark_rapids_tpu_torch as P
from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
from spark_rapids_tpu_torch.execs.window import TpuWindowExec
from spark_rapids_tpu_torch.ops import sort as S
from spark_rapids_tpu_torch.ops import window as W

N = 97
REL = 1e-12


def _starts(rng, n=N, p=0.15):
    s = rng.random(n) < p
    s[0] = True
    return s


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _j(a):
    return jnp.asarray(np.asarray(a))


def _live(n=N):
    return jnp.ones((n,), bool)


def _assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def _positions(rng):
    s = _starts(rng)
    start, end = W.segment_positions(_t(s))
    return s, start, end


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_positions_match_jax(seed):
    s = _starts(np.random.default_rng(seed))
    got = W.segment_positions(_t(s))
    want = JW.segment_positions(_j(s), _live())
    for g, w in zip(got, want):
        _assert_close(g, w)


def test_prefix_at_and_range_sum_match_jax():
    rng = np.random.default_rng(3)
    c = np.cumsum(rng.integers(-9, 9, N))
    lo = rng.integers(-1, N, N)
    hi = rng.integers(-1, N, N)
    _assert_close(W.prefix_at(_t(c), _t(lo)), JW.prefix_at(_j(c), _j(lo)))
    _assert_close(W.range_sum(_t(c), _t(lo), _t(hi)),
                  JW.range_sum(_j(c), _j(lo), _j(hi)))


FRAMES = [(None, 0), (-3, 0), (0, 2), (-2, -1), (1, 3), (None, None),
          (-1, None), (None, -2)]


@pytest.mark.parametrize("lo_off,hi_off", FRAMES)
def test_frame_bounds_match_jax(lo_off, hi_off):
    s, start, end = _positions(np.random.default_rng(4))
    got = W.frame_bounds(start, end, lo_off, hi_off)
    want = JW.frame_bounds(_j(start.numpy().astype(np.int32)),
                           _j(end.numpy().astype(np.int32)), lo_off, hi_off,
                           N)
    for g, w in zip(got, want):
        _assert_close(g, w)


def _value_columns(rng, kind):
    valid = rng.random(N) >= 0.2
    if kind == "long":
        data = rng.integers(-50, 50, N).astype(np.int64)
        return (Column(_t(data), _t(valid), T.LONG),
                JColumn(_j(data), _j(valid), JT.LONG))
    data = rng.integers(-200, 200, N) / 4.0
    return (Column(_t(data), _t(valid), T.DOUBLE),
            JColumn(_j(data), _j(valid), JT.DOUBLE))


@pytest.mark.parametrize("kind", ["long", "double"])
@pytest.mark.parametrize("lo_off,hi_off", FRAMES[:5])
def test_windowed_sum_count_match_jax(kind, lo_off, hi_off):
    rng = np.random.default_rng(5)
    s, start, end = _positions(rng)
    pc, jc = _value_columns(rng, kind)
    lo, hi = W.frame_bounds(start, end, lo_off, hi_off)
    out = T.LONG if kind == "long" else T.DOUBLE
    jout = JT.LONG if kind == "long" else JT.DOUBLE
    got = W.windowed_sum_count(pc, lo, hi, out)
    want = JW.windowed_sum_count(jc, _j(lo.numpy()), _j(hi.numpy()),
                                 _live(), jout)
    for g, w in zip(got, want):
        _assert_close(g, w)


def _special_doubles(rng):
    x = rng.integers(-20, 20, N) / 2.0
    pick = rng.random(N)
    x[pick < 0.1] = np.nan
    x[(pick >= 0.1) & (pick < 0.15)] = -0.0
    x[(pick >= 0.15) & (pick < 0.18)] = np.inf
    return x


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("kind", ["long", "double"])
def test_segmented_cummin_cummax_match_jax(op, kind):
    rng = np.random.default_rng(6)
    s = _starts(rng)
    vals = rng.integers(-1000, 1000, N) if kind == "long" \
        else _special_doubles(rng)
    got = W.segmented_cummin_cummax(_t(vals), _t(s), op)
    want = JW.segmented_cummin_cummax(_j(vals), _j(s), op)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("lo_off,hi_off,anchored", [
    (None, 0, True), (None, -1, True), (None, 2, True), (None, None, True),
    (0, None, False), (-2, None, False), (1, None, False)])
def test_windowed_minmax_match_jax(op, lo_off, hi_off, anchored):
    rng = np.random.default_rng(7)
    s, start, end = _positions(rng)
    x = _special_doubles(rng)
    x[:6] = np.nan  # a frame of NaN only: MIN is NaN
    valid = rng.random(N) >= 0.2
    lo, hi = W.frame_bounds(start, end, lo_off, hi_off)
    got, gok = W.windowed_minmax(Column(_t(x), _t(valid), T.DOUBLE), op,
                                 _t(s), lo, hi, anchored)
    want, wok = JW.windowed_minmax(
        JColumn(_j(x), _j(valid), JT.DOUBLE), op, _j(s), _live(),
        _j(lo.numpy().astype(np.int32)), _j(hi.numpy().astype(np.int32)),
        anchored, N)
    wok = np.asarray(wok)
    np.testing.assert_array_equal(gok.numpy(), wok)
    np.testing.assert_array_equal(got.numpy()[wok], np.asarray(want)[wok])


@pytest.mark.parametrize("offset", [-2, -1, 1, 3])
def test_gather_in_segment_matches_jax(offset):
    rng = np.random.default_rng(8)
    s, start, end = _positions(rng)
    pc, jc = _value_columns(rng, "long")
    g, ok = W.gather_in_segment(pc, offset, start, end)
    jg, jok = JW.gather_in_segment(
        jc, offset, _j(start.numpy().astype(np.int32)),
        _j(end.numpy().astype(np.int32)), _live(), N)
    jok = np.asarray(jok)
    np.testing.assert_array_equal(ok.numpy(), jok)
    want_valid = np.asarray(jg.validity) & jok
    np.testing.assert_array_equal(g.validity.numpy(), want_valid)
    np.testing.assert_array_equal(g.data.numpy()[want_valid],
                                  np.asarray(jg.data)[want_valid])


def _sorted_segments(rng, kind, descending):
    """Segments of order keys laid out as the window sort leaves them
    (the port's sort; NULLs first ascending and last descending, NaN the
    largest value), with the peer starts where the key changes."""
    s = _starts(rng, p=0.1)
    seg = Column(_t(np.cumsum(s) - 1), torch.ones(N, dtype=torch.bool),
                 T.LONG)
    if kind == "long":
        x = rng.integers(-6, 6, N).astype(np.int64)
    else:
        x = rng.integers(-8, 8, N) / 2.0
        x[rng.random(N) < 0.1] = np.nan
        x[rng.random(N) < 0.05] = np.inf
    valid = rng.random(N) >= 0.15
    xcol = Column(_t(x), _t(valid), T.LONG if kind == "long" else T.DOUBLE)
    perm = S.lexsort(S.column_sort_keys(seg) + S.column_sort_keys(
        xcol, descending, nulls_last=descending))
    peer = S.group_starts(S.column_sort_keys(seg, grouping=True)
                          + S.column_sort_keys(xcol, grouping=True), perm)
    return s, x[perm.numpy()], valid[perm.numpy()], peer.numpy()


@pytest.mark.parametrize("kind", ["long", "double"])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("fstart,fend", [(-2, 1), (None, 3), (-3, None),
                                         (1, 2), (-2, -1)])
def test_range_frame_bounds_match_jax(kind, descending, fstart, fend):
    rng = np.random.default_rng(9)
    s, x, valid, peer = _sorted_segments(rng, kind, descending)
    start, end = W.segment_positions(_t(s))
    _, peer_end = W.segment_positions(_t(peer))
    ptype, jtype = (T.LONG, JT.LONG) if kind == "long" \
        else (T.DOUBLE, JT.DOUBLE)
    got = W.range_frame_bounds(Column(_t(x), _t(valid), ptype), descending,
                               not descending, fstart, fend, start, end,
                               _t(peer), peer_end)
    i32 = [_j(t.numpy().astype(np.int32)) for t in (start, end, peer_end)]
    want = JW.range_frame_bounds(
        JColumn(_j(x), _j(valid), jtype), descending, not descending,
        fstart, fend, i32[0], i32[1], _j(peer), i32[2], _live(), N)
    for g, w in zip(got, want):
        _assert_close(g, w)


@pytest.mark.parametrize("side", ["left", "right"])
def test_bounded_bisect_matches_jax(side):
    rng = np.random.default_rng(10)
    s = _starts(rng, p=0.1)
    seg = np.cumsum(s) - 1
    keys = np.sort(rng.integers(0, 30, N) + seg * 100)
    start, end = W.segment_positions(_t(s))
    targets = keys + rng.integers(-3, 4, N)
    got = W.bounded_bisect(_t(keys), _t(targets), start, end, side)
    want = JW.bounded_bisect(_j(keys), _j(targets),
                             _j(start.numpy().astype(np.int32)),
                             _j(end.numpy().astype(np.int32)), side, N)
    _assert_close(got, want)


# ---------------------------------------------------------------------- #
# TpuWindowExec against both JAX engines
# ---------------------------------------------------------------------- #

WORDS = ["", "a", "ab", "b", "ünï", "zz"]
ROWS = 240


def _table(seed=11):
    rng = np.random.default_rng(seed)
    n = ROWS
    o = rng.integers(-3, 4, n) / 2.0
    pick = rng.random(n)
    o[pick < 0.08] = np.nan
    o[(pick >= 0.08) & (pick < 0.14)] = -0.0
    o[(pick >= 0.14) & (pick < 0.17)] = np.inf
    return pa.table({
        "k": pa.array(rng.integers(0, 6, n), pa.int64(),
                      mask=rng.random(n) < 0.1),
        "s": pa.array([WORDS[i] for i in rng.integers(0, len(WORDS), n)],
                      pa.string(), mask=rng.random(n) < 0.1),
        "ts": pa.array(rng.permutation(n).astype(np.int64)),
        "g": pa.array(rng.integers(0, 8, n).astype(np.int32), pa.int32(),
                      mask=rng.random(n) < 0.1),
        "o": pa.array(o, pa.float64(), mask=rng.random(n) < 0.1),
        "v": pa.array(rng.integers(-200, 200, n) / 4.0, pa.float64(),
                      mask=rng.random(n) < 0.15),
        "i": pa.array(rng.integers(-50, 50, n).astype(np.int32), pa.int32(),
                      mask=rng.random(n) < 0.15),
    })


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("window")
    t = _table()
    one = str(d / "one.parquet")
    pq.write_table(t, one)
    split = []
    for i, (a, b) in enumerate([(0, 80), (80, 170), (170, ROWS)]):
        split.append(str(d / f"part{i}.parquet"))
        pq.write_table(t.slice(a, b - a), split[-1])
    return one, split


class _Api:
    """One window query written once for either engine's DSL."""

    def __init__(self, m):
        self.__dict__.update(m)


JAX = _Api(dict(Window=JWX.Window, rank=JWX.rank, dense_rank=JWX.dense_rank,
                row_number=JWX.row_number, lead=JWX.lead, lag=JWX.lag,
                col=jcol, lit=jlit, sum_=jsum, count=jcount,
                count_star=jcount_star, avg=javg, min_=jmin, max_=jmax))
PORT = _Api(dict(Window=P.Window, rank=P.rank, dense_rank=P.dense_rank,
                 row_number=P.row_number, lead=P.lead, lag=P.lag,
                 col=P.col, lit=P.lit, sum_=P.sum_, count=P.count,
                 count_star=P.count_star, avg=P.avg, min_=P.min_,
                 max_=P.max_))


def q_ranking(df, a):
    W_ = a.Window
    asc = W_.partition_by("k").order_by("o")
    desc = W_.partition_by("k").order_by("o", desc=True)
    uniq = W_.partition_by("k").order_by("g", "ts")
    return df.select("k", "ts", "o",
                     a.rank().over(asc).alias("r"),
                     a.dense_rank().over(asc).alias("dr"),
                     a.rank().over(desc).alias("r_desc"),
                     a.dense_rank().over(desc).alias("dr_desc"),
                     a.row_number().over(uniq).alias("rn"))


def q_offsets(df, a):
    w = a.Window.partition_by("k").order_by("ts")
    return df.select("k", "ts", "v",
                     a.lead("v").over(w).alias("nxt"),
                     a.lag("v", 2).over(w).alias("prev2"),
                     a.lead("v", 1, a.col("v")).over(w).alias("nxt_dflt"),
                     a.lag("i", 3, a.col("i")).over(w).alias("i_dflt"),
                     a.lead("s", 2).over(w).alias("s_next2"))


def q_rows_frames(df, a):
    W_ = a.Window
    back = W_.partition_by("k").order_by("ts").rows_between(-3, 0)
    fwd = W_.partition_by("k").order_by("ts").rows_between(0, 2)
    prior = W_.partition_by("k").order_by("ts").rows_between(-2, -1)
    run = W_.partition_by("k").order_by("ts").rows_between(None, 0)
    rest = W_.partition_by("k").order_by("ts").rows_between(1, None)
    return df.select(
        "k", "ts", "v", "i",
        a.sum_("v").over(back).alias("s3"),
        a.count("v").over(back).alias("c3"),
        a.count_star().over(fwd).alias("cs_fwd"),
        a.avg("v").over(fwd).alias("a_fwd"),
        a.sum_("i").over(prior).alias("i_prior"),
        a.min_("v").over(run).alias("run_min"),
        a.max_("i").over(run).alias("run_max"),
        a.min_("i").over(rest).alias("rest_min"),
        a.max_("v").over(rest).alias("rest_max"))


def q_range_frames(df, a):
    W_ = a.Window
    running = W_.partition_by("k").order_by("o")
    whole = W_.partition_by("k")
    bounded = W_.partition_by("k").order_by("g").range_between(-2, 1)
    bounded_desc = W_.partition_by("k").order_by(
        "g", desc=True).range_between(-1, 3)
    # over "o" the CPU oracle would leave the NaN keys (Spark's largest
    # value) out of [v, unbounded following]; both other engines keep
    # them, as Spark does
    tail = W_.partition_by("k").order_by("g").range_between(0, None)
    return df.select(
        "k", "ts", "o", "g", "v",
        a.sum_("v").over(running).alias("rsum"),
        a.count("v").over(running).alias("rcnt"),
        a.max_("v").over(running).alias("rmax"),
        a.sum_("v").over(whole).alias("total"),
        a.avg("v").over(whole).alias("mean"),
        a.min_("o").over(whole).alias("omin"),
        a.max_("o").over(whole).alias("omax"),
        a.sum_("v").over(bounded).alias("bsum"),
        a.count_star().over(bounded).alias("bcnt"),
        a.sum_("i").over(bounded_desc).alias("bdsum"),
        a.avg("v").over(tail).alias("tavg"))


def q_keys(df, a):
    W_ = a.Window
    by_s = W_.partition_by("s").order_by("ts")
    by_ks = W_.partition_by("k", "s").order_by("v", desc=True)
    single = W_.partition_by("ts").order_by("v")
    return df.select(
        "k", "s", "ts", "v",
        a.row_number().over(by_s).alias("rn_s"),
        a.sum_("v").over(by_s).alias("sum_s"),
        a.rank().over(by_ks).alias("r_ks"),
        a.sum_("i").over(by_ks).alias("si_ks"),
        a.row_number().over(single).alias("rn_1"),
        a.lead("v").over(single).alias("lead_1"),
        a.sum_("v").over(single).alias("sum_1"))


def q_empty(df, a):
    w = a.Window.partition_by("k").order_by("ts")
    return df.where(a.col("ts") < a.lit(-1)).select(
        "k", "ts", a.rank().over(w).alias("r"),
        a.sum_("v").over(w).alias("s"))


QUERIES = [q_ranking, q_offsets, q_rows_frames, q_range_frames, q_keys,
           q_empty]


def _port_tables(files, query):
    one, split = files
    plain = TorchSession(device="cpu")
    spread = TorchSession({"spark.rapids.tpu.sql.scan.taskTargetBytes": 1},
                          device="cpu")
    return [query(plain.read_parquet(one), PORT),
            query(spread.read_parquet(*split), PORT)]


@pytest.mark.parametrize("query", QUERIES, ids=lambda q: q.__name__)
def test_window_exec_matches_both_jax_engines(files, query):
    jdf = query(TpuSession().read_parquet(files[0]), JAX)
    want = {e: jdf.collect(engine=e) for e in ("tpu", "cpu")}
    plain, spread = _port_tables(files, query)
    assert isinstance(plain.physical_plan().children[0], TpuWindowExec)
    windows = [n for n in spread.physical_plan().walk()
               if isinstance(n, TpuWindowExec)]
    assert windows and all(w.partitioned for w in windows)
    assert all(isinstance(w.children[0], TpuShuffleExchangeExec)
               for w in windows)
    for df in (plain, spread):
        got = df.collect()
        for engine, table in want.items():
            assert_tables_equal(got, table, ignore_order=True), engine


def test_negative_zero_orders_below_zero_as_the_jax_engine_does(files):
    """Under a second order key, the JAX engine (and the port's sort,
    held to JAX's ``sort_permutation``) orders -0.0 strictly below 0.0;
    Spark's ``compareDoubles`` and the CPU oracle tie them and let the
    next key decide (ROADMAP §3).  The port follows the JAX engine."""
    def query(df, a):
        w = a.Window.partition_by("k").order_by("o", "ts")
        return df.select("k", "ts", "o", a.row_number().over(w).alias("rn"))

    got = query(TorchSession(device="cpu").read_parquet(files[0]),
                PORT).collect()
    jdf = query(TpuSession().read_parquet(files[0]), JAX)
    assert_tables_equal(got, jdf.collect(engine="tpu"), ignore_order=True)
    zeros = sorted((-1 if r["k"] is None else r["k"], r["rn"],
                    np.copysign(1, r["o"]))
                   for r in got.to_pylist()
                   if r["o"] is not None and r["o"] == 0)
    for (k0, _, s0), (k1, _, s1) in zip(zeros, zeros[1:]):
        assert k0 != k1 or s0 <= s1  # -0.0 rows first in each partition


def test_two_specs_give_two_window_nodes(files):
    df = q_offsets(TorchSession(device="cpu").read_parquet(files[0]), PORT)
    assert sum(isinstance(n, TpuWindowExec)
               for n in df.physical_plan().walk()) == 1
    df = q_keys(TorchSession(device="cpu").read_parquet(files[0]), PORT)
    assert sum(isinstance(n, TpuWindowExec)
               for n in df.physical_plan().walk()) == 3


def test_frame_sum_keeps_nan_and_inf_in_their_frames(tmp_path):
    """A NaN or inf reaches only the frames that hold it, as Spark's
    direct sum gives (the CPU oracle).  The JAX package sums a frame as
    a difference of prefix sums over the whole batch, so the NaN of one
    partition turns every later partition's sums NaN (ROADMAP §3)."""
    t = pa.table({"k": pa.array([1, 1, 1, 2, 2, 2], pa.int64()),
                  "ts": pa.array([0, 1, 2, 3, 4, 5], pa.int64()),
                  "v": pa.array([1.0, np.nan, 2.0, np.inf, 3.0, 4.0])})
    path = str(tmp_path / "t.parquet")
    pq.write_table(t, path)

    def query(df, a):
        w = a.Window.partition_by("k").order_by("ts").rows_between(0, 1)
        return df.select("k", "ts", a.sum_("v").over(w).alias("s"))

    got = query(TorchSession(device="cpu").read_parquet(path),
                PORT).collect()
    jdf = query(TpuSession().read_parquet(path), JAX)
    assert_tables_equal(got, jdf.collect(engine="cpu"), ignore_order=True)
    rows = sorted((r["ts"], r["s"]) for r in got.to_pylist())
    s = [v for _, v in rows]
    assert np.isnan(s[0]) and np.isnan(s[1]) and s[2] == 2.0
    assert s[3] == np.inf and s[4:] == [7.0, 4.0]
    jax_tpu = sorted((r["ts"], r["s"])
                     for r in jdf.collect(engine="tpu").to_pylist())
    assert any(np.isnan(v) for _, v in jax_tpu[3:])


def test_ranking_without_order_by_is_an_analysis_error():
    with pytest.raises(ValueError):
        P.rank().over(P.Window.partition_by("k"))
    with pytest.raises(ValueError):
        P.lead("v").over(P.Window.partition_by("k"))


def test_unported_windows_raise_when_planned(files):
    df = TorchSession(device="cpu").read_parquet(files[0])
    both = P.Window.partition_by("k").order_by("ts").rows_between(-1, 1)
    with pytest.raises(NotImplementedError):
        df.select(P.min_("v").over(both).alias("m")).physical_plan()
    two_keys = P.Window.partition_by("k").order_by(
        "ts", "g").range_between(-1, 1)
    with pytest.raises(NotImplementedError):
        df.select(P.sum_("v").over(two_keys).alias("m")).physical_plan()
    # a group-by min runs since min / max joined the group-by; over a
    # string it is still not ported
    with pytest.raises(NotImplementedError):
        df.group_by(P.col("k")).agg((P.min_("s"), "m")).physical_plan()
