"""Expand, and rollup / cube / grouping sets built on it: the port
against the JAX package.

- ``DataFrame.rollup / cube / grouping_sets`` over STRING and LONG keys
  with NULLs of their own (so a key NULL in the data and one a set
  dropped meet in one output), through three scan tasks and the hash
  exchange, against both JAX engines.  No key ends in a NUL byte: the
  JAX engine sorts "a\\0" level with "a" and then groups them wrongly
  (ROADMAP §3).  Values are multiples of 1/4, so every sum is exact in
  any order.
- ``TpuExpandExec`` on one batch: rows x projections, projection after
  projection; a string NULL slot is zeroed chars, length 0 and invalid,
  a fixed-width one zeroed and invalid; no dictionary sidecar leaves
  it, so the group-by above takes the sort path; and the columns it
  reads are the only ones the scan decodes.
- K1's bits for the expanded key tuple, NULLs where a set drops a key,
  against the JAX package's ``exprs/hashing`` (a NULL leaves the
  running seed unchanged in both).
- ``Literal(None, dtype)`` is a typed all-NULL column of every type.
- A rollup pooled equals it serial, bit for bit.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.columnar.column import StringColumn as JStringColumn
from spark_rapids_tpu.config import get_conf, set_conf
from spark_rapids_tpu.exprs import hashing as JH
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import avg as javg
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import count as jcount
from spark_rapids_tpu.session import count_star as jcount_star
from spark_rapids_tpu.session import max_ as jmax
from spark_rapids_tpu.session import min_ as jmin
from spark_rapids_tpu.session import sum_ as jsum

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import session as P
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import from_arrow, to_arrow
from spark_rapids_tpu_torch.columnar.column import StringColumn
from spark_rapids_tpu_torch.execs.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.execs.expand import TpuExpandExec
from spark_rapids_tpu_torch.exprs import hashing as H
from spark_rapids_tpu_torch.exprs.base import (
    EvalContext,
    Literal,
    col,
)
from spark_rapids_tpu_torch.io.scan import ParquetScanExec
from spark_rapids_tpu_torch.ops import groupby as G

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
WORDS = ["", "a", "bb", "ünï", "x" * 20]


def _table(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)

    def nulls(p=0.15):
        return rng.random(n) < p

    return pa.table({
        "s": pa.array([WORDS[i] for i in rng.integers(0, len(WORDS), n)],
                      mask=nulls()),
        "l": pa.array(rng.integers(0, 4, n).astype(np.int64), mask=nulls()),
        "s2": pa.array([WORDS[i] for i in rng.integers(0, 3, n)],
                       mask=nulls(0.05)),
        "v": pa.array(rng.integers(-400, 400, n) / 4.0, mask=nulls()),
        "i": pa.array(rng.integers(-50, 50, n).astype(np.int32),
                      mask=nulls()),
        "pad": pa.array(rng.random(n)),
    })


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("expand")
    paths = []
    for i in range(3):
        p = str(d / f"part-{i}.parquet")
        pq.write_table(_table(300, 20 + i), p)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def jax_conf():
    conf = get_conf()
    saved = dict(conf._values)
    conf.set(TTB, 1)
    set_conf(conf)
    yield conf
    conf._values.clear()
    conf._values.update(saved)
    set_conf(conf)


def _aggs(sum_, count, count_star, avg, min_, max_, c):
    return [(sum_(c("v")), "sv"), (count(c("s")), "cs"),
            (count_star(), "n"), (avg(c("i")), "ai"), (min_(c("i")), "mi"),
            (max_(c("v")), "xv")]


#: grouping -> a function of a DataFrame giving its GroupedData
GROUPINGS = {
    "rollup_s_l": lambda df: df.rollup("s", "l"),
    "rollup_l_s_s2": lambda df: df.rollup("l", "s", "s2"),
    "cube_s_l": lambda df: df.cube("s", "l"),
    "sets_s_l_empty": lambda df: df.grouping_sets([("s",), ("l",), ()],
                                                  ["s", "l"]),
    "sets_repeat": lambda df: df.grouping_sets([("s", "l"), ("s", "l"),
                                                ("l",)], ["s", "l"]),
}


@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
def test_grouping_sets_match_both_jax_engines(grouping, files, jax_conf):
    make = GROUPINGS[grouping]
    port = make(TorchSession({TTB: 1}, device="cpu").read_parquet(*files)) \
        .agg(*_aggs(P.sum_, P.count, P.count_star, P.avg, P.min_, P.max_,
                    P.col)).collect()
    jdf = make(TpuSession(jax_conf).read_parquet(*files)).agg(
        *_aggs(jsum, jcount, jcount_star, javg, jmin, jmax, jcol))
    assert port.num_rows > 10
    for engine in ("tpu", "cpu"):
        assert_tables_equal(port, jdf.collect(engine=engine))


def test_a_grouping_set_keeps_its_own_null_keys_apart(files):
    """The data's NULL key and a set's dropped key come out as two rows:
    the aggregate groups by (keys, __gid)."""
    df = TorchSession({TTB: 1}, device="cpu").read_parquet(*files)
    got = df.rollup("s").agg((P.count_star(), "n")).collect().to_pylist()
    nulls = sorted(r["n"] for r in got if r["s"] is None)
    t = pa.concat_tables([pq.read_table(p) for p in files])
    assert nulls == sorted([t["s"].null_count, t.num_rows])


def _batch(n=40, seed=3):
    t = _table(n, seed)
    # dictionary-encoded strings, as the Parquet scan reads them
    t = t.set_column(0, "s", t["s"].dictionary_encode())
    return from_arrow(t, "cpu")


def _expand(batch, sets, keys=("s", "l")):
    fields = batch.schema.fields
    projections = [[Literal(None, f.dtype)
                    if f.name in keys and f.name not in kept
                    else col(f.name) for f in fields] + [Literal.of(g)]
                   for g, kept in enumerate(sets)]
    schema = T.Schema([T.Field(f.name, f.dtype, True) for f in fields]
                      + [T.Field("__gid", T.LONG, True)])

    class _Leaf:
        children = []
        schema = batch.schema

    return TpuExpandExec(projections, schema, _Leaf()).expand(batch)


def test_expand_lays_out_every_projection_with_typed_null_slots():
    batch = _batch()
    assert batch.columns[0].codes is not None
    sets = [("s", "l"), ("s",), ()]
    out = _expand(batch, sets)
    n = batch.num_rows
    assert out.num_rows == 3 * n
    s, l_, gid = out.columns[0], out.columns[1], out.columns[-1]
    assert isinstance(s, StringColumn) and s.codes is None
    assert gid.data.tolist() == [0] * n + [1] * n + [2] * n
    want = to_arrow(batch)
    got = to_arrow(out)
    assert got["s"].to_pylist() == want["s"].to_pylist() * 2 + [None] * n
    assert got["l"].to_pylist() == want["l"].to_pylist() + [None] * 2 * n
    assert got["v"].to_pylist() == want["v"].to_pylist() * 3
    # the NULL slots: zeroed chars, length 0, invalid; zeroed longs
    slot = slice(2 * n, 3 * n)
    assert not s.validity[slot].any() and not s.lengths[slot].any()
    assert not s.chars[slot].any() and s.width == batch.columns[0].width
    assert not l_.validity[n:].any() and not l_.data[n:].any()


def test_the_group_by_above_an_expand_sorts(monkeypatch):
    batch = _batch()
    out = _expand(batch, [("s",), ()])
    assert G._coded_key_domains([batch.columns[0]]) is not None
    assert G._coded_key_domains([out.columns[0]]) is None
    coded = []
    real = G._coded_groupby
    monkeypatch.setattr(G, "_coded_groupby",
                        lambda *a: coded.append(1) or real(*a))
    spec = [G.AggSpec("count_star", 0)]
    schema = T.Schema([T.Field("s", T.STRING), T.Field("__gid", T.LONG),
                       T.Field("n", T.LONG)])
    got = G.groupby_aggregate(out, [0, out.schema.index_of("__gid")], spec,
                              schema)
    assert not coded
    t = to_arrow(batch)["s"].to_pylist()
    rows = to_arrow(got).to_pylist()
    assert {r["s"]: r["n"] for r in rows if r["__gid"] == 0} == {
        k: t.count(k) for k in t}
    assert [(r["s"], r["n"]) for r in rows if r["__gid"] == 1] == [
        (None, len(t))]


def _jax_columns(table: pa.Table):
    out = []
    for name in table.schema.names:
        vals = table[name].to_pylist()
        if pa.types.is_string(table[name].type):
            out.append(JStringColumn.from_list(vals))
            continue
        jt = {"l": JT.LONG, "v": JT.DOUBLE, "i": JT.INT, "pad": JT.DOUBLE,
              "__gid": JT.LONG}[name]
        valid = np.array([v is not None for v in vals])
        data = np.array([0 if v is None else v for v in vals],
                        dtype={"l": np.int64, "v": np.float64,
                               "i": np.int32, "pad": np.float64,
                               "__gid": np.int64}[name])
        out.append(JColumn.from_numpy(data, jt, valid))
    return out


@pytest.mark.parametrize("sets", [[("s", "l"), ("s",), ()],
                                  [("l",), ("s",)]])
def test_k1_hashes_the_expanded_tuple_as_the_jax_package_does(sets):
    out = _expand(_batch(n=200, seed=5), sets)
    names = ["s", "l", "s2", "__gid"]
    cols = [out.columns[out.schema.index_of(k)] for k in names]
    n = out.num_rows
    jcols = _jax_columns(to_arrow(out).select(names))
    cap = jcols[0].capacity
    np.testing.assert_array_equal(H.hash_columns(cols, n, out.device).numpy(),
                                  np.asarray(JH.hash_columns(jcols, cap))[:n])
    for parts in (8, 200):
        np.testing.assert_array_equal(
            H.partition_ids(cols, n, out.device, parts).numpy(),
            np.asarray(JH.partition_ids(jcols, cap, parts))[:n])


@pytest.mark.parametrize("dtype", [T.BOOLEAN, T.INT, T.LONG, T.DOUBLE,
                                   T.DATE, T.STRING, T.NULL])
def test_null_literal_is_a_typed_all_null_column(dtype):
    batch = _batch(n=5)
    c = Literal(None, dtype).eval(EvalContext.for_batch(batch))
    assert len(c) == 5 and not c.validity.any()
    if dtype == T.STRING:
        assert isinstance(c, StringColumn)
        assert not c.chars.any() and not c.lengths.any()
    else:
        assert c.dtype == dtype and c.data.dtype == T.to_torch_dtype(dtype)


def test_scan_reads_only_what_the_expand_passes_up(files):
    df = TorchSession({TTB: 1}, device="cpu").read_parquet(*files)
    plan = df.rollup("s", "l").agg((P.sum_(P.col("v")), "sv"))\
        .physical_plan()
    [scan] = [n for n in plan.walk() if isinstance(n, ParquetScanExec)]
    assert scan.schema.names == ["s", "l", "v"]
    [expand] = [n for n in plan.walk() if isinstance(n, TpuExpandExec)]
    assert expand.schema.names == ["s", "l", "v", "__gid"]
    partial = [n for n in plan.walk() if isinstance(n, TpuHashAggregateExec)
               and n.mode == "partial"]
    assert partial[0].children[0] is expand


def test_pooled_rollup_equals_serial_bit_for_bit(files):
    def run(conf):
        df = TorchSession({TTB: 1, **conf}, device="cpu").read_parquet(*files)
        return df.rollup("l", "s").agg(
            (P.sum_(P.col("pad")), "sp"), (P.first(P.col("pad")), "fp"),
            (P.count_star(), "n")).collect()

    serial = run(C.SERIAL)
    assert run({}).equals(serial)


def test_expand_estimates_its_rows_times_its_projections(files):
    from spark_rapids_tpu_torch.plan.cost import exec_estimated_rows

    df = TorchSession({TTB: 1}, device="cpu").read_parquet(*files)
    cube = df.cube("s", "l").agg((P.count_star(), "n"))
    expand = cube._plan.children[0].children[0]
    assert type(expand).__name__ == "Expand"
    assert expand.estimated_rows() == 900 * 4
    [phys] = [n for n in cube.physical_plan().walk()
              if isinstance(n, TpuExpandExec)]
    assert exec_estimated_rows(phys) == 900 * 4


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
