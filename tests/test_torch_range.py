"""The range-partitioned ORDER BY: ``ops/range_partition.py`` against the
JAX package's on the same sample, the planner's shape, and the sorted
output of several partitions against one sort of all rows.

Strings hold no NUL byte: the JAX package orders "a" and "a\\0" as equal
(zero padding), the port by length as Spark does.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import column_to_numpy
from spark_rapids_tpu.ops import range_partition as JR
from spark_rapids_tpu.ops import sort as JS
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol

import spark_rapids_tpu_torch as P
from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession, col, lit
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import from_numpy_columns, to_arrow
from spark_rapids_tpu_torch.execs import exchange as X
from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
from spark_rapids_tpu_torch.execs.sort import SortKey, TpuSortExec
from spark_rapids_tpu_torch.execs.window import TpuWindowExec
from spark_rapids_tpu_torch.exprs.base import BoundReference
from spark_rapids_tpu_torch.ops import range_partition as R
from spark_rapids_tpu_torch.ops.partition import (
    HashPartitioning,
    RangePartitioning,
)
from spark_rapids_tpu_torch.ops.sort import SortOrder
from spark_rapids_tpu_torch.plan.planner import _hash_satisfies

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
KINDS = {"long": (JT.LONG, T.LONG), "double": (JT.DOUBLE, T.DOUBLE),
         "string": (JT.STRING, T.STRING), "int": (JT.INT, T.INT)}
WORDS = np.array(["", "a", "ab", "abc", "b", "abcdefgh", "abcdefghi", "ünï",
                  "zz", "A"], dtype=object)
DOUBLES = np.array([-np.inf, -1.5, -0.0, 0.0, 1.5, np.inf, np.nan, 2.25,
                    -7.0])


def _values(kind, n, rng):
    if kind == "long":
        return rng.integers(-20, 20, n).astype(np.int64)
    if kind == "int":
        return rng.integers(-5, 5, n).astype(np.int32)
    if kind == "double":
        return DOUBLES[rng.integers(0, len(DOUBLES), n)]
    return WORDS[rng.integers(0, len(WORDS), n)]


def _canon(v):
    return ("nan",) if isinstance(v, float) and v != v else v


def _batches(kinds, n=400, seed=0, null_share=0.2):
    """The same rows as a JAX batch and a port batch (columns c0..)."""
    rng = np.random.default_rng(seed)
    names = [f"c{i}" for i in range(len(kinds))]
    data = {nm: _values(k, n, rng) for nm, k in zip(names, kinds)}
    validity = {nm: rng.random(n) >= null_share for nm in names}
    jb = JBatch.from_numpy(data, JT.Schema(
        [JT.Field(nm, KINDS[k][0]) for nm, k in zip(names, kinds)]),
        validity)
    host = {nm: column_to_numpy(c, n) for nm, c in zip(names, jb.columns)}
    pb = from_numpy_columns(host, T.Schema(
        [T.Field(nm, KINDS[k][1]) for nm, k in zip(names, kinds)]), "cpu")
    return jb, pb


ORDER_CASES = [
    (["long"], [(False, False)]),
    (["double"], [(True, True)]),
    (["double"], [(False, True)]),
    (["string"], [(False, False)]),
    (["string"], [(True, True)]),
    (["double", "string"], [(True, True), (False, False)]),
    (["string", "long", "double"], [(False, True), (True, False),
                                    (False, False)]),
]


@pytest.mark.parametrize("kinds,dirs", ORDER_CASES)
@pytest.mark.parametrize("n_parts", [1, 2, 8])
def test_choose_bounds_and_bucket_ids_match_jax(kinds, dirs, n_parts):
    jb, pb = _batches(kinds, seed=len(kinds) + n_parts)
    pos = np.random.default_rng(5).integers(0, pb.num_rows, 64)
    orders = [(i, d, nl) for i, (d, nl) in enumerate(dirs)]
    jorders = [JS.SortOrder(*o) for o in orders]
    porders = [SortOrder(*o) for o in orders]
    jsamples = jb.gather(jnp.asarray(pos, jnp.int32), len(pos))
    psamples = pb.gather(torch.from_numpy(pos))
    jbounds = JR.choose_bounds(jsamples, jorders, n_parts, len(pos))
    pbounds = R.choose_bounds(psamples, porders, n_parts)
    assert pbounds.num_rows == jbounds.num_rows == n_parts - 1
    for i in range(len(kinds)):
        values, valid = column_to_numpy(jbounds.columns[i], jbounds.num_rows)
        assert [_canon(v) if ok else None for v, ok in zip(values, valid)] \
            == [_canon(v) for v in to_arrow(pbounds).column(i).to_pylist()]
    want = np.asarray(JR.bucket_ids(jb, jbounds, jorders, n_parts - 1))
    got = R.bucket_ids(pb, pbounds, porders)
    np.testing.assert_array_equal(got.numpy(), want[: pb.num_rows])


def test_a_row_equal_to_a_bound_goes_left():
    _, pb = _batches(["long"], n=50, seed=3, null_share=0.0)
    bounds = pb.slice(0, 2)
    ids = R.bucket_ids(pb, bounds, [SortOrder(0)])
    v, b = pb.columns[0].data, bounds.columns[0].data
    want = (b[None, :] < v[:, None]).sum(1)
    assert torch.equal(ids, want)
    assert ids[0] == int((b < v[0]).sum()) and ids[1] == int((b < v[1]).sum())


def _strings(words):
    return from_numpy_columns({"s": (np.array(words, dtype=object),
                                     np.ones(len(words), bool))},
                              T.Schema([T.Field("s", T.STRING)]), "cpu")


def test_bucket_ids_widen_strings_to_compare():
    rows = _strings(["b", "abcdefghij", "a"])
    bounds = _strings(["a"])
    assert (rows.columns[0].width, bounds.columns[0].width) == (10, 1)
    assert R.bucket_ids(rows, bounds, [SortOrder(0)]).tolist() == [1, 1, 0]


def _write(tmp_path, n_files, rows, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_files):
        t = pa.table({
            "s": pa.array(list(WORDS[rng.integers(0, len(WORDS), rows)]),
                          mask=rng.random(rows) < 0.15),
            "d": pa.array(DOUBLES[rng.integers(0, len(DOUBLES), rows)],
                          mask=rng.random(rows) < 0.2),
            "l": pa.array(rng.integers(-3, 3, rows), mask=rng.random(rows)
                          < 0.2),
            "k": pa.array(np.arange(i * rows, (i + 1) * rows)),
        })
        paths.append(str(tmp_path / f"f{i}.parquet"))
        pq.write_table(t, paths[-1])
    return paths


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("range")
    paths = _write(d, 4, 150, 5)
    one = str(d / "one.parquet")
    pq.write_table(pa.concat_tables([pq.read_table(p) for p in paths]), one)
    return paths, one


def _rows(table):
    return [tuple(("nan",) if isinstance(v, float) and v != v else v
                  for v in r.values()) for r in table.to_pylist()]


SORTS = [
    [("l", False, False), ("k", False, False)],
    [("d", True, True), ("k", True, False)],
    [("d", False, False), ("s", True, True), ("k", False, False)],
    [("s", False, True), ("l", True, False), ("d", False, True),
     ("k", False, False)],
]


@pytest.mark.parametrize("keys", SORTS)
def test_multi_partition_order_by_is_the_total_order(files, keys):
    paths, one = files
    spread = TorchSession({TTB: 1}, device="cpu").read_parquet(*paths)
    sks = [SortKey(col(c), d, nl) for c, d, nl in keys]
    df = spread.order_by(*sks)
    plan = df.physical_plan()
    assert isinstance(plan, TpuSortExec) and plan.scope == "partition"
    assert isinstance(plan.children[0].partitioning, RangePartitioning)
    got = df.collect()
    parts = [sum(b.num_rows for b in plan.execute_partition(p))
             for p in range(plan.num_partitions)]
    assert sum(parts) == 600 and sum(1 for n in parts if n) > 1
    whole = TorchSession({TTB: 1, "spark.rapids.tpu.sql.sort.rangeExchange":
                          False}, device="cpu").read_parquet(*paths)
    coalesced = whole.order_by(*sks)
    assert coalesced.physical_plan().scope == "global"
    assert _rows(got) == _rows(coalesced.collect())
    from spark_rapids_tpu.execs.sort import SortKey as JSortKey

    jdf = TpuSession().read_parquet(one).order_by(
        *[JSortKey(jcol(c), d, nl) for c, d, nl in keys])
    assert_tables_equal(got, jdf.collect(engine="tpu"), ignore_order=False)


def test_range_bounds_do_not_change_the_result(files, monkeypatch):
    paths, _ = files
    s = TorchSession({TTB: 1}, device="cpu")
    df = s.read_parquet(*paths).order_by(col("k"), desc=True)
    tables, sizes = [], []
    for seed in (X.RANGE_SAMPLE_SEED, 12345):
        monkeypatch.setattr(X, "RANGE_SAMPLE_SEED", seed)
        plan = df.physical_plan()
        sizes.append([sum(b.num_rows for b in plan.execute_partition(p))
                      for p in range(plan.num_partitions)])
        tables.append(df.collect())
    assert sizes[0] != sizes[1]  # other samples, other bounds
    assert _rows(tables[0]) == _rows(tables[1])
    assert tables[0]["k"].to_pylist() == list(range(599, -1, -1))


def test_partitions_that_get_no_rows(files):
    paths, _ = files
    s = TorchSession({TTB: 1}, device="cpu")
    base = s.read_parquet(*paths)
    few = base.where(col("k") < lit(5)).order_by(col("k"), desc=True)
    assert few.collect()["k"].to_pylist() == [4, 3, 2, 1, 0]
    same = base.where(col("k") < lit(300)).select(
        (col("k") * lit(0)).alias("z"), "k").order_by(col("z"))
    plan = same.physical_plan()
    sizes = [sum(b.num_rows for b in plan.execute_partition(p))
             for p in range(plan.num_partitions)]
    assert sizes[0] == 300  # every row equals every bound: bucket 0
    assert sorted(same.collect()["k"].to_pylist()) == list(range(300))
    none = base.where(col("k") < lit(0)).order_by(col("k"))
    out = none.collect()
    assert out.num_rows == 0 and out.schema.names == ["s", "d", "l", "k"]


def test_hash_satisfies_refuses_a_range_distribution(files):
    paths, _ = files
    s = TorchSession({TTB: 1}, device="cpu")
    sorted_df = s.read_parquet(*paths).order_by(col("l"))
    plan = sorted_df.physical_plan()
    key = [BoundReference(2, T.LONG, True, "l")]
    assert isinstance(plan.output_partitioning, RangePartitioning)
    assert _hash_satisfies(plan, key) is None
    hashed = TpuShuffleExchangeExec(HashPartitioning(key, 8), plan,
                                    s.shuffle_manager)
    assert _hash_satisfies(hashed, key) is hashed.partitioning
    # a window over range-sorted rows still hashes its partition keys
    w = P.Window.partition_by("l").order_by("k")
    ranked = sorted_df.select("l", "k", P.rank().over(w).alias("r"))
    win = next(n for n in ranked.physical_plan().walk()
               if isinstance(n, TpuWindowExec))
    assert win.partitioned
    assert isinstance(win.children[0].partitioning, HashPartitioning)
    rows = ranked.collect().to_pylist()
    assert all(r["r"] == 1 + sum(1 for q in rows if q["l"] == r["l"]
                                 and q["k"] < r["k"]) for r in rows)
