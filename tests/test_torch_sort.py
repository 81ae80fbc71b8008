"""Sort parity: the port's ``ops/sort.py`` against the JAX package's
``sort_permutation``, permutation for permutation, on the same
numpy-seeded batches; the port's top-n, sort and limit execs against a
full sort of the same rows.

Strings hold no NUL byte: the JAX package orders "a" and "a\\0" as
equal (zero padding), the port by length as Spark does.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import column_to_numpy
from spark_rapids_tpu.ops import sort as JS

from spark_rapids_tpu_torch import TorchSession, col
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import from_numpy_columns, to_arrow
from spark_rapids_tpu_torch.columnar.batch import concat_batches
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.execs.limit import (
    TpuCollectLimitExec,
    TpuGlobalLimitExec,
)
from spark_rapids_tpu_torch.execs.sort import SortKey, TpuSortExec, TpuTopNExec
from spark_rapids_tpu_torch.exprs.base import BoundReference
from spark_rapids_tpu_torch.ops import groupby as G
from spark_rapids_tpu_torch.ops import join as J
from spark_rapids_tpu_torch.ops import sort as S
from spark_rapids_tpu_torch.ops.partition import RangePartitioning

#: kind -> (JAX type, port type)
KINDS = {"int": (JT.INT, T.INT), "long": (JT.LONG, T.LONG),
         "double": (JT.DOUBLE, T.DOUBLE), "bool": (JT.BOOLEAN, T.BOOLEAN),
         "date": (JT.DATE, T.DATE), "string": (JT.STRING, T.STRING)}
WORDS = np.array(["", "a", "ab", "abc", "b", "abcdefgh", "abcdefghi", "ünï",
                  "zz", "A"], dtype=object)
SPECIAL_DOUBLES = np.array([-np.inf, -1.5, -0.0, 0.0, 1.5, np.inf, np.nan,
                            2.25, -7.0])


def _values(kind, n, rng):
    if kind == "int":
        v = rng.integers(-5, 5, n).astype(np.int32)
        v[:2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
        return v
    if kind == "long":
        v = rng.integers(-5, 5, n).astype(np.int64)
        v[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                 1 << 62, -(1 << 62)]
        return v
    if kind == "double":
        return SPECIAL_DOUBLES[rng.integers(0, len(SPECIAL_DOUBLES), n)]
    if kind == "bool":
        return rng.random(n) < 0.5
    if kind == "date":
        return rng.integers(-3, 4, n).astype(np.int32)
    return WORDS[rng.integers(0, len(WORDS), n)]


def _batches(kinds, n=300, seed=0, null_share=0.2):
    """The same rows as a JAX batch and a port batch (columns c0..)."""
    rng = np.random.default_rng(seed)
    names = [f"c{i}" for i in range(len(kinds))]
    data = {nm: _values(k, n, rng) for nm, k in zip(names, kinds)}
    validity = {nm: rng.random(n) >= null_share for nm in names}
    jschema = JT.Schema([JT.Field(nm, KINDS[k][0])
                         for nm, k in zip(names, kinds)])
    jb = JBatch.from_numpy(data, jschema, validity)
    host = {nm: column_to_numpy(c, n) for nm, c in zip(names, jb.columns)}
    pschema = T.Schema([T.Field(nm, KINDS[k][1])
                        for nm, k in zip(names, kinds)])
    return jb, from_numpy_columns(host, pschema, "cpu")


def _perms(jb, pb, orders):
    want = np.asarray(JS.sort_permutation(
        jb, [JS.SortOrder(*o) for o in orders]))[: pb.num_rows]
    got = S.sort_permutation(pb, [S.SortOrder(*o) for o in orders])
    return got.numpy(), want


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("nulls_last", [False, True])
def test_sort_permutation_matches_jax(kind, descending, nulls_last):
    jb, pb = _batches([kind], seed=len(kind))
    got, want = _perms(jb, pb, [(0, descending, nulls_last)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kinds,dirs", [
    (["double", "string"], [(True, True), (False, False)]),
    (["string", "int"], [(False, True), (True, False)]),
    (["long", "bool", "date"], [(True, False), (False, True),
                                (True, True)]),
    (["date", "double", "long"], [(False, False), (True, True),
                                  (False, True)]),
])
def test_multi_key_sort_matches_jax(kinds, dirs):
    jb, pb = _batches(kinds, n=500, seed=7, null_share=0.3)
    orders = [(i, d, nl) for i, (d, nl) in enumerate(dirs)]
    got, want = _perms(jb, pb, orders)
    np.testing.assert_array_equal(got, want)


def test_double_order_puts_nan_above_inf_and_negative_zero_below_zero():
    x = torch.tensor([np.nan, np.inf, 0.0, -0.0, -np.inf, 1.0, -np.nan],
                     dtype=torch.float64)
    c = Column(x, torch.ones(7, dtype=torch.bool), T.DOUBLE)
    perm = S.lexsort(S.column_sort_keys(c)).tolist()
    assert perm == [4, 3, 2, 5, 1, 0, 6]
    desc = S.lexsort(S.column_sort_keys(c, descending=True)).tolist()
    assert desc == [0, 6, 1, 5, 2, 3, 4]
    # grouping keys fold -0.0 into 0.0, and every NaN is one value
    g = S.column_sort_keys(c, grouping=True)[-1]
    assert g[2] == g[3] and g[0] == g[6]
    o = S.column_sort_keys(c)[-1]
    assert o[3] < o[2] and o[0] == o[6]


def test_groupby_join_and_order_by_share_one_sort():
    assert not hasattr(G, "_lexsort") and not hasattr(G, "_sort_keys")
    assert G.lexsort is S.lexsort and J.lexsort is S.lexsort
    assert G.column_sort_keys is S.column_sort_keys


class _Batches(TpuExec):
    """A leaf exec over given batches, one partition per list."""

    def __init__(self, partitions):
        super().__init__()
        self.partitions = partitions
        self.device = torch.device("cpu")

    @property
    def schema(self):
        return self.partitions[0][0].schema

    @property
    def num_partitions(self):
        return len(self.partitions)

    def execute_partition(self, p):
        yield from self.partitions[p]


def _split(batch, cuts):
    bounds = [0, *cuts, batch.num_rows]
    return [batch.slice(a, b) for a, b in zip(bounds, bounds[1:])]


def _keys(schema, spec):
    return [SortKey(BoundReference(i, schema.fields[i].dtype, True,
                                   schema.fields[i].name), d, nl)
            for i, d, nl in spec]


def _rows(table):
    """Rows in order; NaN as a token, since NaN != NaN."""
    return [tuple(("nan",) if isinstance(v, float) and v != v else v
                  for v in r.values()) for r in table.to_pylist()]


def _full_sort_prefix(batch, spec, n):
    order = [S.SortOrder(i, d, nl) for i, d, nl in spec]
    return to_arrow(S.sort_batch(batch, order).slice_prefix(n))


@pytest.mark.parametrize("kind", ["int", "long", "double", "date", "bool"])
@pytest.mark.parametrize("descending,nulls_last", [
    (True, True), (False, False), (True, False), (False, True)])
@pytest.mark.parametrize("n", [1, 7, 40])
def test_topn_matches_full_sort_prefix(kind, descending, nulls_last, n):
    # few distinct primaries (ties at the n-th value), many NULLs, a
    # tiebreak key, a batch of NULLs only and batches shorter than n
    _, pb = _batches([kind, "long"], n=400, seed=n, null_share=0.35)
    nulls = pb.slice(0, 30)
    nulls.columns[0] = nulls.columns[0].with_validity(
        torch.zeros(30, dtype=torch.bool))
    whole = concat_batches([nulls, pb])
    parts = _split(whole, [30, 33, 200, 210])
    spec = [(0, descending, nulls_last), (1, False, False)]
    src = _Batches([parts[:2], parts[2:]])
    topn = TpuTopNExec(n, _keys(whole.schema, spec), src)
    got = list(topn.execute())
    assert len(got) == 1
    want = _full_sort_prefix(whole, spec, n)
    assert _rows(to_arrow(got[0])) == _rows(want)


def test_topn_cuts_its_candidates_to_n_on_the_way():
    _, pb = _batches(["double", "int"], n=600, seed=3)
    spec = [(0, True, True), (1, True, False)]
    parts = _split(pb, list(range(50, 600, 50)))
    topn = TpuTopNExec(5, _keys(pb.schema, spec), _Batches([parts]))
    topn.reduce_rows = 20
    got = list(topn.execute())[0]
    assert _rows(to_arrow(got)) == _rows(_full_sort_prefix(pb, spec, 5))


def _write(tmp_path, n_files, rows, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_files):
        t = pa.table({
            "s": pa.array(list(WORDS[rng.integers(0, len(WORDS), rows)])),
            "d": pa.array(SPECIAL_DOUBLES[rng.integers(0, 9, rows)],
                          mask=rng.random(rows) < 0.2),
            "k": pa.array(np.arange(i * rows, (i + 1) * rows)),
        })
        paths.append(str(tmp_path / f"f{i}.parquet"))
        pq.write_table(t, paths[-1])
    return paths


def test_order_by_and_limit_through_the_session(tmp_path):
    paths = _write(tmp_path, 3, 200, 5)
    s = TorchSession({"spark.rapids.tpu.sql.scan.taskTargetBytes": 1},
                     device="cpu")
    df = s.read_parquet(*paths)
    whole = concat_batches([b for b in df.physical_plan().execute()])
    spec = [(0, False, False), (1, True, True), (2, False, False)]
    want = _full_sort_prefix(whole, spec, whole.num_rows)
    sorted_df = df.order_by(SortKey(col("s")), SortKey(col("d"), True, True),
                            SortKey(col("k")))
    plan = sorted_df.physical_plan()
    # three scan tasks: a range exchange, then each partition sorted
    assert isinstance(plan, TpuSortExec) and plan.scope == "partition"
    assert isinstance(plan.children[0].partitioning, RangePartitioning)
    assert _rows(sorted_df.collect()) == _rows(want)
    # a string primary key cannot threshold: sort, then a limit over
    # the sorted partitions in order
    lim = sorted_df.limit(17)
    assert isinstance(lim.physical_plan(), TpuCollectLimitExec)
    assert _rows(lim.collect()) == _rows(want.slice(0, 17))
    one = TorchSession(device="cpu").read_parquet(*paths).order_by(
        SortKey(col("s")), SortKey(col("d"), True, True), SortKey(col("k")))
    assert isinstance(one.limit(17).physical_plan(), TpuGlobalLimitExec)
    assert _rows(one.limit(17).collect()) == _rows(want.slice(0, 17))
    # a double primary becomes a top-n: NULLs last, as desc=True sets
    top = df.order_by(col("d"), desc=True).limit(9)
    assert isinstance(top.physical_plan(), TpuTopNExec)
    spec = [(1, True, True)]
    assert _rows(top.collect()) == _rows(_full_sort_prefix(whole, spec, 9))
    # a limit over several partitions: the first rows, in order
    first = df.limit(250)
    assert isinstance(first.physical_plan(), TpuCollectLimitExec)
    want = to_arrow(whole.slice_prefix(250))
    assert _rows(first.collect()) == _rows(want)
    assert df.limit(0).collect().num_rows == 0
