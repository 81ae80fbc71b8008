"""The port's out-of-core sample-split sort against the JAX engine.

JAX ``tests/test_ooc_sort.py``'s cases at its sizes: 4 000 rows in four
files, ``sort.singleBatchRows`` 500, ``batchSizeRows`` 700,
``sort.maxBuckets`` 8, the range exchange off so the global sort is
the one that goes out of core; heavy duplicates; an oversized bucket
that recurses (threshold 300, batches of 500, 4 buckets); and a shrunk
device budget that makes the collected batches spill.  Key lists are
total orders, so the answer is unique and is held row for row against
the JAX engine (and its CPU oracle).  Sorting is stable at every step,
so even on keys with ties the out-of-core output equals the port's
one-batch sort bit for bit.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.execs.sort import SortKey as JSortKey
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession, col
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.execs.sort import SortKey, TpuSortExec
from spark_rapids_tpu_torch.plan.planner import collect_exec
from torch_plugin import fresh_plugin, sized_plugin  # noqa: F401

OOC = {C.SORT_SINGLE_BATCH_ROWS: 500, C.BATCH_ROWS: 700,
       C.SORT_MAX_BUCKETS: 8, C.SORT_RANGE_EXCHANGE: False}


def _write(d, t: pa.Table, n_files: int) -> list:
    paths, per = [], t.num_rows // n_files
    for i in range(n_files):
        p = str(d / f"f{i}.parquet")
        pq.write_table(t.slice(i * per, per if i < n_files - 1
                               else t.num_rows - i * per), p)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    rng = np.random.default_rng(11)
    n = 4000
    t = pa.table({
        "a": pa.array(rng.integers(-50, 50, n), pa.int64(),
                      mask=rng.random(n) < 0.1),
        "b": rng.random(n),
        "i": pa.array(rng.integers(0, 30, n), pa.int32()),
        "s": [f"k{x}" for x in rng.integers(0, 300, n)]})
    return _write(tmp_path_factory.mktemp("ooc"), t, 4)


def _sort(session, paths, keys, sortkey, c):
    return session.read_parquet(*paths).order_by(
        *[sortkey(c(name), descending=d, nulls_last=d) for name, d in keys])


def _jax(paths, keys):
    df = _sort(TpuSession(), paths, keys, JSortKey, jcol)
    return {e: df.collect(engine=e) for e in ("tpu", "cpu")}


def _port(paths, keys, conf):
    s = TorchSession(conf, device="cpu")
    plan = _sort(s, paths, keys, SortKey, col).physical_plan()
    sorts = [n for n in plan.walk() if isinstance(n, TpuSortExec)]
    got = collect_exec(plan, s.conf)
    assert s.store.leak_report() == []
    return got, sorts, s


def _ooc_metrics(df_sorts):
    return {k: sum(n.metrics[k] for n in df_sorts)
            for k in ("sortBuckets", "oocRows", "hostRows")}


@pytest.mark.parametrize("keys", [
    [("a", False), ("b", False)],
    [("b", True), ("a", False)],
    [("s", False), ("a", True), ("b", False)],
    [("i", True), ("s", False), ("b", True)],
])
def test_ooc_sort_matches_the_jax_engine(mixed, keys):
    want = _jax(mixed, keys)
    got, sorts, _ = _port(mixed, keys, OOC)
    assert [n.scope for n in sorts] == ["global"]
    m = _ooc_metrics(sorts)
    assert m["oocRows"] == 4000 and m["hostRows"] == 4000
    assert 2 <= m["sortBuckets"] <= 8
    for engine, table in want.items():
        assert_tables_equal(got, table, ignore_order=False), engine


def test_ooc_equals_the_one_batch_sort_with_ties(mixed):
    """Keys with ties: the stable out-of-core sort gives the one-batch
    sort's rows in the same order, bit for bit."""
    keys = [("i", False)]
    small, _, _ = _port(mixed, keys, {C.SORT_RANGE_EXCHANGE: False})
    big, sorts, _ = _port(mixed, keys, OOC)
    assert _ooc_metrics(sorts)["oocRows"] == 4000
    assert big.equals(small)


def test_ooc_sort_under_a_shrunk_budget_spills(mixed, tmp_path):
    keys = [("a", False), ("b", False)]
    conf = {**OOC, C.HBM_BUDGET_BYTES: 30_000, C.HOST_SPILL_BYTES: 60_000,
            C.SPILL_DIR: str(tmp_path)}
    with sized_plugin(conf):  # the process store, sized by this conf
        got, sorts, s = _port(mixed, keys, conf)
        st = s.spill_stats()
    assert st["spilled_device_to_host"] > 0 and st["spilled_host_to_disk"] > 0
    assert not list(tmp_path.glob("spill-*"))
    assert_tables_equal(got, _jax(mixed, keys)["tpu"], ignore_order=False)


def test_heavy_duplicates(tmp_path):
    rng = np.random.default_rng(9)
    t = pa.table({
        "k": pa.array(np.where(rng.random(2000) < 0.8, 7,
                               rng.integers(0, 100, 2000)), pa.int64()),
        "v": rng.random(2000)})
    paths = _write(tmp_path, t, 2)
    keys = [("k", False), ("v", False)]
    got, sorts, _ = _port(paths, keys, OOC)
    assert _ooc_metrics(sorts)["oocRows"] == 2000
    assert_tables_equal(got, _jax(paths, keys)["tpu"], ignore_order=False)
    ks = got.column("k").to_pylist()
    assert ks.count(7) == int(np.sum(t.column("k").to_numpy() == 7))


def test_oversized_bucket_recurses(tmp_path):
    rng = np.random.default_rng(17)
    k = np.where(rng.random(4000) < 0.9, rng.integers(1000, 1010, 4000),
                 rng.integers(0, 100000, 4000)).astype(np.int64)
    t = pa.table({"k": k, "v": rng.random(4000)})
    paths = _write(tmp_path, t, 4)
    keys = [("k", False), ("v", False)]
    got, sorts, _ = _port(paths, keys, {
        C.SORT_SINGLE_BATCH_ROWS: 300, C.BATCH_ROWS: 500,
        C.SORT_MAX_BUCKETS: 4, C.SORT_RANGE_EXCHANGE: False})
    m = _ooc_metrics(sorts)
    # the skewed bucket's rows went through a second pass
    assert m["oocRows"] > 4000 and m["sortBuckets"] > 4
    assert_tables_equal(got, _jax(paths, keys)["tpu"], ignore_order=False)


def test_each_range_partition_goes_out_of_core(mixed):
    keys = [("a", False), ("s", False), ("b", False)]
    conf = {C.SORT_SINGLE_BATCH_ROWS: 500, C.BATCH_ROWS: 700,
            C.TASK_TARGET_BYTES: 1, C.SHUFFLE_PARTITIONS: 2}
    got, sorts, _ = _port(mixed, keys, conf)
    assert [n.scope for n in sorts] == ["partition"]
    assert _ooc_metrics(sorts)["oocRows"] == 4000
    assert_tables_equal(got, _jax(mixed, keys)["tpu"], ignore_order=False)


def test_small_input_stays_one_batch(mixed):
    got, sorts, _ = _port(mixed, [("a", False), ("b", False)],
                          {C.SORT_RANGE_EXCHANGE: False})
    assert _ooc_metrics(sorts) == {"sortBuckets": 0, "oocRows": 0,
                                   "hostRows": 0}
    assert got.num_rows == 4000
