"""``DataFrame.cache`` / ``unpersist`` against the JAX package.

Counterparts of the JAX package's ``tests/test_cache.py``: a second
collect reads no file and equals the first and both JAX engines; a
LIMIT that stops early publishes nothing; ``unpersist`` returns the
store to its entries and device bytes before the cache.  Besides, what
torch changes and the port's scan paths risk:

- mutation: one cached frame collected three times under consumers that
  write into their input (a torch UDF's in-place add), filter, project,
  sort and join it gives the same bytes every time, also after the store
  spilled the cached batches to host and disk and restored them;
- filters never cross the cache: a Filter above the cache neither pushes
  into nor elides over the scan under it, and a join's runtime filter
  never reaches that scan, so two queries with different filters over
  one cache each equal their uncached runs;
- the CPU engine caches in the slot's own table when the ``Cached``
  switch is off.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import count_star as jcount_star
from spark_rapids_tpu.session import sum_ as jsum

from differential import assert_tables_equal
from torch_plugin import fresh_plugin  # noqa: F401
from spark_rapids_tpu_torch import TorchSession, col, count_star, sum_
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.execs.cache import TpuCacheExec
from spark_rapids_tpu_torch.execs.fallback import CpuFallbackExec
from spark_rapids_tpu_torch.execs.sort import SortKey
from spark_rapids_tpu_torch.io.scan import ParquetScanExec
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.udf import torch_udf

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"


@pytest.fixture
def lineitem(tmp_path):
    rng = np.random.default_rng(5)
    n = 5000
    t = pa.table({
        "k": pa.array(np.array(["a", "b", "c"])[rng.integers(0, 3, n)]),
        "v": rng.normal(size=n),
        "i": rng.integers(0, 100, n)})
    paths = []
    for j in range(4):  # four scan tasks under TTB = 1
        paths.append(str(tmp_path / f"t{j}.parquet"))
        pq.write_table(t.slice(j * 1250, 1250), paths[-1])
    return paths


@pytest.fixture
def scans(monkeypatch):
    """Scan partitions started, across every ParquetScanExec."""
    calls = {"n": 0}
    orig = ParquetScanExec.execute_partition

    def spy(self, p):
        calls["n"] += 1
        return orig(self, p)

    monkeypatch.setattr(ParquetScanExec, "execute_partition", spy)
    return calls


def _jax_agg(paths):
    return TpuSession().read_parquet(*paths).where(jcol("i") < 50) \
        .group_by(jcol("k")).agg((jsum(jcol("v")), "sv"),
                                 (jcount_star(), "n"))


def test_second_collect_skips_scan(lineitem, scans):
    s = TorchSession({TTB: 1}, device="cpu")
    df = s.read_parquet(*lineitem).where(col("i") < 50).cache()
    agg = df.group_by("k").agg((sum_(col("v")), "sv"), (count_star(), "n"))
    r1 = agg.collect()
    first = scans["n"]
    assert first == 4
    r2 = agg.collect()
    assert scans["n"] == first, "the second collect scanned again"
    assert r1.equals(r2)
    jdf = _jax_agg(lineitem)
    for engine in ("tpu", "cpu"):
        assert_tables_equal(r1, jdf.collect(engine=engine),
                            approx_float=True)
    cache = [n for n in agg.physical_plan().walk()
             if isinstance(n, TpuCacheExec)][0]
    assert cache.node_desc() == "TpuCacheExec [cached]"
    # a frame made from the cached one after cache() reads the slot too
    cnt = df.agg((count_star(), "n")).collect()
    assert scans["n"] == first
    assert cnt.column("n").to_pylist() == [sum(r1.column("n").to_pylist())]
    df.unpersist()
    assert agg.collect().equals(r1)
    assert scans["n"] == 2 * first


def test_partial_drain_does_not_publish(lineitem, scans):
    """A LIMIT that stops early publishes no truncated cache."""
    s = TorchSession({TTB: 1}, device="cpu")
    df = s.read_parquet(*lineitem).cache()
    assert df.limit(3).collect().num_rows == 3
    assert not df._plan.slot.filled
    assert s.store.leak_report() == []  # the partial drain was freed
    first = scans["n"]
    total = df.agg((count_star(), "n")).collect()
    assert total.column("n").to_pylist() == [5000]
    assert scans["n"] > first
    assert df._plan.slot.filled
    df.unpersist()


def test_store_accounting_clean_after_unpersist(lineitem):
    s = TorchSession({TTB: 1}, device="cpu")
    store = s.store
    baseline = (len(store._entries), store.device_used)
    df = s.read_parquet(*lineitem).cache()
    df.agg((count_star(), "n")).collect()
    assert isinstance(df._plan, L.Cached)
    slot = df._plan.slot
    assert slot.filled and len(slot.parts) == 4
    assert len(store._entries) == baseline[0] + 4
    assert store.device_used > baseline[1]
    df.unpersist()
    assert not slot.filled
    assert (len(store._entries), store.device_used) == baseline


@torch_udf(T.DOUBLE)
def bump_in_place(v):
    """Writes into its input, as a careless columnar UDF may."""
    return v.add_(1000.0)


def _consumers(df, dim):
    """Consumers that filter, project (one writing into its input), sort
    and join the cached frame."""
    return [
        df.where(col("i") < 30),
        df.select(col("k"), bump_in_place(col("v")).alias("bumped"),
                  col("i")),
        df.order_by(SortKey(col("v"), descending=True)),
        df.join(dim, left_on=["k"], right_on=["dk"]),
        df,
    ]


@pytest.mark.parametrize("spill", [False, True])
def test_consumers_never_change_the_cache(lineitem, spill):
    s = TorchSession({TTB: 1}, device="cpu")
    df = s.read_parquet(*lineitem).cache()
    dim = s.create_dataframe(pa.table({"dk": ["a", "b"], "w": [1, 2]}))
    first = [q.collect() for q in _consumers(df, dim)]
    for _ in range(2):
        if spill:
            s.store.spill_all_unpinned()
            assert s.store.spill_stats()["spilled_device_to_host"] > 0
        again = [q.collect() for q in _consumers(df, dim)]
        for a, b in zip(first, again):
            assert a.equals(b)
    uncached = s.read_parquet(*lineitem)
    assert_tables_equal(first[-1], uncached.collect())
    assert first[1].column("bumped").to_pylist() == [
        v + 1000.0 for v in first[-1].column("v").to_pylist()]
    df.unpersist()
    assert s.store.leak_report() == []


def test_filters_never_cross_the_cache(lineitem):
    s = TorchSession({TTB: 1}, device="cpu")
    df = s.read_parquet(*lineitem).cache()
    low = df.where(col("i") < 20)
    plan = low.physical_plan()
    scan = [n for n in plan.walk() if isinstance(n, ParquetScanExec)][0]
    assert scan.pushed_filter is None
    assert scan.runtime_filters == []
    assert "TpuFilterExec" in plan.tree_string()
    got_low = low.collect()
    high = df.where(col("i") >= 90)
    got_high = high.collect()
    # a join whose build side is small over the cached frame: its
    # runtime filter may not reach the cached scan
    dim = s.create_dataframe(pa.table({"ii": pa.array([3, 4], pa.int64())}))
    joined = df.join(dim, left_on=["i"], right_on=["ii"])
    jplan = joined.physical_plan()
    assert all(n.runtime_filters == [] for n in jplan.walk()
               if isinstance(n, ParquetScanExec))
    got_join = joined.collect()
    for got, q in ((got_low, lambda d: d.where(col("i") < 20)),
                   (got_high, lambda d: d.where(col("i") >= 90)),
                   (got_join, lambda d: d.join(dim, left_on=["i"],
                                               right_on=["ii"]))):
        assert_tables_equal(got, q(s.read_parquet(*lineitem)).collect())
    assert df.agg((count_star(), "n")).collect().column("n").to_pylist() \
        == [5000]
    df.unpersist()


def test_cpu_engine_caches_in_its_own_table(lineitem):
    s = TorchSession({TTB: 1, "spark.rapids.tpu.sql.exec.Cached": False},
                     device="cpu")
    df = s.read_parquet(*lineitem).where(col("i") < 50).cache()
    agg = df.group_by("k").agg((sum_(col("v")), "sv"), (count_star(), "n"))
    assert "! Cached [materializing]" in agg.explain()
    assert any(isinstance(n, CpuFallbackExec)
               for n in agg.physical_plan().walk())
    got = agg.collect()
    assert df._plan.slot.cpu_table is not None and not df._plan.slot.filled
    assert agg.collect().equals(got)
    assert_tables_equal(got, _jax_agg(lineitem).collect(engine="cpu"),
                        approx_float=True)
    df.unpersist()
    assert df._plan.slot.cpu_table is None


def test_explain_shows_the_cache_state(lineitem):
    s = TorchSession({TTB: 1}, device="cpu")
    df = s.read_parquet(*lineitem).cache()
    assert "* Cached [materializing]" in df.explain()
    assert "TpuCacheExec [materializing]" in df.explain()
    df.collect()
    assert "* Cached [cached]" in df.explain()
    assert "TpuCacheExec [cached]" in df.explain()
    df.unpersist()
    assert "* Cached [materializing]" in df.explain()


def test_the_served_batches_are_copies(lineitem):
    """Every run is served its own tensors."""
    s = TorchSession({TTB: 1}, device="cpu")
    df = s.read_parquet(*lineitem).cache()
    df.collect()
    a = [b for p in range(4)
         for b in df.physical_plan().execute_partition(p)]
    b = [b for p in range(4)
         for b in df.physical_plan().execute_partition(p)]
    for x, y in zip(a, b):
        for cx, cy in zip(x.columns, y.columns):
            assert cx.validity.data_ptr() != cy.validity.data_ptr()
            assert torch.equal(cx.validity, cy.validity)
    df.unpersist()


# the OOM ladder stays quiet here; the mutation test spills on purpose,
# so this file does not take the module's no-spill check
