"""The port's OOM ladder (``execs/retry.py``) and fault seams against
the JAX package's, and queries under forced spill and forced split.

The ladder cases are JAX ``tests/test_recovery.py``'s (the rungs, the
floor, no duplicate after a yield, ``run_with_oom_retry``, task
retries), run through both packages with the same failures; their
``retry_stats()`` must agree.  The query cases run a shuffled join, a
broadcast join, a grouped aggregate, a window and an exchange map stage
on the CPU twice more than unconstrained: with every batch spilled to
host and on to disk (device budget 1 byte, host budget 2 KiB), which
must give the unconstrained result bit for bit, and under the fault
schedule ``exec.batch:nth=3,times=2``, run serially so that the third
and fourth attempts of the ladder fail and the third unit is bisected.
A split re-buckets rows, so a split float aggregate adds in another
grouping: keys, integers, strings and NULLs are exact, floats within
``tests/differential``'s ``approx_float``.  Each is held against both
JAX engines, and the store is empty after every ``collect()``.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.config import get_conf
from spark_rapids_tpu.execs import retry as JR
from spark_rapids_tpu.exprs import window as JWX
from spark_rapids_tpu.memory import store as jstore
from spark_rapids_tpu.robustness import faults as jfaults
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import count as jcount
from spark_rapids_tpu.session import sum_ as jsum

import spark_rapids_tpu_torch as P
from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import from_arrow, to_arrow
from spark_rapids_tpu_torch.execs import retry as R
from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
from spark_rapids_tpu_torch.exprs.base import BoundReference
from spark_rapids_tpu_torch.io.scan import ArrowSourceExec
from spark_rapids_tpu_torch.memory.store import BufferStore
from spark_rapids_tpu_torch.ops import kernels
from spark_rapids_tpu_torch.ops.partition import HashPartitioning
from spark_rapids_tpu_torch.plan.planner import collect_exec
from spark_rapids_tpu_torch.robustness import faults
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager
from torch_plugin import fresh_plugin, sized_plugin  # noqa: F401

CPU = torch.device("cpu")
SPLIT_SPEC = "exec.batch:nth=3,times=2"
COMMON = ("splits", "spill_retries", "task_retries")


class FakeDeviceOOM(RuntimeError):
    def __str__(self):
        return "RESOURCE_EXHAUSTED: out of memory allocating 1234 bytes"


@pytest.fixture(autouse=True)
def ladder_state():
    """Both packages: no backoff, a split floor of 16 rows, no armed
    schedule, zeroed counters; restored after."""
    conf = get_conf()
    saved = {k.key: conf.get(k) for k in (JR.RETRY_BACKOFF_S,
                                          JR.SPLIT_MIN_ROWS)}
    conf.set(JR.RETRY_BACKOFF_S.key, 0.0)
    conf.set(JR.SPLIT_MIN_ROWS.key, 16)
    R.reset_retry_stats()
    JR.reset_retry_stats()
    yield
    faults.disarm()
    jfaults.disarm()
    for k, v in saved.items():
        conf.set(k, v)


POLICY = R.RetryPolicy(backoff_s=0.0, min_split_rows=16)


def _common(stats):
    return {k: stats[k] for k in COMMON}


def _long_batches(n):
    schema = JT.Schema([JT.Field("x", JT.LONG)])
    x = np.arange(n, dtype=np.int64)
    return (JBatch.from_numpy({"x": x}, schema),
            from_arrow(pa.table({"x": x}), CPU))


# -- classify ------------------------------------------------------------ #

@pytest.mark.parametrize("exc,verdict", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"), "retryable"),
    (MemoryError(), "retryable"),
    (faults.InjectedFault("exec.batch",
                          "RESOURCE_EXHAUSTED: injected batch processing "
                          "fault"), "retryable"),
    (faults.InjectedFault("alloc.device",
                          "RESOURCE_EXHAUSTED: injected device allocation "
                          "failure"), "retryable"),
    (FakeDeviceOOM(), "retryable"),
    (kernels.KernelError("nvcc failed for hash_string.cu: out of memory"),
     "fatal"),
    (kernels.KernelError("hash_columns kernel launch failed: CUDA error 2"),
     "fatal"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "fatal"),
    (ValueError("user bug"), "fatal"),
    (AssertionError("logic bug"), "fatal"),
])
def test_classify(exc, verdict):
    assert R.classify(exc) == verdict
    if not isinstance(exc, (kernels.KernelError, torch.cuda.OutOfMemoryError,
                            faults.InjectedFault)):
        assert JR.classify(exc) == verdict


def test_a_kernel_that_fails_to_build_is_never_retried(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(kernels, "find_nvcc", lambda: "/bin/false")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    calls = []

    def run(batch):
        calls.append(1)
        kernels.build_library("hash_string")
        yield batch

    _, b = _long_batches(4096)
    with pytest.raises(kernels.KernelError, match="nvcc failed"):
        list(R.with_split_retry(run, b, "t", POLICY))
    assert calls == [1]
    assert R.retry_stats() == dict.fromkeys(R.retry_stats(), 0)


def test_no_cpu_fallback_key():
    with pytest.raises(KeyError):
        C.TorchConf({"spark.rapids.tpu.sql.recovery."
                     "cpuFallbackOnDeviceError": True})


# -- the ladder, against the JAX ladder ------------------------------------ #

def _both(make_run, n=4096):
    """The same ladder over the same rows in both packages: (rows each
    run saw, chunks out, retry stats) per package."""
    out = []
    jb, pb = _long_batches(n)
    for mod, b, rows, policy in (
            (JR, jb, lambda x: x.concrete_num_rows(), None),
            (R, pb, lambda x: x.num_rows, POLICY)):
        seen = []
        kw = {} if policy is None else {"policy": policy}
        got = list(mod.with_split_retry(make_run(seen, rows), b, "t", **kw))
        out.append((seen, len(got), _common(mod.retry_stats())))
    return out


def test_ladder_rungs_equal_jax():
    def make_run(seen, rows):
        fails = {"n": 2}

        def run(batch):
            if fails["n"]:
                fails["n"] -= 1
                raise FakeDeviceOOM()
            seen.append(rows(batch))
            yield batch
        return run

    jax_side, port_side = _both(make_run)
    assert port_side == jax_side
    assert port_side[0] == [2048, 2048]
    assert port_side[2] == {"splits": 1, "spill_retries": 1,
                            "task_retries": 0}


@pytest.mark.parametrize("spec", [SPLIT_SPEC, "exec.batch:nth=1",
                                  "exec.batch:every=3",
                                  "exec.batch:nth=2,times=4"])
def test_ladder_under_a_fault_schedule_equals_jax(spec):
    """Five batches through each package's ladder under one schedule of
    the exec.batch seam: the same rows reach ``run`` and the same
    counters move."""
    results = []
    for mod, fmod, idx, policy in ((JR, jfaults, 0, None),
                                   (R, faults, 1, POLICY)):
        fmod.install(spec, forced=True)
        seen = []
        try:
            for i in range(5):
                b = _long_batches(1000 + i)[idx]
                kw = {} if policy is None else {"policy": policy}
                for out in mod.with_split_retry(
                        lambda x: [x], b, "t", **kw):
                    seen.append(out.concrete_num_rows() if idx == 0
                                else out.num_rows)
            results.append((seen, _common(mod.retry_stats()),
                            fmod.fault_stats()["exec.batch"]))
        finally:
            fmod.disarm()
    assert results[1] == results[0]
    assert sum(results[1][0]) == sum(1000 + i for i in range(5))


def test_floor_escalates_as_in_jax():
    jb, pb = _long_batches(64)
    get_conf().set(JR.SPLIT_MIN_ROWS.key, 1024)

    def always(batch):
        raise FakeDeviceOOM()
        yield  # pragma: no cover

    with pytest.raises(FakeDeviceOOM):
        list(JR.with_split_retry(always, jb, "t"))
    with pytest.raises(FakeDeviceOOM):
        list(R.with_split_retry(always, pb, "t", R.RetryPolicy(
            backoff_s=0.0, min_split_rows=1024)))
    assert _common(R.retry_stats()) == _common(JR.retry_stats())


def test_no_duplicate_after_a_yield():
    _, b = _long_batches(256)

    def yields_then_dies(batch):
        yield batch
        raise FakeDeviceOOM()

    got = []
    with pytest.raises(FakeDeviceOOM):
        for out in R.with_split_retry(yields_then_dies, b, "t", POLICY):
            got.append(out)
    assert len(got) == 1
    assert _common(R.retry_stats()) == dict.fromkeys(COMMON, 0)


def test_run_with_oom_retry_as_in_jax():
    for mod, kw in ((JR, {}), (R, {"policy": POLICY})):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 2:
                raise FakeDeviceOOM()
            return "ok"

        assert mod.run_with_oom_retry(flaky, desc="t", **kw) == "ok"
        with pytest.raises(ValueError):
            mod.run_with_oom_retry(lambda: (_ for _ in ()).throw(
                ValueError("logic")), desc="t", **kw)
    assert _common(R.retry_stats()) == _common(JR.retry_stats())


def test_task_retries_as_in_jax():
    for mod, kw in ((JR, {}), (R, {"policy": POLICY})):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise FakeDeviceOOM()
            return "ok"

        assert mod.with_task_retries(flaky, **kw) == "ok"
        assert len(calls) == 3
    exhausted = R.RetryPolicy(max_failures=2, backoff_s=0.0)
    calls = []

    def always():
        calls.append(1)
        raise FakeDeviceOOM()

    with pytest.raises(FakeDeviceOOM):
        R.with_task_retries(always, policy=exhausted)
    assert len(calls) == 2
    with pytest.raises(ValueError):
        R.with_task_retries(lambda: (_ for _ in ()).throw(ValueError("x")),
                            policy=POLICY)
    assert _common(R.retry_stats())["task_retries"] \
        == _common(JR.retry_stats())["task_retries"] + 1


def test_a_real_allocator_oom_is_counted():
    _, b = _long_batches(4096)
    fails = {"n": 1}

    def run(batch):
        if fails["n"]:
            fails["n"] -= 1
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        yield batch

    assert len(list(R.with_split_retry(run, b, "t", POLICY))) == 1
    assert R.retry_stats()["device_ooms"] == 1


def test_alloc_device_seam_is_absorbed_by_the_store_as_in_jax():
    """The second reservation fails once at the seam: each store spills
    every unpinned entry, asks again, and credits the recovery."""
    from test_torch_memory import jax_batch, port_batch

    tiers = []
    for mod, fmod, make in ((jstore, jfaults, jax_batch),
                            (None, faults, port_batch)):
        store = mod.BufferStore(device_budget=1 << 30) if mod \
            else BufferStore(device_budget=1 << 30)
        fmod.install("alloc.device:nth=2", forced=True)
        try:
            hs = [store.register(make(30, i)) for i in range(3)]
            tiers.append(([h.tier.name for h in hs],
                          fmod.fault_stats()["alloc.device"]))
        finally:
            fmod.disarm()
            store.close()
    assert tiers[1] == tiers[0]
    assert tiers[1][1] == {"calls": 4, "injected": 1, "recovered": 1}


# -- bisection -------------------------------------------------------- #

@pytest.mark.parametrize("seams", [None, (300, 300, 400), (900, 100)])
def test_bisect_equals_jax(seams):
    vals = list(range(1000))
    strs = [f"s{i}" * (i % 4) for i in vals]
    schema = JT.Schema([JT.Field("x", JT.LONG), JT.Field("s", JT.STRING)])
    jb = JBatch.from_numpy({"x": np.asarray(vals),
                            "s": np.asarray(strs, object)}, schema)
    pb = from_arrow(pa.table({"x": vals, "s": strs}), CPU)
    if seams:
        jb.coalesce_seams = seams
        pb.coalesce_seams = seams
    jh = JR.bisect_batch(jb)
    ph = R.bisect_batch(pb)
    for j, p in zip(jh, ph):
        assert to_arrow(p).to_pydict() == j.to_pydict()
        assert getattr(p, "coalesce_seams", None) \
            == getattr(j, "coalesce_seams", None)


# -- queries under forced spill and forced split -------------------- #

class _Api:
    def __init__(self, **kw):
        self.__dict__.update(kw)


JAX = _Api(col=jcol, sum_=jsum, count=jcount, Window=JWX.Window,
           rank=JWX.rank)
PORT = _Api(col=P.col, sum_=P.sum_, count=P.count, Window=P.Window,
            rank=P.rank)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("retry")
    rng = np.random.default_rng(41)
    facts = []
    for i in range(3):
        n = 400
        t = pa.table({
            "k": pa.array(rng.integers(0, 64, n), pa.int64(),
                          mask=rng.random(n) < 0.1),
            "v": rng.random(n),
            "i": rng.integers(-1000, 1000, n),
            "s": [f"s{x}" for x in rng.integers(0, 50, n)]})
        facts.append(str(d / f"facts{i}.parquet"))
        pq.write_table(t, facts[-1])
    dims = str(d / "dims.parquet")
    pq.write_table(pa.table({"k2": np.arange(64),
                             "name": [f"n{j}" for j in range(64)]}), dims)
    return facts, [dims]


def q_shuffled_join(s, f, a):
    facts, dims = s.read_parquet(*f[0]), s.read_parquet(*f[1])
    return facts.join(dims, how="inner", left_on=[a.col("k")],
                      right_on=[a.col("k2")])


def q_broadcast_join(s, f, a):
    """Aggregated, so partials wait in the store between stream
    partitions and push the broadcast build down a tier."""
    return q_shuffled_join(s, f, a).group_by(a.col("name")).agg(
        (a.sum_(a.col("v")), "sv"), (a.count(a.col("i")), "n"))


def q_aggregate(s, f, a):
    return s.read_parquet(*f[0]).group_by(a.col("k")).agg(
        (a.sum_(a.col("v")), "sv"), (a.sum_(a.col("i")), "si"),
        (a.count(a.col("s")), "n"))


def q_window(s, f, a):
    w = a.Window.partition_by("k").order_by("i", "v")
    return s.read_parquet(*f[0]).select(
        "k", "i", "v", a.rank().over(w).alias("r"),
        a.sum_("i").over(w).alias("si"))


QUERIES = {"shuffled_join": (q_shuffled_join, {C.BROADCAST_THRESHOLD: -1}),
           "broadcast_join": (q_broadcast_join, {}),
           "aggregate": (q_aggregate, {}),
           "window": (q_window, {})}
BASE = {C.TASK_TARGET_BYTES: 1, C.BATCH_ROWS: 100,
        C.SHUFFLE_PARTITIONS: 4}


@pytest.fixture(scope="module")
def jax_results(files):
    out = {}
    for name, (q, _) in QUERIES.items():
        df = q(TpuSession(), files, JAX)
        out[name] = {e: df.collect(engine=e) for e in ("tpu", "cpu")}
    return out


@pytest.fixture(scope="module")
def unconstrained(files):
    out = {}
    for name, (q, extra) in QUERIES.items():
        s = TorchSession({**BASE, **extra}, device="cpu")
        out[name] = q(s, files, PORT).collect()
    return out


def _sorted_rows(t):
    return sorted((tuple(r.values()) for r in t.to_pylist()), key=repr)


def _plan_names(df):
    return {type(n).__name__ for n in df.physical_plan().walk()}


@pytest.mark.parametrize("name", list(QUERIES))
def test_forced_spill_equals_the_unconstrained_run(files, jax_results,
                                                   unconstrained, tmp_path,
                                                   name):
    q, extra = QUERIES[name]
    conf = {**BASE, **extra, C.HBM_BUDGET_BYTES: 1,
            C.HOST_SPILL_BYTES: 2048, C.SPILL_DIR: str(tmp_path)}
    with sized_plugin(conf):  # the process store, sized by this conf
        s = TorchSession(conf, device="cpu")
        df = q(s, files, PORT)
        assert ("TpuBroadcastHashJoinExec" if name == "broadcast_join"
                else "TpuShuffleExchangeExec") in _plan_names(df)
        got = df.collect()
        st = s.spill_stats()
        leaks = s.store.leak_report()
    assert _sorted_rows(got) == _sorted_rows(unconstrained[name])
    assert st["spilled_device_to_host"] > 0 and st["spilled_host_to_disk"] > 0
    assert st["restores"] > 0
    assert leaks == []
    assert not list(tmp_path.glob("spill-*"))
    assert R.retry_stats() == dict.fromkeys(R.retry_stats(), 0)
    for engine, want in jax_results[name].items():
        assert_tables_equal(got, want, approx_float=True), engine


@pytest.mark.parametrize("name", list(QUERIES))
def test_forced_split_equals_the_unconstrained_run(files, jax_results,
                                                   unconstrained, name):
    q, extra = QUERIES[name]
    s = TorchSession({**BASE, **extra, **C.SERIAL,
                      C.FAULTS_ENABLED: True, C.FAULTS_SPEC: SPLIT_SPEC,
                      C.SPLIT_MIN_ROWS: 16, C.RETRY_BACKOFF_S: 0.0},
                     device="cpu")
    got = q(s, files, PORT).collect()
    st = R.retry_stats()
    assert st["splits"] > 0 and st["task_retries"] == 0, st
    assert s.store.leak_report() == []
    assert_tables_equal(got, unconstrained[name], approx_float=True)
    for engine, want in jax_results[name].items():
        assert_tables_equal(got, want, approx_float=True), engine
    # the schedule was this query's only
    assert faults.fault_stats() == {}


def test_exchange_map_stage_splits(files):
    """A map batch bisected by the ladder: more blocks, the same rows;
    the exchange counts one more run of K1's partitioning per split."""
    t = pa.concat_tables([pq.read_table(p) for p in files[0]])
    src = ArrowSourceExec(t, T.Schema([
        T.Field("k", T.LONG), T.Field("v", T.DOUBLE), T.Field("i", T.LONG),
        T.Field("s", T.STRING)]), CPU, 500)
    ex = TpuShuffleExchangeExec(
        HashPartitioning([BoundReference(0, T.LONG, True, "k")], 4), src,
        ShuffleManager())
    ex.runtime = ex.runtime.__class__(ex.runtime.semaphore, retry=POLICY)
    faults.install(SPLIT_SPEC, forced=True)
    got = collect_exec(ex, C.TorchConf())
    st = R.retry_stats()
    assert st["splits"] == 1 and st["task_retries"] == 0, st
    assert ex.metrics["mapBatches"] == 3
    assert ex.metrics["mapBatchRuns"] == 3 + st["splits"]
    assert sorted(got.column("k").to_pylist(), key=repr) \
        == sorted(t.column("k").to_pylist(), key=repr)
    assert POLICY.get_store().leak_report() == []


def test_a_fault_the_ladder_cannot_absorb_raises_out_of_collect(files):
    """Every attempt fails: the ladder splits to its floor, then the
    query raises; nothing re-runs it on the CPU, and no entry leaks."""
    s = TorchSession({**BASE, **C.SERIAL, C.FAULTS_ENABLED: True,
                      C.FAULTS_SPEC: "exec.batch:every=1",
                      C.SPLIT_MIN_ROWS: 64, C.RETRY_BACKOFF_S: 0.0},
                     device="cpu")
    with pytest.raises(faults.InjectedFault):
        q_aggregate(s, files, PORT).collect()
    assert s.store.leak_report() == []


def test_coalesce_hook_off_by_default_and_seams_on(files):
    """``sql.coalesce.enabled``: off, no plan changes; on, a coalesce
    under every aggregate, join and sort, whose outputs keep their
    seams, and a split of a coalesced batch cuts at one of them."""
    from spark_rapids_tpu_torch.execs.coalesce import TpuCoalesceBatchesExec

    off = TorchSession({**BASE, C.BROADCAST_THRESHOLD: -1}, device="cpu")
    assert "TpuCoalesceBatchesExec" not in _plan_names(
        q_shuffled_join(off, files, PORT))
    conf = {**BASE, **C.SERIAL, C.COALESCE_ENABLED: True,
            C.COALESCE_TARGET_ROWS: 350}
    on = TorchSession(conf, device="cpu")
    plan = q_aggregate(on, files, PORT).physical_plan()
    co = [n for n in plan.walk() if isinstance(n, TpuCoalesceBatchesExec)]
    assert co and all(n.target_rows == 350 for n in co)
    want = q_aggregate(off, files, PORT).collect()
    got = collect_exec(plan, on.conf)
    assert_tables_equal(got, want, approx_float=True)
    assert sum(n.metrics["numConcats"] for n in co) > 0
    seen = []
    scan = next(n.children[0] for n in co
                if type(n.children[0]).__name__ == "ParquetScanExec")
    batches = list(scan.execute_partition(0))
    assert [b.num_rows for b in batches] == [100] * 4
    out = next(TpuCoalesceBatchesExec(_Replay(batches, scan),
                                      350).execute_partition(0))
    assert out.coalesce_seams == (100, 100, 100, 100)
    faults.install("exec.batch:nth=1,times=2", forced=True)
    for half in R.with_split_retry(lambda b: [b], out, "t", POLICY):
        seen.append(half.num_rows)
    assert seen[0] in {sum(out.coalesce_seams[:i])
                       for i in range(1, len(out.coalesce_seams))}
    assert sum(seen) == out.num_rows


class _Replay:
    """An exec that yields given batches as its one partition."""

    def __init__(self, batches, like):
        self.batches, self.schema = batches, like.schema
        self.num_partitions, self.output_partitioning = 1, None
        self.children = []

    def execute_partition(self, p):
        yield from self.batches
