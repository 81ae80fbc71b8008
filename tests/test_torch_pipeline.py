"""The port's pipeline stage and deferred readbacks
(``parallel/pipeline.py``) and task semaphore (``memory/semaphore.py``)
on the CPU.

Each stage case runs the same generators through the JAX package's
``parallel.pipeline.prefetch`` and the port's ``prefetch`` and requires
equal outputs, as well as the contract itself: order, an exception in
stream order, a clean cancel on early exit, depth 0 inline, and stage
metrics.  The semaphore cases hold at most k holders among N threads,
idempotence per task, a release waking a waiter, and the nested
exchange (an aggregate over a partition-wise join over two exchanges)
finishing with one permit and four task threads.  Every wait has a
timeout (there is no pytest-timeout here).

The readback cases run seeded item lists through the JAX package's
``pipelined`` and the port's at depths 0-3 and require the same
(dispatch | readback) sequence from ``trace_events`` and the same
outputs; ``device_read_many`` and ``ReadbackFuture`` read what a plain
read does; ``guarded_pipeline`` re-dispatches under an injected
``exec.batch`` fault and gives the unfaulted result; q3 pooled equals
serial, bit for bit, with its readbacks counted under their tags.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.parallel import pipeline as JP
from spark_rapids_tpu_torch import TorchSession, col, sum_
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.execs.base import live_pool_threads
from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.parallel import pipeline as P

ENGINES = {"jax": JP.prefetch, "port": P.prefetch}


def both(make_gen, depth, stage):
    """The port's and the JAX prefetch over fresh generators: equal."""
    got = {k: list(f(make_gen(), depth=depth, stage=f"{stage}.{k}"))
           for k, f in ENGINES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_preserves_order(depth):
    assert both(lambda: iter(range(200)), depth, "t.order") == \
        list(range(200))


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_prefetch_raises_in_stream_order(engine):
    def gen():
        yield 1
        yield 2
        raise ValueError("decode failed")

    it = ENGINES[engine](gen(), depth=2, stage=f"t.err.{engine}")
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(ValueError, match="decode failed"):
        next(it)
    assert P.live_stage_threads() == 0


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_prefetch_cancels_cleanly_on_early_exit(engine):
    """Closing the consumer closes the producer's generator on the
    producer thread (its finally runs there) and joins the thread."""
    closed_on = []
    started = threading.Event()

    def gen():
        try:
            for i in range(10_000):
                started.set()
                yield i
        finally:
            closed_on.append(threading.current_thread())

    it = ENGINES[engine](gen(), depth=2, stage=f"t.cancel.{engine}")
    assert next(it) == 0
    assert started.wait(5)
    t0 = time.perf_counter()
    it.close()
    assert time.perf_counter() - t0 < 2.0
    assert len(closed_on) == 1
    assert closed_on[0] is not threading.current_thread()
    assert not closed_on[0].is_alive()
    assert P.live_stage_threads() == 0


def test_prefetch_depth_zero_runs_inline():
    seen = []

    def gen():
        seen.append(threading.current_thread())
        yield 1

    assert both(gen, 0, "t.inline") == [1]
    assert seen == [threading.current_thread()] * 2


def test_stage_metrics_accumulate():
    P.reset_stage_counters()
    assert both(lambda: iter(range(32)), 4, "t.metrics") == list(range(32))
    snap = P.stage_snapshot("t.metrics")["t.metrics.port"]
    assert snap["items"] == 32 and snap["depth"] == 4
    assert 0.0 <= snap["occupancy_fraction"] <= 1.0
    assert snap["producer_wait_s"] >= 0 and snap["consumer_wait_s"] >= 0
    P.reset_stage_counters()
    assert P.stage_snapshot("t.metrics") == {}


def test_stage_depth_follows_the_conf():
    assert P.stage_depth(C.TorchConf()) == 2
    assert P.stage_depth(C.TorchConf({C.PIPELINE_DEPTH: 5})) == 5
    assert P.stage_depth(C.TorchConf(C.SERIAL)) == 0
    with pytest.raises(ValueError):
        C.TorchConf({C.TASK_THREADS: 0})


# -- the task semaphore ---------------------------------------------------- #


def _join_all(threads, timeout=20.0):
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in threads), "threads still waiting"


def test_at_most_k_holders_among_n_threads():
    sem = TpuSemaphore(3)
    lock = threading.Lock()
    held, peak = [0], [0]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def task(i):
            for j in range(20):
                tid = (i, j)
                sem.acquire_if_necessary(tid)
                with lock:
                    held[0] += 1
                    peak[0] = max(peak[0], held[0])
                time.sleep(0.0005)
                with lock:
                    held[0] -= 1
                sem.release_if_necessary(tid)

        threads = [threading.Thread(target=task, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        _join_all(threads)
    finally:
        sys.setswitchinterval(old)
    assert peak[0] == 3
    assert sem.usage() == {"permits": 3, "in_use": 0, "holders": []}


def test_acquire_is_idempotent_per_task():
    sem = TpuSemaphore(2)
    for _ in range(3):
        sem.acquire_if_necessary("a")
    assert sem.usage()["in_use"] == 1
    sem.acquire_if_necessary("b")
    assert sem.usage()["in_use"] == 2
    sem.release_if_necessary("a")
    sem.release_if_necessary("a")  # a second release is a no-op
    assert sem.usage()["in_use"] == 1
    # the same task from many threads takes one permit
    threads = [threading.Thread(target=sem.acquire_if_necessary,
                                args=("c",)) for _ in range(8)]
    for t in threads:
        t.start()
    _join_all(threads)
    assert sem.usage()["in_use"] == 2
    with pytest.raises(ValueError):
        TpuSemaphore(0)


def test_release_wakes_a_waiter():
    sem = TpuSemaphore(1)
    sem.acquire_if_necessary("holder")
    got = threading.Event()

    def waiter():
        sem.acquire_if_necessary("waiter")
        got.set()

    t = threading.Thread(target=waiter)
    t.start()
    assert not got.wait(0.2)
    sem.release_if_necessary("holder")
    assert got.wait(10)
    _join_all([t])
    assert sem.usage()["holders"] == ["'waiter'"]


def test_nested_exchange_finishes_with_one_permit(tmp_path):
    """An aggregate over a partition-wise join over two exchanges, one
    permit and four task threads: each outer map task pulls a join
    partition, which runs both inner map stages (whose tasks need a
    permit) before the outer task takes its own."""
    paths = []
    for i in range(4):
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(pa.table({"k": pa.array(range(i, 400, 4), pa.int64()),
                                 "v": pa.array([float(i)] * 100)}), p)
        paths.append(p)
    s = TorchSession({"spark.rapids.tpu.sql.scan.taskTargetBytes": 1,
                      "spark.rapids.tpu.sql.autoBroadcastJoinThresholdBytes":
                          -1,
                      C.CONCURRENT_TASKS: 1, C.TASK_THREADS: 4},
                     device="cpu")
    left = s.read_parquet(*paths)
    right = s.read_parquet(*paths).select(col("k").alias("k2"),
                                          col("v").alias("w"))
    df = left.join(right, left_on=[col("k")], right_on=[col("k2")]) \
        .group_by(col("v")).agg((sum_(col("w")), "sw"))
    plan = df.physical_plan()
    assert sum(isinstance(n, TpuShuffleExchangeExec)
               for n in plan.walk()) == 3
    out = {}
    t = threading.Thread(target=lambda: out.update(r=df.collect()))
    t.start()
    _join_all([t], timeout=60)
    rows = sorted(out["r"].to_pylist(), key=lambda r: r["v"])
    assert rows == [{"v": float(i), "sw": 100.0 * i} for i in range(4)]
    assert s.semaphore.usage()["in_use"] == 0
    assert P.live_stage_threads() == 0 and live_pool_threads() == 0


# --------------------------------------------------------------------- #
# Deferred readbacks
# --------------------------------------------------------------------- #


def _run_pipelined(mod, array, items, depth):
    """``mod.pipelined`` over ``items`` whose dispatch makes a device
    value and whose retire reads it back; (trace events, outputs)."""
    def dispatch(x):
        return array(x) * 3

    def retire(state):
        return [int(mod.device_read(state, tag="t.pipe"))]

    with mod.trace_events() as events:
        out = list(mod.pipelined(iter(items), dispatch, retire, depth=depth,
                                 tag="t.pipe"))
    return events, out


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_pipelined_order_matches_jax(depth, seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    items = [int(v) for v in rng.integers(0, 1000, int(rng.integers(0, 9)))]
    jev, jout = _run_pipelined(JP, jnp.asarray, items, depth)
    pev, pout = _run_pipelined(P, torch.tensor, items, depth)
    assert pev == jev
    assert pout == jout == [3 * v for v in items]
    if depth and len(items) > depth:
        # item k+1 is dispatched before item k retires
        assert pev[:depth + 1] == [("dispatch", "t.pipe")] * (depth + 1)


def test_device_read_many_reads_what_plain_reads_read():
    xs = [torch.tensor(3), torch.tensor([1, 2, 3]), 7,
          torch.tensor(2.5, dtype=torch.float64),
          torch.tensor([[4, 5]], dtype=torch.int32), torch.tensor(True)]
    P.reset_stage_counters()
    got = P.device_read_many(xs, tag="t.many")
    assert len(got) == len(xs)
    for g, x in zip(got, xs):
        want = x.numpy() if isinstance(x, torch.Tensor) else x
        assert np.array_equal(g, want) and np.shape(g) == np.shape(want)
    assert P.stage_snapshot("t.many")["t.many"]["readbacks"] == 1
    assert P.device_read_many([1, 2.0], tag="t.host") == [1, 2.0]
    assert "t.host" not in P.stage_snapshot()


def test_readback_future_reads_what_a_plain_read_reads():
    P.reset_stage_counters()
    x = torch.arange(10, dtype=torch.int64) * 7
    fut = P.device_read_async(x, tag="t.async")
    assert fut.done()
    assert np.array_equal(fut.result(), x.numpy())
    assert np.array_equal(fut.result(), P.device_read(x))
    st = P.stage_snapshot("t.async")["t.async"]
    assert (st["async_readbacks"], st["readbacks"]) == (1, 0)
    assert P.device_read_async(5).result() == 5
    assert P.device_read_int(torch.tensor(41)) == 41


def test_guarded_pipeline_redispatches_under_an_injected_fault():
    """exec.batch faults at calls 2-4: batches 2 and 3 fail at their
    dispatch (item k+1 is dispatched before item k retires), so each
    retires into the ladder; batch 2's re-run fails again and is
    bisected.  The same rows out as without faults."""
    from spark_rapids_tpu_torch.columnar.arrow import from_arrow
    from spark_rapids_tpu_torch.execs import retry as R
    from spark_rapids_tpu_torch.memory.store import BufferStore
    from spark_rapids_tpu_torch.robustness import faults

    rng = np.random.default_rng(4)
    batches = [from_arrow(pa.table({"v": rng.integers(0, 100, 64)}),
                          torch.device("cpu")) for _ in range(4)]
    policy = R.RetryPolicy(backoff_s=0.0, min_split_rows=4,
                           store=BufferStore())
    dispatched = []

    def dispatch(b):
        dispatched.append(b.num_rows)
        return b, b.columns[0].data.sum()

    def retire(entry):
        b, total = entry
        return [(b.num_rows, P.device_read_int(total, tag="t.guard"))]

    def run():
        d, r = R.guarded_pipeline(dispatch, retire, "t.guard", policy)
        return list(P.pipelined(iter(batches), d, r, depth=1))

    want = run()
    n_clean = len(dispatched)
    R.reset_retry_stats()
    faults.install("exec.batch:nth=2,times=3", forced=True)
    try:
        got = run()
        stats = faults.fault_stats()
    finally:
        faults.disarm()
    st = R.retry_stats()
    # the ladder's counters are this test's own: zeroed once read, so
    # the module's quiet-ladder check holds for every other test
    R.reset_retry_stats()
    assert stats["exec.batch"]["injected"] == 3
    assert st["spill_retries"] == 2 and st["splits"] == 1, st
    assert sum(n for n, _ in got) == sum(n for n, _ in want) == 256
    assert sum(t for _, t in got) == sum(t for _, t in want)
    assert len(got) == len(want) + 1  # the bisected batch's two halves
    # the faulted dispatches never ran; batch 2 ran as its two halves
    assert len(dispatched) - n_clean == n_clean + 1


@pytest.mark.parametrize("speculation", [False, True],
                         ids=["speculation_off", "speculation_on"])
def test_q3_pooled_equals_serial_with_readbacks_counted(tmp_path,
                                                        speculation):
    """Off, every sizing read blocks: one ``exchange.split`` readback
    per hashed map batch and one ``join.probe`` per stream batch.  On
    (the default), the split counts are all asynchronous, and
    ``join.probe`` blocks only for the predictor's warm-up batches."""
    from spark_rapids_tpu_torch.parallel import speculation as SP
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.plan.planner import collect_exec

    li = tpch.make_lineitem(str(tmp_path), n_files=3, with_orderkey=True,
                            n_orders=1024, rows_per_file=2048)
    orders = tpch.make_orders(str(tmp_path), n_orders=1024)
    runs = {}
    for mode, extra in (("serial", C.SERIAL), ("pooled", {})):
        s = TorchSession({C.TASK_TARGET_BYTES: 1, C.BROADCAST_THRESHOLD: -1,
                          C.SPECULATION_ENABLED: speculation, **extra},
                         device="cpu")
        plan = tpch.q3_dataframe(s, li, orders).physical_plan()
        P.reset_stage_counters()
        SP.reset_predictors()
        SP.reset_stats()
        out = collect_exec(plan, s.conf)
        snap = P.stage_snapshot()
        hashed = sum(n.metrics["mapBatches"] for n in plan.walk()
                     if isinstance(n, TpuShuffleExchangeExec)
                     and n.num_partitions > 1)
        runs[mode] = (out, {k: v["readbacks"] for k, v in snap.items()
                            if v["readbacks"]},
                      {k: v["async_readbacks"] for k, v in snap.items()
                       if v["async_readbacks"]}, hashed, SP.stats())
    (serial, sr, sa, sh, ss), (pooled, pr, pa_, ph, ps) = \
        runs["serial"], runs["pooled"]
    assert pooled.equals(serial) and serial.num_rows == 10
    if not speculation:
        assert sr == pr
        assert sr["exchange.split"] == sh == ph > 0
        assert sr["join.probe"] > 0 and sr["rf.build"] == 1
        assert sa == pa_ == {} and ss == ps == {}
        return
    for blocking, async_, hashed_, st in ((sr, sa, sh, ss),
                                          (pr, pa_, ph, ps)):
        assert "exchange.split" not in blocking
        assert async_["exchange.split"] == hashed_ > 0
        # the warm-up batches block, the rest speculate
        probe = st["join.probe"]
        assert blocking["join.probe"] == probe["synced"] >= 1
        assert async_["join.probe"] == probe["hits"] + probe["overflows"] > 0
        assert blocking["rf.build"] == 1
        assert async_["agg.size"] > 0
    assert sh == ph


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
