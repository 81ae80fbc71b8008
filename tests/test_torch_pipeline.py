"""The port's pipeline stage (``parallel/pipeline.py``) and task
semaphore (``memory/semaphore.py``) on the CPU.

Each stage case runs the same generators through the JAX package's
``parallel.pipeline.prefetch`` and the port's ``prefetch`` and requires
equal outputs, as well as the contract itself: order, an exception in
stream order, a clean cancel on early exit, depth 0 inline, and stage
metrics.  The semaphore cases hold at most k holders among N threads,
idempotence per task, a release waking a waiter, and the nested
exchange (an aggregate over a partition-wise join over two exchanges)
finishing with one permit and four task threads.  Every wait has a
timeout (there is no pytest-timeout here).
"""

from __future__ import annotations

import sys
import threading
import time

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

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


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
