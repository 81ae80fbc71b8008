"""The port's runtime lock-order tracker
(``spark_rapids_tpu_torch/robustness/lock_tracker.py``) against the JAX
package's (``spark_rapids_tpu/robustness/lock_tracker.py``): each
scenario of the JAX ``tests/test_lock_tracker.py`` runs on both modules
and must give the same graph, counters and errors.  Left out: the JAX
event-log counter surface and its HC014 health rule (the event log is
not ported)."""

import threading

import pytest

from spark_rapids_tpu.config import TpuConf
from spark_rapids_tpu.robustness import lock_tracker as JLT
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.robustness import lock_tracker as PLT

ENABLED = "spark.rapids.tpu.robustness.lockTracker.enabled"

#: (module, a conf factory taking {key: value})
IMPLS = {
    "jax": (JLT, lambda kv=None: TpuConf(kv or {})),
    "port": (PLT, lambda kv=None: C.TorchConf(kv or {})),
}


@pytest.fixture(params=list(IMPLS))
def impl(request):
    lt, conf = IMPLS[request.param]
    lt.disarm()
    lt.reset_stats()
    yield lt, conf
    lt.disarm()
    lt.reset_stats()


def test_two_lock_cycle_raises_at_formation(impl):
    LT, _ = impl
    LT.install(forced=True)
    a = LT.tracked_lock("t.a")
    b = LT.tracked_lock("t.b")
    with a:
        with b:
            pass
    assert LT.order_graph() == {"t.a": ["t.b"]}
    with b:
        with pytest.raises(LT.LockCycleError) as ei:
            a.acquire()
    assert ei.value.edge == ("t.b", "t.a")
    assert ei.value.path == ["t.a", "t.b"]
    assert LT.cycle_count() == 1
    with a:  # the refused acquisition took nothing
        pass
    with b:
        pass


def test_transitive_cycle_detected_through_the_graph(impl):
    LT, _ = impl
    LT.install(forced=True)
    a, b, c = (LT.tracked_lock(n) for n in ("t3.a", "t3.b", "t3.c"))
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with c:
        with pytest.raises(LT.LockCycleError) as ei:
            a.acquire()
    assert ei.value.path == ["t3.a", "t3.b", "t3.c"]


def test_same_name_reacquisition_is_not_a_cycle(impl):
    LT, _ = impl
    LT.install(forced=True)
    a1 = LT.tracked_lock("pool.mu")
    a2 = LT.tracked_lock("pool.mu")
    with a1:
        with a2:
            pass
    assert LT.order_graph() == {}
    assert LT.cycle_count() == 0


def test_reentrant_lock_reentry_makes_no_edge(impl):
    LT, _ = impl
    LT.install(forced=True)
    r = LT.tracked_lock("t.r", reentrant=True)
    with r:
        with r:
            pass
    assert LT.order_graph() == {}
    assert LT.lock_stats()["t.r"]["acquisitions"] == 1


def test_nonblocking_acquire_never_raises_cycle(impl):
    LT, _ = impl
    LT.install(forced=True)
    a = LT.tracked_lock("nb.a")
    b = LT.tracked_lock("nb.b")
    with a:
        with b:
            pass
    with b:
        assert a.acquire(blocking=False) is True
        a.release()
    assert LT.cycle_count() == 0


def test_lock_stats_exact_bookkeeping(impl):
    LT, _ = impl
    LT.install(forced=True)
    a = LT.tracked_lock("s.a")
    b = LT.tracked_lock("s.b")
    for _ in range(3):
        with a:
            pass
    with b:
        pass
    st = LT.lock_stats()
    assert st["s.a"]["acquisitions"] == 3
    assert st["s.b"]["acquisitions"] == 1
    agg = LT.aggregate_stats()
    assert agg["acquisitions"] == 4 and agg["cycles"] == 0
    assert agg["max_hold_ms"] == max(v["max_hold_ms"] for v in st.values())


def test_contention_wait_is_counted(impl):
    LT, _ = impl
    LT.install(forced=True)
    a = LT.tracked_lock("c.a")
    entered = threading.Event()
    release = threading.Event()

    def holder():
        with a:
            entered.set()
            release.wait(5.0)

    th = threading.Thread(target=holder)
    th.start()
    entered.wait(5.0)
    got = []

    def contender():
        with a:
            got.append(True)

    th2 = threading.Thread(target=contender)
    th2.start()
    th2.join(0.2)
    release.set()
    th.join(5.0)
    th2.join(5.0)
    assert got == [True]
    st = LT.lock_stats()["c.a"]
    assert st["acquisitions"] == 2 and st["contention_waits"] == 1
    assert st["max_hold_ms"] > 0


def test_reset_stats_keeps_armed_state(impl):
    LT, _ = impl
    LT.install(forced=True)
    a = LT.tracked_lock("rs.a")
    with a:
        pass
    LT.reset_stats()
    assert LT.tracker_armed() and LT.lock_stats() == {}
    with a:
        pass
    assert LT.lock_stats()["rs.a"]["acquisitions"] == 1


def test_disarmed_records_nothing_and_passes_through(impl):
    LT, _ = impl
    a = LT.tracked_lock("d.a")
    b = LT.tracked_lock("d.b")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert LT.lock_stats() == {} and LT.order_graph() == {}
    assert LT.cycle_count() == 0


def test_release_after_disarm_mid_hold_is_safe(impl):
    LT, _ = impl
    a = LT.tracked_lock("flip.a")
    LT.install(forced=True)
    a.acquire()
    LT.disarm()
    a.release()
    a.acquire()
    LT.install(forced=True)
    a.release()
    with a:
        pass
    assert LT.lock_stats()["flip.a"]["acquisitions"] == 1


def test_sync_conf_arms_and_only_owner_disarms(impl):
    LT, conf_of = impl
    conf = conf_of({ENABLED: True})
    LT.sync_conf(conf)
    assert LT.tracker_armed()
    LT.sync_conf(conf_of())  # another session's default conf
    assert LT.tracker_armed()
    conf.set(ENABLED, False)
    LT.sync_conf(conf)
    assert not LT.tracker_armed()


def test_forced_install_survives_sync_conf(impl):
    LT, conf_of = impl
    LT.install(forced=True)
    LT.sync_conf(conf_of())
    assert LT.tracker_armed()


def test_both_packages_build_one_graph_from_one_schedule():
    """A seeded schedule of nested acquisitions gives the two modules
    the same order graph, the same counts and the same refusals."""
    import numpy as np

    names = [f"g.{i}" for i in range(6)]
    rng = np.random.default_rng(18)
    pairs = [tuple(rng.choice(6, 2, replace=False)) for _ in range(40)]
    out = []
    for LT in (JLT, PLT):
        LT.disarm()
        LT.install(forced=True)
        locks = [LT.tracked_lock(n) for n in names]
        refused = []
        for i, j in pairs:
            with locks[i]:
                try:
                    locks[j].acquire()
                except LT.LockCycleError as e:
                    refused.append(e.edge)
                else:
                    locks[j].release()
        out.append((LT.order_graph(), refused, LT.cycle_count(),
                    {k: v["acquisitions"]
                     for k, v in LT.lock_stats().items()}))
        LT.disarm()
        LT.reset_stats()
    assert out[0] == out[1]
    assert out[0][1], "the schedule formed no cycle"


def test_the_port_builds_its_engine_locks_from_the_tracker():
    """The pipeline's stage map and the serving tier's registries are
    tracked locks, as in JAX: a query run armed records them."""
    import pyarrow as pa

    from spark_rapids_tpu_torch import TorchSession, col, sum_
    from spark_rapids_tpu_torch.parallel import pipeline
    from spark_rapids_tpu_torch.serving import plan_cache, scheduler
    from spark_rapids_tpu_torch.serving import work_share

    assert isinstance(pipeline._STAGES_LOCK, PLT.TrackedLock)
    assert isinstance(scheduler._LOCK, PLT.TrackedLock)
    assert isinstance(work_share.RESULT_CACHE._mu, PLT.TrackedLock)
    assert isinstance(plan_cache.PlanCache(2)._mu, PLT.TrackedLock)
    PLT.disarm()
    PLT.reset_stats()
    s = TorchSession({ENABLED: True}, device="cpu")
    t = pa.table({"k": [1, 2, 1, 3], "v": [1.0, 2.0, 3.0, 4.0]})
    pq = s.prepare(s.create_dataframe(t).group_by(col("k")).agg(
        (sum_(col("v")), "s")))
    pq.execute()  # its query boundary arms the tracker
    pq.execute()
    try:
        st = PLT.lock_stats()
        assert st["pipeline.stages"]["acquisitions"] > 0
        assert st["planCache.mu"]["acquisitions"] >= 1
        assert PLT.cycle_count() == 0
    finally:
        PLT.disarm()
        PLT.reset_stats()


from torch_quiet import quiet_ladder  # noqa: E402,F401
