"""The port's serving tier (``spark_rapids_tpu_torch/serving/``) on the
CPU, held against the JAX package's (``spark_rapids_tpu/serving/``):
the process semaphore's resize and owner rules, the weighted-fair
scheduler (its grant order for a scripted queue equals the JAX one),
the prepared-plan cache (hits that never plan, keys, LRU, bindings),
cached exec trees drained again, streaming fetch, and N sessions x M
queries at once, bit for bit the serial run.  The same seeded tables
and templates run through ``TpuSession.prepare`` / ``SqlSession.prepare``
on the JAX CPU backend and through the port with ``device="cpu"``;
each pair gives equal digests (``eventlog.table_digest`` of the result
with every field nullable: the two engines differ in the nullability
they declare for a count).

Port of the intent of the JAX ``tests/test_serving.py``; left out are
its cases that read the trace, the event log, the query history and
HC009 (``test_stream_records_history_on_drain``,
``test_eventlog_serving_record``, ``test_hc009_...``), the bench smoke
tool, and the stress test's trace and event-log ownership checks."""

import threading
import time

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.config import TpuConf
from spark_rapids_tpu.frontends.sql import SqlSession as JSqlSession
from spark_rapids_tpu.memory.semaphore import TpuSemaphore as JSemaphore
from spark_rapids_tpu.serving import scheduler as jscheduler
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import count_star as jcount_star
from spark_rapids_tpu.session import sum_ as jsum

from spark_rapids_tpu_torch import TorchSession, col, sum_
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.eventlog import table_digest
from spark_rapids_tpu_torch.frontends.sql import SqlError, SqlSession
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.plan import planner as planner_mod
from spark_rapids_tpu_torch.plugin import TorchPlugin
from spark_rapids_tpu_torch.serving import (
    clear_serving_context,
    current_serving_context,
    update_serving_context,
)
from spark_rapids_tpu_torch.serving import plan_cache as plan_cache_mod
from spark_rapids_tpu_torch.serving import scheduler as scheduler_mod
from spark_rapids_tpu_torch.serving.plan_cache import PlanCache
from spark_rapids_tpu_torch.serving.scheduler import (
    AdmissionRejected,
    QueryScheduler,
    scheduler_stats,
)
from spark_rapids_tpu_torch.session import count_star

MAXC = C.SERVING_MAX_CONCURRENT


@pytest.fixture(autouse=True)
def _isolate_serving():
    scheduler_mod.reset()
    plan_cache_mod.reset_stats()
    clear_serving_context()
    TpuSemaphore.reset()
    yield
    scheduler_mod.reset()
    plan_cache_mod.reset_stats()
    clear_serving_context()
    TpuSemaphore.reset()


def _table(n=4096, keys=16, seed=7):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, keys, n).astype(np.int64),
        "v": rng.integers(0, 1000, n).astype(np.int64),
    })


def _agg_df(session, t, lo=0):
    """Integer sums in key order: digest-stable across runs and thread
    interleavings."""
    return (session.create_dataframe(t).where(col("v") >= lo)
            .group_by(col("k"))
            .agg((sum_(col("v")), "sv"), (count_star(), "n"))
            .order_by(col("k")))


def _jax_agg_df(session, t, lo=0):
    return (session.create_dataframe(t).where(jcol("v") >= lo)
            .group_by(jcol("k"))
            .agg((jsum(jcol("v")), "sv"), (jcount_star(), "n"))
            .order_by(jcol("k")))


def digest(t: pa.Table) -> str:
    """The table's digest with every field nullable."""
    return table_digest(t.cast(pa.schema(
        [f.with_nullable(True) for f in t.schema])))


def _sessions():
    return TorchSession(device="cpu"), TpuSession()


# ------------------------------------------------------------------ #
# The process semaphore
# ------------------------------------------------------------------ #


def test_semaphore_resize_wakes_waiters():
    sem = TpuSemaphore(1)
    sem.acquire_if_necessary("a")
    got = threading.Event()

    def waiter():
        sem.acquire_if_necessary("b")
        got.set()

    t = threading.Thread(target=waiter)
    t.start()
    assert not got.wait(0.1)
    sem.resize(2)
    assert got.wait(2.0)
    t.join()
    sem.release_if_necessary("a")
    sem.release_if_necessary("b")
    assert sem._available == 2


def test_semaphore_shrink_blocks_new_admissions():
    sem = TpuSemaphore(2)
    sem.acquire_if_necessary("a")
    sem.acquire_if_necessary("b")
    sem.resize(1)
    assert sem._available == -1
    sem.release_if_necessary("a")
    got = threading.Event()

    def waiter():
        sem.acquire_if_necessary("c")
        got.set()

    t = threading.Thread(target=waiter)
    t.start()
    assert not got.wait(0.1)
    sem.release_if_necessary("b")
    assert got.wait(2.0)
    t.join()


def test_semaphore_sync_conf_resizes_without_restart():
    conf = C.TorchConf()
    sem = TpuSemaphore.get(conf)
    base = sem.permits
    conf.set(C.CONCURRENT_TASKS, base + 3)
    TpuSemaphore.sync_conf(conf)
    assert TpuSemaphore.get() is sem and sem.permits == base + 3
    conf.set(C.CONCURRENT_TASKS, base)
    TpuSemaphore.sync_conf(conf)
    assert sem.permits == base


def test_semaphore_owner_rules_follow_the_jax_module():
    """One scripted sequence of confs through both modules' sync_conf:
    the permit counts after each step are equal (an explicit size
    resizes and owns; a default conf never moves another's resize; the
    owner moves it back)."""
    key = C.CONCURRENT_TASKS
    steps = [("a", 5), ("b", 2), ("c", 3), ("b", 2), ("c", 2), ("a", 2),
             ("a", 4), ("b", 2), ("a", 2)]

    def trajectory(sem_cls, conf_cls):
        sem_cls.reset()
        confs = {n: conf_cls() for n in "abc"}
        sem_cls.get()
        out = []
        for name, permits in steps:
            confs[name].set(key, permits)
            sem_cls.sync_conf(confs[name])
            out.append(sem_cls.get().permits)
        sem_cls.reset()
        return out

    port = trajectory(TpuSemaphore, C.TorchConf)
    jax = trajectory(JSemaphore, TpuConf)
    assert port == jax
    assert port[:3] == [5, 5, 3]


# ------------------------------------------------------------------ #
# The scheduler
# ------------------------------------------------------------------ #


def _fill(sched):
    return [sched.admit("filler") for _ in range(sched.max_concurrent)]


def _queue_async(sched, tenant, priority, order, name, group=None):
    def run():
        t = sched.admit(tenant, priority, group=group)
        order.append(name)
        sched.release(t)

    th = threading.Thread(target=run)
    th.start()
    return th


def _wait_waiting(sched, n):
    deadline = time.monotonic() + 5.0
    while sched.stats()["waiting"] < n:
        assert time.monotonic() < deadline, "entries never queued"
        time.sleep(0.005)


def _grant_order(sched_cls, script, batching=False, admitted=None):
    """Queue the scripted (tenant, priority, group) entries one at a
    time behind a held slot, then release it: the grant order (and, in
    ``admitted``, the admissions each tenant was counted)."""
    sched = sched_cls(max_concurrent=1, queue_depth=64, batching=batching)
    hold = _fill(sched)
    order: list = []
    threads = []
    for i, (tenant, prio, group) in enumerate(script):
        threads.append(_queue_async(sched, tenant, prio, order, i, group))
        _wait_waiting(sched, i + 1)
    for t in hold:
        sched.release(t)
    for th in threads:
        th.join(10.0)
    if admitted is not None:
        admitted.update({t: v["admitted"]
                         for t, v in sched.tenant_stats().items()})
    return order


def test_scheduler_weighted_fair_share():
    script = []
    for _ in range(4):
        script.append(("light", 1, None))
        script += [("heavy", 3, None)] * 3
    order = _grant_order(QueryScheduler, script)
    assert len(order) == 16
    first8 = [script[i][0] for i in order[:8]]
    assert first8.count("heavy") >= 5 and "light" in first8


@pytest.mark.parametrize("batching", [False, True])
def test_scheduler_grant_order_equals_the_jax_scheduler(batching):
    """A scripted queue of three tenants at priorities 1, 2 and 4 (with
    template groups, so batching has something to prefer) is granted in
    the same order by both schedulers."""
    rng = np.random.default_rng(3 + batching)
    tenants = {"t0": 1, "t1": 2, "t2": 4}
    script = [(t, tenants[t], f"g{rng.integers(0, 3)}")
              for t in rng.choice(list(tenants), 18)]
    admitted: dict = {}
    jax_admitted: dict = {}
    port = _grant_order(QueryScheduler, script, batching, admitted)
    jax = _grant_order(jscheduler.QueryScheduler, script, batching,
                       jax_admitted)
    assert port == jax and sorted(port) == list(range(18))
    assert admitted == jax_admitted and admitted["filler"] == 1


def test_scheduler_rejects_past_queue_depth():
    sched = QueryScheduler(max_concurrent=1, queue_depth=1)
    hold = _fill(sched)
    th = _queue_async(sched, "t", 1, [], "q1")
    _wait_waiting(sched, 1)
    with pytest.raises(AdmissionRejected, match="queue full"):
        sched.admit("t")
    assert sched.stats()["rejected"] == 1
    for t in hold:
        sched.release(t)
    th.join(5.0)


def test_scheduler_clamps_to_semaphore_permits():
    TpuSemaphore.reset()
    TpuSemaphore.get(C.TorchConf({C.CONCURRENT_TASKS: 2}))
    sched = QueryScheduler(max_concurrent=16, queue_depth=8)
    assert sched._limit() == 2
    TpuSemaphore.get().resize(5)
    assert sched._limit() == 5


def test_scheduler_records_wait_and_context():
    sched = QueryScheduler(max_concurrent=1, queue_depth=8)
    t1 = sched.admit("a")
    ctx = current_serving_context()
    assert ctx["tenant"] == "a" and ctx["admit_wait_ms"] == 0.0
    done = threading.Event()
    waited_ms = []

    def second():
        t2 = sched.admit("b", priority=2)
        waited_ms.append(current_serving_context()["admit_wait_ms"])
        sched.release(t2)
        done.set()

    th = threading.Thread(target=second)
    th.start()
    time.sleep(0.15)
    sched.release(t1)
    assert done.wait(5.0)
    th.join()
    assert waited_ms[0] >= 100.0
    st = sched.stats()
    assert st["admitted"] == 2 and st["wait_p99_ms"] >= 100.0


def test_admission_disabled_is_inert_and_reentrant():
    conf = C.TorchConf()
    with scheduler_mod.admission(conf) as ticket:
        assert ticket is None
    assert scheduler_stats()["admitted"] == 0
    conf.set(MAXC, 1)
    with scheduler_mod.admission(conf, tenant="x") as t1:
        assert t1 is not None
        with scheduler_mod.admission(conf, tenant="x") as t2:
            assert t2 is None
    assert scheduler_stats()["admitted"] == 1


def test_nested_admission_does_not_inherit_serving_context():
    conf = C.TorchConf({MAXC: 1})
    with scheduler_mod.admission(conf, tenant="outer"):
        update_serving_context(plan_cache="hit")
        assert current_serving_context()["tenant"] == "outer"
        with scheduler_mod.admission(conf, tenant="ignored"):
            assert current_serving_context() is None
        restored = current_serving_context()
        assert restored["tenant"] == "outer"
        assert restored["plan_cache"] == "hit"


# ------------------------------------------------------------------ #
# Cached exec trees drain again
# ------------------------------------------------------------------ #


def _join_frames(s, t, other, jcols=False):
    c = jcol if jcols else col
    left = s.create_dataframe(t)
    right = s.create_dataframe(other)
    return left.join(right, left_on=[c("k")], right_on=[c("dk")]) \
        .group_by(c("name")).agg((jsum(c("v")) if jcols else
                                   sum_(c("v")), "sv")).order_by(c("name"))


REDRAIN_KEYS = {
    # a broadcast join with its runtime filter
    "broadcast": {},
    # both sides exchanged; the adaptive join decides at run time
    "adaptive": {C.BROADCAST_THRESHOLD: -1, C.SHUFFLE_PARTITIONS: 4},
    # the static partition-wise join
    "shuffled": {C.BROADCAST_THRESHOLD: -1, C.SHUFFLE_PARTITIONS: 4,
                 C.ADAPTIVE_ENABLED: False},
}


@pytest.mark.parametrize("shape", list(REDRAIN_KEYS))
def test_exec_tree_is_redrainable(shape, tmp_path):
    """One lowered tree drained twice gives equal results, equal to the
    JAX engine's: join builds, exchanges, adaptive decisions and runtime
    filters all return to their pre-execute state on close."""
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.execs.adaptive import TpuAdaptiveJoinExec
    from spark_rapids_tpu_torch.execs.join import TpuRuntimeFilterBuildExec

    t = _table(n=6000, keys=64, seed=11)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"f{i}.parquet"))
        pq.write_table(t.slice(i * 2000, 2000), paths[-1])
    dim = pa.table({"dk": np.arange(0, 64, 3, dtype=np.int64),
                    "name": [f"n{i % 5}" for i in range(22)]})
    s = TorchSession({C.TASK_TARGET_BYTES: 1, C.BATCH_ROWS: 700,
                      **REDRAIN_KEYS[shape]}, device="cpu")
    df = s.read_parquet(*paths).join(
        s.create_dataframe(dim), left_on=[col("k")], right_on=[col("dk")]) \
        .group_by(col("name")).agg((sum_(col("v")), "sv")) \
        .order_by(col("name"))
    exec_, _meta = planner_mod.plan_query(df._plan, df._planner())
    r1 = planner_mod.collect_exec(exec_, s.conf)
    rfs = [rf for n in exec_.walk() if isinstance(n, TpuRuntimeFilterBuildExec)
           for _k, rf in n.entries]
    keys1 = [(rf.last.min_val, rf.last.max_val, rf.last.n_keys)
             for rf in rfs]
    # close() set each filter pending: the next drain's scans apply
    # nothing until its own build side has published
    assert not any(rf.ready for rf in rfs)
    adaptive = [n for n in exec_.walk() if isinstance(n, TpuAdaptiveJoinExec)]
    r2 = planner_mod.collect_exec(exec_, s.conf)
    assert table_digest(r1) == table_digest(r2)
    assert keys1 == [(rf.last.min_val, rf.last.max_val, rf.last.n_keys)
                     for rf in rfs]
    assert not any(rf.ready for rf in rfs)
    if shape == "broadcast":
        assert rfs, "no runtime filter was planned"
    if shape == "adaptive":
        assert adaptive and adaptive[0].metrics[
            "adaptiveBroadcasts"] + adaptive[0].metrics[
            "coalescedPartitions"] >= 0
    assert s.store.leak_report() == []
    js = TpuSession()
    jdf = js.read_parquet(*paths).join(
        js.create_dataframe(dim), left_on=[jcol("k")],
        right_on=[jcol("dk")]).group_by(jcol("name")).agg(
        (jsum(jcol("v")), "sv")).order_by(jcol("name"))
    assert digest(r1) == digest(jdf.collect(engine="tpu"))


@pytest.mark.parametrize("shape", list(REDRAIN_KEYS))
def test_a_prepared_plan_sees_a_rewritten_build_side(shape, tmp_path,
                                                      monkeypatch):
    """A plan-cache hit re-executes the cached tree, whose key holds no
    file statistics.  After the build side's file is rewritten with
    other keys, its runtime filter prunes with the new keys, never with
    the last drain's: the result equals a fresh collect's."""
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.execs.join import TpuRuntimeFilterBuildExec

    t = _table(n=6000, keys=64, seed=13)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"f{i}.parquet"))
        pq.write_table(t.slice(i * 2000, 2000), paths[-1])
    dim_path = str(tmp_path / "dim.parquet")

    def write_dim(lo):
        keys = np.arange(lo, lo + 16, dtype=np.int64)
        pq.write_table(pa.table({"dk": keys,
                                 "name": [f"n{k % 5}" for k in keys]}),
                       dim_path)

    def frame(s):
        return s.read_parquet(*paths).join(
            s.read_parquet(dim_path), left_on=[col("k")],
            right_on=[col("dk")]).group_by(col("name")).agg(
            (sum_(col("v")), "sv")).order_by(col("name"))

    keys = {C.TASK_TARGET_BYTES: 1, C.BATCH_ROWS: 700, **REDRAIN_KEYS[shape]}
    write_dim(0)
    s = TorchSession(keys, device="cpu")
    prepared = s.prepare(frame(s))
    first = prepared.execute()
    entry, _ = prepared._resolve(None)
    rfs = [rf for n in entry.exec_.walk()
           if isinstance(n, TpuRuntimeFilterBuildExec) for _k, rf in n.entries]
    if shape == "broadcast":
        assert rfs, "no runtime filter was planned"
    assert not any(rf.ready for rf in rfs)
    write_dim(40)
    calls = _counting_plan_query(monkeypatch)
    again = prepared.execute()
    assert calls[0] == 0
    assert [rf.last.min_val for rf in rfs] == [40] * len(rfs)
    monkeypatch.undo()
    fresh = frame(TorchSession(keys, device="cpu")).collect()
    assert again.num_rows > 0
    assert table_digest(again) == table_digest(fresh)
    assert table_digest(again) != table_digest(first)
    assert s.store.leak_report() == []


def test_an_adaptive_join_decides_again_on_a_redrain():
    """The decision is made per drain (from that drain's map output),
    and the last one stays readable after the tree is closed."""
    from spark_rapids_tpu_torch.execs.adaptive import TpuAdaptiveJoinExec

    t = _table(n=3000, keys=64, seed=5)
    dim = pa.table({"dk": np.arange(64, dtype=np.int64),
                    "name": [f"n{i % 7}" for i in range(64)]})
    s = TorchSession({C.BROADCAST_THRESHOLD: -1, C.BATCH_ROWS: 500,
                      C.SHUFFLE_PARTITIONS: 4}, device="cpu")
    pq_ = s.prepare(s.create_dataframe(t).join(
        s.create_dataframe(dim), left_on=[col("k")], right_on=[col("dk")])
        .group_by(col("name")).agg((sum_(col("v")), "sv"))
        .order_by(col("name")))
    entry, _ = pq_._resolve(None)
    [node] = [n for n in entry.exec_.walk()
              if isinstance(n, TpuAdaptiveJoinExec)]
    first = pq_.execute()
    decided = node._decided
    assert decided is not None and node._redrain
    second = pq_.execute()
    assert node._decided is not decided and node._decision != "undecided"
    assert table_digest(first) == table_digest(second)


# ------------------------------------------------------------------ #
# The prepared-plan cache
# ------------------------------------------------------------------ #


def _counting_plan_query(monkeypatch):
    calls = [0]
    orig = planner_mod.plan_query

    def counting(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(planner_mod, "plan_query", counting)
    return calls


def test_prepared_hit_skips_lowering_and_matches(monkeypatch):
    s, js = _sessions()
    t = _table()
    pq_ = s.prepare(_agg_df(s, t))
    first = pq_.execute()
    calls = _counting_plan_query(monkeypatch)
    second = pq_.execute()
    assert calls[0] == 0, "a cache hit entered plan_query"
    assert table_digest(first) == table_digest(second)
    st = plan_cache_mod.stats()
    assert st["hits"] >= 2 and st["misses"] == 1, st
    want = js.prepare(_jax_agg_df(js, t)).execute()
    assert digest(second) == digest(want)


def test_prepared_distinct_templates_distinct_entries():
    s = TorchSession(device="cpu")
    t = _table()
    pq1 = s.prepare(_agg_df(s, t))
    pq2 = s.prepare(s.create_dataframe(t).group_by(col("k"))
                    .agg((sum_(col("v")), "other_name")).order_by(col("k")))
    assert len(s.plan_cache) == 2
    assert pq1.execute().column_names != pq2.execute().column_names


def test_prepared_conf_epoch_changes_key():
    s = TorchSession(device="cpu")
    pq_ = s.prepare(_agg_df(s, _table()))
    pq_.execute()
    misses0 = plan_cache_mod.stats()["misses"]
    s.conf.set(C.BATCH_ROWS, 512)
    r = pq_.execute()
    assert plan_cache_mod.stats()["misses"] == misses0 + 1
    assert r.num_rows == 16


def test_plan_cache_lru_eviction_closes_and_recounts():
    s = TorchSession(device="cpu")
    s._plan_cache = PlanCache(capacity=2)
    t = _table()
    for i in range(3):
        s.prepare(s.create_dataframe(t).group_by(col("k"))
                  .agg((sum_(col("v")), f"sv{i}")).order_by(col("k")))
    st = plan_cache_mod.stats()
    assert st["evictions"] == 1 and len(s.plan_cache) == 2
    pq_ = s.prepare(s.create_dataframe(t).group_by(col("k"))
                    .agg((sum_(col("v")), "sv0")).order_by(col("k")))
    assert pq_.execute().num_rows == 16


def test_prepared_sql_template_params_and_bindings():
    t = _table()
    ss = SqlSession(device="cpu")
    ss.register_table("t", t)
    jss = JSqlSession()
    jss.register_table("t", t)
    text = ("select k, sum(v) as sv from t where k < :kmax "
            "group by k order by k")
    pq_ = ss.prepare(text)
    jpq = jss.prepare(text)
    assert pq_.param_names == jpq.param_names == frozenset({"kmax"})
    a8 = pq_.execute(params={"kmax": 8})
    b8 = pq_.execute(params={"kmax": 8})
    a4 = pq_.execute(params={"kmax": 4})
    assert a8.num_rows == 8 and a4.num_rows == 4
    assert table_digest(a8) == table_digest(b8)
    st = plan_cache_mod.stats()
    assert st["hits"] >= 1 and st["misses"] == 2, st
    for got, k in ((a8, 8), (a4, 4)):
        assert digest(got) == digest(jpq.execute(params={"kmax": k}))
    with pytest.raises(SqlError, match="unbound parameter :kmax"):
        pq_.execute()


def test_template_key_distinguishes_shared_subplans():
    from spark_rapids_tpu_torch.serving.plan_cache import template_key

    s = TorchSession(device="cpu")
    a = s.create_dataframe(_table(seed=1))
    b = s.create_dataframe(_table(seed=2))
    aa = a.union(b)
    aa._plan.children.append(a._plan)
    bb = a.union(b)
    bb._plan.children.append(b._plan)
    conf = s.conf
    assert template_key(aa._plan, conf) != template_key(bb._plan, conf)
    ab_a = a.union(b).union(s.create_dataframe(_table(seed=1)))
    assert template_key(ab_a._plan, conf)


def test_template_key_memoizes_table_content_digest():
    from spark_rapids_tpu_torch.plan import logical
    from spark_rapids_tpu_torch.serving.plan_cache import plan_structural_key

    s = TorchSession(device="cpu")
    df = s.create_dataframe(_table(seed=7))
    before = logical.digests_computed()
    k1 = plan_structural_key(df._plan)
    assert logical.digests_computed() == before + 1
    assert plan_structural_key(df._plan) == k1
    assert logical.digests_computed() == before + 1
    assert df._plan.content_digest() == table_digest(df._plan.table)


def test_template_key_is_structural_across_plan_objects():
    """Two DataFrames built alike (new plan objects, equal literals and
    tables) share a key; one literal apart, they do not."""
    from spark_rapids_tpu_torch.serving.plan_cache import template_key

    s = TorchSession(device="cpu")
    t = _table()
    k1 = template_key(_agg_df(s, t)._plan, s.conf)
    assert k1 == template_key(_agg_df(s, t)._plan, s.conf)
    assert k1 != template_key(_agg_df(s, t, lo=1)._plan, s.conf)


def test_sql_template_key_preserves_string_literal_whitespace():
    from spark_rapids_tpu_torch.serving.plan_cache import sql_template_key

    conf = C.TorchConf()
    k1 = sql_template_key("select * from t where s = 'a  b'", conf)
    k2 = sql_template_key("select * from t where s = 'a b'", conf)
    assert k1 != k2
    assert k1 == sql_template_key(
        "select *\n  from t\n where s = 'a  b'", conf)


def test_sql_named_params_inline_and_errors():
    import datetime as dt

    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.frontends.sql import _param_literal

    t = _table()
    ss = SqlSession(device="cpu")
    ss.register_table("t", t)
    out = ss.sql("select k, sum(v) as sv from t where k = :k group by k",
                 params={"k": 3}).collect()
    assert out.num_rows == 1 and out.to_pydict()["k"] == [3]
    assert _param_literal("s", "abc", 0).dtype == T.STRING
    assert _param_literal("b", True, 0).dtype == T.BOOLEAN
    dlit = _param_literal("d", dt.date(1996, 1, 1), 0)
    assert dlit.dtype == T.DATE and dlit.value == 9496
    assert _param_literal("n", None, 0).value is None
    with pytest.raises(SqlError, match="unbound parameter :missing"):
        ss.sql("select * from t where k = :missing")
    with pytest.raises(SqlError, match="unknown parameter"):
        ss.sql("select * from t where k = :k", params={"k": 1, "typo": 2})
    with pytest.raises(SqlError, match="unsupported type"):
        ss.sql("select * from t where k = :k", params={"k": [1, 2]})


def test_prepare_rejects_text_and_params_on_a_dataframe():
    s = TorchSession(device="cpu")
    with pytest.raises(TypeError):
        s.prepare("select 1")
    pq_ = s.prepare(_agg_df(s, _table()))
    with pytest.raises(ValueError, match="only valid for SQL"):
        pq_.execute(params={"k": 1})
    assert "TpuSortExec" in pq_.explain() or "Sort" in pq_.explain()


# ------------------------------------------------------------------ #
# Streaming fetch
# ------------------------------------------------------------------ #


def _stream_df(s, t):
    """A projection and filter: the output stays many batches."""
    return (s.create_dataframe(t).where(col("k") < col("v"))
            .select(col("k"), (col("v") + col("k")).alias("vk")))


def test_execute_stream_matches_collect_multibatch():
    s = TorchSession({C.BATCH_ROWS: 512}, device="cpu")
    t = _table(n=4096)
    pq_ = s.prepare(_stream_df(s, t))
    collected = pq_.execute()
    batches = list(pq_.execute_stream())
    assert len(batches) > 1, "the stream produced one batch"
    streamed = pa.Table.from_batches(batches, schema=collected.schema)
    assert table_digest(streamed) == table_digest(collected)
    rechunked = list(pq_.execute_stream(batch_rows=100))
    assert all(rb.num_rows <= 100 for rb in rechunked)
    assert table_digest(pa.Table.from_batches(
        rechunked, schema=collected.schema)) == table_digest(collected)
    js = TpuSession()
    jdf = (js.create_dataframe(t).where(jcol("k") < jcol("v"))
           .select(jcol("k"), (jcol("v") + jcol("k")).alias("vk")))
    jbatches = list(js.prepare(jdf).execute_stream())
    assert digest(streamed) == digest(pa.Table.from_batches(jbatches))


def test_execute_stream_early_close_releases_everything():
    s = TorchSession({C.BATCH_ROWS: 256, MAXC: 1}, device="cpu")
    pq_ = s.prepare(s.create_dataframe(_table(n=4096))
                    .where(col("k") >= 0).select(col("k"), col("v")))
    gen = pq_.execute_stream()
    next(gen)
    gen.close()
    out: list = []
    th = threading.Thread(target=lambda: out.append(pq_.execute()))
    th.start()
    th.join(60.0)
    assert out, "the abandoned stream kept its slot or its entry lock"
    assert out[0].num_rows == 4096
    assert scheduler_stats()["running"] == 0
    assert s.semaphore.usage()["in_use"] == 0
    assert s.store.leak_report() == []


def test_open_stream_same_thread_reexecute_raises_not_deadlocks():
    s = TorchSession({C.BATCH_ROWS: 256}, device="cpu")
    pq_ = s.prepare(s.create_dataframe(_table(n=2048))
                    .where(col("k") >= 0).select(col("k"), col("v")))
    gen = pq_.execute_stream()
    next(gen)
    with pytest.raises(RuntimeError, match="still draining"):
        pq_.execute()
    with pytest.raises(RuntimeError, match="still draining"):
        next(pq_.execute_stream())
    for _ in gen:
        pass
    assert pq_.execute().num_rows == 2048


def test_eviction_of_streaming_entry_does_not_block():
    s = TorchSession({C.BATCH_ROWS: 256}, device="cpu")
    s._plan_cache = PlanCache(capacity=1)
    t = _table(n=2048)
    pq1 = s.prepare(s.create_dataframe(t).where(col("k") >= 0)
                    .select(col("k")))
    gen = pq1.execute_stream()
    next(gen)
    pq2 = s.prepare(s.create_dataframe(t).where(col("v") >= 0)
                    .select(col("v")))
    assert plan_cache_mod.stats()["evictions"] == 1
    assert sum(b.num_rows for b in gen) > 0
    assert pq2.execute().num_rows == 2048


# ------------------------------------------------------------------ #
# The plugin, a smoke run, and the concurrent-sessions stress
# ------------------------------------------------------------------ #


def test_plugin_frontends_share_the_process_store():
    plugin = TorchPlugin.get_or_create(C.TorchConf(), "cpu")
    native = TorchSession(device="cpu")
    assert TorchPlugin.get_or_create() is plugin
    fe = plugin.session("sql")
    assert isinstance(fe, SqlSession)
    assert fe.session.store is native.store
    assert fe.session.semaphore is native.semaphore
    # the Substrait frontend registers itself on its first ask
    sub = plugin.session("substrait")
    assert sub.session.store is native.store
    assert sub.session.semaphore is native.semaphore
    with pytest.raises(KeyError, match="no frontend"):
        plugin.session("no_such_frontend")


def test_a_session_on_another_device_than_the_plugin_raises():
    """The store is sized for the plugin's device: a session on another
    one raises and leaves the live plugin as it was, but a host
    reference session beside a card's plugin shares its store."""
    from torch_plugin import sized_plugin

    from spark_rapids_tpu_torch.plugin import PluginMismatch

    with sized_plugin({}, "cpu") as plugin:
        with pytest.raises(PluginMismatch, match=r"TorchPlugin\.restart"):
            TorchPlugin.get_or_create(C.TorchConf(), "cuda")
        assert TorchPlugin.get_or_create(C.TorchConf(), "cpu") is plugin
        assert TorchPlugin.live() is plugin and not plugin._closed
    # an explicit budget sizes a card's store without asking the card
    with sized_plugin({C.HBM_BUDGET_BYTES: 1 << 20}, "cuda") as plugin:
        s = TorchSession({C.HBM_BUDGET_BYTES: 1 << 20}, device="cpu")
        assert s.plugin is plugin and s.store is plugin.store
        with pytest.raises(PluginMismatch, match="cuda:1"):
            TorchPlugin.get_or_create(C.TorchConf(), "cuda:1")


@pytest.mark.parametrize("key,value", [
    (C.HBM_BUDGET_BYTES, 2 << 20), (C.HOST_SPILL_BYTES, 7),
    (C.SPILL_DIR, "elsewhere"), (C.SPILL_CODEC, "zstd"),
    (C.MEMORY_FRACTION, 0.5)])
def test_a_session_with_other_store_keys_than_the_plugin_raises(key, value):
    """The memory keys size the store only when the plugin comes up: a
    later session that sets one to another value raises, where it
    would otherwise run silently on the live store's sizes."""
    from torch_plugin import sized_plugin

    from spark_rapids_tpu_torch.memory.store import get_store
    from spark_rapids_tpu_torch.plugin import PluginMismatch

    keys = {C.HBM_BUDGET_BYTES: 1 << 20}
    with sized_plugin(keys) as plugin:
        # the plugin's own values, and keys that size nothing, are fine
        assert TorchSession(keys, device="cpu").store is plugin.store
        TorchSession({C.TASK_TARGET_BYTES: 1}, device="cpu")
        with pytest.raises(PluginMismatch, match=key.replace(".", r"\.")):
            TorchSession({key: value}, device="cpu")
        assert get_store() is plugin.store
        assert plugin.store.device_budget == 1 << 20


def test_serving_smoke(monkeypatch):
    """Two sessions under maxConcurrent 1: the second execution of a
    prepared SQL template is a plan-cache hit that never enters
    plan_query, and its stream equals its collect bit for bit."""
    t = _table()
    conf = {MAXC: 1}
    fes = []
    for i in range(2):
        fe = SqlSession(conf, device="cpu", tenant=f"t{i}")
        fe.register_table("t", t)
        fes.append(fe)
    text = "select k, sum(v) as sv from t where v > :lo group by k order by k"
    pqs = [fe.prepare(text) for fe in fes]
    first = [pq_.execute(params={"lo": 100}) for pq_ in pqs]
    calls = _counting_plan_query(monkeypatch)
    again = [pq_.execute(params={"lo": 100}) for pq_ in pqs]
    streamed = pa.Table.from_batches(
        list(pqs[0].execute_stream(params={"lo": 100})),
        schema=first[0].schema)
    assert calls[0] == 0
    assert len({table_digest(x) for x in first + again + [streamed]}) == 1
    assert scheduler_stats()["admitted"] == 5
    assert plan_cache_mod.stats()["hits"] >= 3


def test_concurrent_sessions_stress():
    """4 sessions x 3 executions of a prepared template, each session
    with its own conf (batch rows), over 2 tenants, under admission:
    every result equals the serial run's digest bit for bit, and the
    serial run equals the JAX engine's."""
    n_sessions, m_iters = 4, 3
    t = _table(n=4096, keys=32)
    s0, js = _sessions()
    serial = {}
    for i in range(n_sessions):
        got = _agg_df(s0, t, lo=i).collect()
        serial[i] = table_digest(got)
        want = _jax_agg_df(js, t, lo=i).collect(engine="tpu")
        assert digest(got) == digest(want)
    errors: list = []

    def run(i: int) -> None:
        try:
            sess = TorchSession({C.BATCH_ROWS: 256 * (i + 1), MAXC: 2},
                                device="cpu", tenant=f"tenant{i % 2}",
                                priority=1 + (i % 2))
            pq_ = sess.prepare(_agg_df(sess, t, lo=i))
            for _ in range(m_iters):
                if table_digest(pq_.execute()) != serial[i]:
                    errors.append((i, "digest mismatch"))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(n_sessions)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120.0)
    assert not errors, errors
    st = scheduler_stats()
    assert st["admitted"] == n_sessions * m_iters and st["running"] == 0
    assert TpuSemaphore.get().usage()["in_use"] == 0
    assert s0.store.leak_report() == []


from torch_quiet import quiet_ladder  # noqa: E402,F401
