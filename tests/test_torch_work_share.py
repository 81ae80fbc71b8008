"""Cross-tenant work sharing in the port (``plan/share_key.py``,
``serving/work_share.py``) on the CPU: the share keys and the
determinism gate, the result cache (Arrow IPC frames as HOST entries of
the process store: round trip, invalidation by the input files' stat
triples, LRU, spill and restore), the shared-scan registry, admission
batching, and whole queries: a second tenant served from the result
cache, a scan riding another's decode, each against the JAX engine's
result (digests of the results with every field nullable).

Port of the intent of the JAX ``tests/test_work_share.py``; left out
are its event-log and history cases (``test_result_cache_hit_records_
full_lifecycle``, ``test_cached_tree_records_per_execution_metric_
deltas``), HC012, the shared-array registry of JAX device arrays
(``test_mark_shared_array_identity_and_gc``: the port shares no device
batch, which ``test_subscribers_upload_their_own_tensors`` checks) and
the lock-snapshot regressions of its lint rules."""

import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.serving import scheduler as jscheduler
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import sum_ as jsum

from spark_rapids_tpu_torch import TorchSession, col, sum_
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.eventlog import table_digest
from spark_rapids_tpu_torch.frontends.sql import SqlSession
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.plan.share_key import (
    plan_is_shareable,
    plan_share_key,
    plan_source_digests,
    scan_share_key,
)
from spark_rapids_tpu_torch.serving import scheduler as scheduler_mod
from spark_rapids_tpu_torch.serving import work_share as ws
from spark_rapids_tpu_torch.serving.scheduler import QueryScheduler
from spark_rapids_tpu_torch.session import rand

SHARE = {C.SHARING_ENABLED: True}


@pytest.fixture(autouse=True)
def _isolate_sharing():
    ws.reset()
    scheduler_mod.reset()
    TpuSemaphore.reset()
    yield
    ws.reset()
    scheduler_mod.reset()
    TpuSemaphore.reset()


def _table(n=4096, keys=16, seed=7):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, keys, n).astype(np.int64),
        "v": rng.integers(0, 1000, n).astype(np.int64),
    })


def _agg_df(session, t):
    return (session.create_dataframe(t).group_by(col("k"))
            .agg((sum_(col("v")), "sv")).order_by(col("k")))


def digest(t: pa.Table) -> str:
    return table_digest(t.cast(pa.schema(
        [f.with_nullable(True) for f in t.schema])))


def _files(tmp_path, t, n=3, name="f"):
    paths = []
    step = t.num_rows // n
    for i in range(n):
        paths.append(str(tmp_path / f"{name}{i}.parquet"))
        pq.write_table(t.slice(i * step, step), paths[-1])
    return paths


# ------------------------------------------------------------------ #
# Keys and the determinism gate
# ------------------------------------------------------------------ #


def test_plan_share_key_structural_identity():
    s = TorchSession(device="cpu")
    t = _table()
    k1 = plan_share_key(_agg_df(s, t)._plan, s.conf)
    assert k1 is not None
    assert plan_share_key(_agg_df(s, t)._plan, s.conf) == k1
    assert plan_share_key(_agg_df(s, _table(seed=8))._plan, s.conf) != k1


def test_plan_share_key_conf_sensitivity():
    s = TorchSession(device="cpu")
    plan = _agg_df(s, _table())._plan
    a = plan_share_key(plan, C.TorchConf())
    b = plan_share_key(plan, C.TorchConf({C.BATCH_ROWS: 512}))
    assert a is not None and b is not None and a != b


def test_determinism_gate_excludes_nondeterministic():
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.udf import torch_udf

    @torch_udf(T.LONG)
    def ident(v):
        return v

    s = TorchSession(device="cpu")
    base = s.create_dataframe(_table())
    assert plan_is_shareable(base.where(col("k") > 3)._plan)
    assert not plan_is_shareable(base.select(col("k"), rand(3))._plan)
    assert not plan_is_shareable(base.select(ident(col("v")))._plan)
    cached = s.create_dataframe(_table()).cache()
    assert not plan_is_shareable(cached.where(col("k") > 3)._plan)
    assert plan_share_key(cached._plan, s.conf) is None
    # a subtree under an unshareable parent keeps its identity
    assert plan_share_key(base.select(col("k"), rand(3))._plan.children[0],
                          s.conf) is not None


def test_plan_source_digests_track_file_content(tmp_path):
    s = TorchSession(device="cpu")
    p = str(tmp_path / "t.parquet")
    pq.write_table(_table(), p)
    plan = s.read_parquet(p).where(col("k") > 1)._plan
    d1 = plan_source_digests(plan)
    assert d1 == [(p,) + d1[0][1:]] and d1[0][1] == os.stat(p).st_size
    time.sleep(0.01)
    pq.write_table(_table(n=100), p)
    assert plan_source_digests(plan) != d1
    os.remove(p)
    with pytest.raises(OSError):
        plan_source_digests(plan)


def test_scan_share_key_gates(tmp_path):
    p = str(tmp_path / "t.parquet")
    pq.write_table(_table(), p)
    conf = C.TorchConf()

    def scan(**kw):
        base = dict(runtime_filters=[], columns=["k", "v"], batch_rows=1024,
                    pushed_filter=None, exact_prefilter=False,
                    input_files=False, device="cpu",
                    task_paths=lambda task: [p])
        base.update(kw)
        return SimpleNamespace(**base)

    k1 = scan_share_key(scan(), 0, conf)
    assert k1 is not None and scan_share_key(scan(), 0, conf) == k1
    assert scan_share_key(scan(), 1, conf) != k1
    assert scan_share_key(scan(columns=["k"]), 0, conf) != k1
    assert scan_share_key(scan(pushed_filter=col("k") > 2), 0, conf) != k1
    assert scan_share_key(scan(runtime_filters=[object()]), 0, conf) is None


# ------------------------------------------------------------------ #
# The result cache
# ------------------------------------------------------------------ #

BUDGET = 256 << 20


def test_result_cache_roundtrip_bit_identical():
    s = TorchSession(device="cpu")
    t = _agg_df(s, _table()).collect()
    assert ws.RESULT_CACHE.insert("k1", [], t, BUDGET)
    got = ws.RESULT_CACHE.lookup("k1", [])
    assert got is not None and table_digest(got) == table_digest(t)
    st = ws.stats()
    assert st["result_hits"] == 1 and st["result_inserts"] == 1
    entry = ws.RESULT_CACHE._entries["k1"]
    assert entry.handle.tier.name == "HOST"


def test_result_cache_invalidates_on_digest_change():
    TorchSession(device="cpu")
    t = pa.table({"a": [1, 2, 3]})
    assert ws.RESULT_CACHE.insert("k1", [("f", 10, 100)], t, BUDGET)
    assert ws.RESULT_CACHE.lookup("k1", [("f", 10, 200)]) is None
    st = ws.stats()
    assert st["result_invalidations"] == 1 and st["result_misses"] == 1
    assert len(ws.RESULT_CACHE) == 0


def test_result_cache_lru_eviction_and_oversize():
    TorchSession(device="cpu")
    t = pa.table({"a": np.arange(256, dtype=np.int64)})
    budget = int(len(ws._table_ipc(t)) * 4.5)
    for k in "abcdef":
        assert ws.RESULT_CACHE.insert(k, [], t, budget)
    assert ws.stats()["result_evictions"] >= 1
    assert ws.RESULT_CACHE.lookup("a", []) is None
    assert ws.RESULT_CACHE.lookup("f", []) is not None
    big = pa.table({"a": np.arange(4096, dtype=np.int64)})
    assert not ws.RESULT_CACHE.insert("big", [], big, budget)


def test_result_cache_spills_and_restores_through_store(tmp_path):
    """A 1-byte host budget sends the frame to disk at once; a lookup
    reads it back bit for bit; a plugin restart (the store closed)
    reads as a miss, never a broken hit."""
    from torch_plugin import sized_plugin

    conf = {C.HOST_SPILL_BYTES: 1, C.SPILL_DIR: str(tmp_path)}
    with sized_plugin(conf) as plugin:
        s = TorchSession(device="cpu")
        t = _agg_df(s, _table()).collect()
        assert ws.RESULT_CACHE.insert("k", [], t, BUDGET)
        assert plugin.store.spilled_host_to_disk > 0
        got = ws.RESULT_CACHE.lookup("k", [])
        assert got is not None and table_digest(got) == table_digest(t)
    assert ws.RESULT_CACHE.lookup("k", []) is None
    assert len(ws.RESULT_CACHE) == 0


# ------------------------------------------------------------------ #
# The shared-scan registry
# ------------------------------------------------------------------ #


def test_scan_share_subscriber_replays_in_publish_order():
    e = ws.ScanShareEntry("k")
    t1, t2 = pa.table({"a": [1]}), pa.table({"a": [2]})
    e.publish(t1)
    e.publish(t2)
    e.complete()
    assert list(e.subscribe_units()) == [t1, t2] and e.done


def test_scan_share_abort_wakes_subscriber_for_fallback():
    e = ws.ScanShareEntry("k")
    e.publish(pa.table({"a": [1]}))
    consumed, raised = [], threading.Event()

    def sub():
        try:
            for u in e.subscribe_units():
                consumed.append(u)
        except ws.ScanShareAborted:
            raised.set()

    th = threading.Thread(target=sub)
    th.start()
    while not consumed:
        th.join(0.01)
    e.abort()
    th.join(5.0)
    assert raised.is_set() and len(consumed) == 1


def test_scan_registry_same_thread_never_subscribes_itself():
    e, leader = ws.SCAN_REGISTRY.begin("k")
    assert leader and e is not None
    assert ws.SCAN_REGISTRY.begin("k") == (None, False)
    e.complete()
    ws.SCAN_REGISTRY.release(e, BUDGET)
    e3, leader3 = ws.SCAN_REGISTRY.begin("k")
    assert e3 is e and not leader3
    ws.SCAN_REGISTRY.release(e3, BUDGET)


def test_scan_registry_budget_evicts_completed_never_inflight():
    done, leader = ws.SCAN_REGISTRY.begin("done")
    done.publish(pa.table({"a": [1, 2, 3]}))
    done.complete()
    ws.SCAN_REGISTRY.release(done, 0)
    assert len(ws.SCAN_REGISTRY) == 0
    live, leader = ws.SCAN_REGISTRY.begin("live")
    live.publish(pa.table({"a": [1, 2, 3]}))
    ws.SCAN_REGISTRY._enforce_budget(0)
    assert len(ws.SCAN_REGISTRY) == 1 and not live.done


def test_scan_share_inflight_overflow_self_aborts():
    t = pa.table({"a": np.arange(1000, dtype=np.int64)})
    e, _ = ws.SCAN_REGISTRY.begin("big", cap=t.nbytes + 1)
    e.publish(t)
    assert not e._aborted
    e.publish(t)
    assert e._aborted and ws.stats()["scan_overflows"] == 1
    with pytest.raises(ws.ScanShareAborted):
        list(e.subscribe_units())
    ws.SCAN_REGISTRY.release(e, BUDGET)
    assert len(ws.SCAN_REGISTRY) == 0


# ------------------------------------------------------------------ #
# Admission batching
# ------------------------------------------------------------------ #


def _grant_order(sched_cls, batching):
    """Two slots, one running group "g"; three queued entries, the
    second in group "g"; the other slot frees: the order they are
    granted in (batching prefers the running group)."""
    sched = sched_cls(max_concurrent=2, queue_depth=8, batching=batching)
    running = sched.admit("a", group="g")
    filler = sched.admit("z")
    order: list = []
    threads = []
    for i, (tenant, group) in enumerate([("b", None), ("c", "g"),
                                         ("d", None)]):
        def run(i=i, tenant=tenant, group=group):
            t = sched.admit(tenant, group=group)
            order.append(i)
            sched.release(t)
        th = threading.Thread(target=run)
        th.start()
        threads.append(th)
        while sched.stats()["waiting"] < i + 1:
            time.sleep(0.005)
    sched.release(filler)
    for th in threads:
        th.join(5.0)
    sched.release(running)
    return order, sched.stats()["coalesced"]


@pytest.mark.parametrize("batching", [True, False])
def test_admission_batching_order_equals_the_jax_scheduler(batching):
    port = _grant_order(QueryScheduler, batching)
    jax = _grant_order(jscheduler.QueryScheduler, batching)
    assert port == jax
    assert port[0] == ([1, 0, 2] if batching else [0, 1, 2])


# ------------------------------------------------------------------ #
# Whole queries
# ------------------------------------------------------------------ #


def test_second_tenant_served_from_result_cache(tmp_path):
    t = _table(n=6000)
    paths = _files(tmp_path, t)
    text = "select k, sum(v) as sv from t group by k order by k"
    outs = []
    for tenant in ("t0", "t1"):
        fe = SqlSession(SHARE, device="cpu", tenant=tenant)
        fe.register_parquet("t", *paths)
        outs.append(fe.sql(text).collect())
    st = ws.stats()
    assert st["result_misses"] == 1 and st["result_hits"] == 1
    assert table_digest(outs[0]) == table_digest(outs[1])
    js = TpuSession()
    want = js.read_parquet(*paths).group_by(jcol("k")).agg(
        (jsum(jcol("v")), "sv")).order_by(jcol("k")).collect(engine="tpu")
    assert digest(outs[1]) == digest(want)


def test_result_cache_invalidates_when_a_source_file_changes(tmp_path):
    t = _table(n=6000)
    paths = _files(tmp_path, t)
    s = TorchSession(SHARE, device="cpu")
    df = s.read_parquet(*paths).group_by(col("k")).agg(
        (sum_(col("v")), "sv")).order_by(col("k"))
    first = df.collect()
    assert table_digest(df.collect()) == table_digest(first)
    assert ws.stats()["result_hits"] == 1
    time.sleep(0.01)
    pq.write_table(_table(n=2000, seed=99), paths[0])
    changed = s.read_parquet(*paths).group_by(col("k")).agg(
        (sum_(col("v")), "sv")).order_by(col("k")).collect()
    assert ws.stats()["result_invalidations"] == 1
    assert table_digest(changed) != table_digest(first)
    js = TpuSession()
    want = js.read_parquet(*paths).group_by(jcol("k")).agg(
        (jsum(jcol("v")), "sv")).order_by(jcol("k")).collect(engine="tpu")
    assert digest(changed) == digest(want)


def test_nondeterministic_plans_never_consult_the_cache():
    s = TorchSession(SHARE, device="cpu")
    df = s.create_dataframe(_table()).select(col("k"), rand(5).alias("r"))
    df.collect()
    df.collect()
    st = ws.stats()
    assert st["result_hits"] == st["result_misses"] == 0
    assert len(ws.RESULT_CACHE) == 0


def test_shared_scan_rides_prior_decode(tmp_path):
    """The first query decodes and leads each scan task; a later
    identical scan replays the completed entries: the decode counter
    stays flat and the results are equal, and equal to JAX's."""
    t = _table(n=6000)
    paths = _files(tmp_path, t)
    keys = {**SHARE, C.TASK_TARGET_BYTES: 1, C.BATCH_ROWS: 1000}
    s1 = TorchSession(keys, device="cpu")
    a = s1.read_parquet(*paths).where(col("v") > 10).select(
        col("k"), col("v")).collect()
    decoded = ws.stats()["scan_units_decoded"]
    assert decoded > 0 and ws.stats()["scan_leads"] == 3
    # a different plan over the same scan: no result hit, a scan share
    s2 = TorchSession(keys, device="cpu")
    b = s2.read_parquet(*paths).where(col("v") > 10).select(
        col("k"), col("v")).group_by(col("k")).agg(
        (sum_(col("v")), "sv")).order_by(col("k")).collect()
    st = ws.stats()
    assert st["scan_units_decoded"] == decoded
    assert st["scan_subscribes"] == 3 and st["scan_units_shared"] > 0
    assert a.num_rows == int(np.sum(t["v"].to_numpy() > 10))
    js = TpuSession()
    want = js.read_parquet(*paths).where(jcol("v") > 10).group_by(
        jcol("k")).agg((jsum(jcol("v")), "sv")).order_by(
        jcol("k")).collect(engine="tpu")
    assert digest(b) == digest(want)


def test_subscribers_upload_their_own_tensors(tmp_path):
    """Only host Arrow tables are shared: a subscriber's device batch
    is its own upload, so writing into it cannot reach the leader's."""
    from spark_rapids_tpu_torch.io.scan import ParquetScanExec

    t = _table(n=2000)
    paths = _files(tmp_path, t, n=1)
    keys = {**SHARE, C.BATCH_ROWS: 4000}
    plans = [TorchSession(keys, device="cpu").read_parquet(*paths)
             .physical_plan() for _ in range(2)]
    scans = [next(n for n in p.walk() if isinstance(n, ParquetScanExec))
             for p in plans]
    lead = list(scans[0].execute_partition(0))
    sub = list(scans[1].execute_partition(0))
    assert ws.stats()["scan_subscribes"] == 1
    lt, st_ = lead[0].columns[1].data, sub[0].columns[1].data
    assert torch_equal(lt, st_) and lt.data_ptr() != st_.data_ptr()
    st_.add_(1)
    assert not torch_equal(lt, st_)


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


def test_stream_offers_its_result_to_the_cache():
    s = TorchSession(SHARE, device="cpu")
    t = _table()
    pq_ = s.prepare(_agg_df(s, t))
    streamed = pa.Table.from_batches(list(pq_.execute_stream()))
    assert ws.stats()["result_inserts"] == 1
    served = pq_.execute()
    assert ws.stats()["result_hits"] == 1
    assert table_digest(served) == table_digest(streamed)


def test_sharing_smoke_two_tenants_at_once(tmp_path):
    """Two tenants run the same text at once under admission: the
    result cache gives at least one hit (or the scans shared), both
    digests are equal, and equal to the JAX engine's."""
    t = _table(n=6000)
    paths = _files(tmp_path, t)
    text = ("select k, sum(v) as sv from t where v > :lo "
            "group by k order by k")
    out: dict = {}
    go = threading.Barrier(2)

    def run(tenant, prio):
        fe = SqlSession({**SHARE, C.SERVING_MAX_CONCURRENT: 1}, device="cpu",
                        tenant=tenant, priority=prio)
        fe.register_parquet("t", *paths)
        pq_ = fe.prepare(text)
        go.wait()
        out[tenant] = [pq_.execute(params={"lo": 5}) for _ in range(2)]

    ths = [threading.Thread(target=run, args=(f"t{i}", 1 + 3 * i))
           for i in range(2)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(60.0)
    digests = {table_digest(x) for v in out.values() for x in v}
    assert len(out) == 2 and len(digests) == 1
    assert ws.stats()["result_hits"] >= 1
    js = TpuSession()
    want = js.read_parquet(*paths).where(jcol("v") > 5).group_by(
        jcol("k")).agg((jsum(jcol("v")), "sv")).order_by(
        jcol("k")).collect(engine="tpu")
    assert digest(out["t0"][0]) == digest(want)


# the result-cache spill case spills on purpose: a fresh plugin a
# module, not torch_quiet's quiet ladder
from torch_plugin import fresh_plugin  # noqa: E402,F401
