"""Cooperative cancellation, deadlines and the per-tenant circuit
breaker of the port (``spark_rapids_tpu_torch/serving/cancel.py``) on
the CPU.  A cancelled query must unwind with its store entries, its
admission slot, its semaphore permits, its stage and pool threads all
released; the queries that survive, and a cancelled query run again,
equal the JAX package's result (digests of the results with every
field nullable); the breaker's state machine steps as the JAX one does
on the same script.

Port of the intent of the JAX ``tests/test_cancellation.py``; left out
are its event-log records (``engine="cancelled"``), the trace ledger's
zero-device-work probe (the port counts uploads instead) and HC013
(``test_hc013_cancellation_leak_matrix``)."""

import random
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.serving import cancel as JC
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import count_star as jcount_star
from spark_rapids_tpu.session import sum_ as jsum

from spark_rapids_tpu_torch import TorchSession, col, sum_
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.eventlog import table_digest
from spark_rapids_tpu_torch.execs.base import live_pool_threads
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.parallel.pipeline import live_stage_threads
from spark_rapids_tpu_torch.robustness import faults
from spark_rapids_tpu_torch.serving import cancel as K
from spark_rapids_tpu_torch.serving import clear_serving_context
from spark_rapids_tpu_torch.serving import scheduler as scheduler_mod
from spark_rapids_tpu_torch.session import count_star

MAXC = C.SERVING_MAX_CONCURRENT
SMALL = {C.BATCH_ROWS: 512, C.SHUFFLE_PARTITIONS: 4}


@pytest.fixture(autouse=True)
def _isolate_cancel():
    scheduler_mod.reset()
    K.reset()
    JC.reset()
    clear_serving_context()
    TpuSemaphore.reset()
    yield
    faults.disarm()
    scheduler_mod.reset()
    K.reset()
    JC.reset()
    clear_serving_context()
    TpuSemaphore.reset()


def _table(n=20000, keys=64, seed=11):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, keys, n).astype(np.int64),
        "v": rng.integers(0, 1000, n).astype(np.int64),
    })


def _agg_df(session, t):
    return (session.create_dataframe(t).group_by(col("k"))
            .agg((sum_(col("v")), "sv"), (count_star(), "n"))
            .order_by(col("k")))


def _jax_digest(t) -> str:
    js = TpuSession()
    return digest(js.create_dataframe(t).group_by(jcol("k"))
                  .agg((jsum(jcol("v")), "sv"), (jcount_star(), "n"))
                  .order_by(jcol("k")).collect(engine="tpu"))


def digest(t: pa.Table) -> str:
    return table_digest(t.cast(pa.schema(
        [f.with_nullable(True) for f in t.schema])))


def assert_released(session, device_before: int) -> None:
    """Everything a query holds is back: store entries and bytes, the
    admission slot, semaphore permits, stage and pool threads, tokens."""
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and (
            live_stage_threads() or live_pool_threads()):
        time.sleep(0.01)
    assert session.store.leak_report() == []
    assert session.store.spill_stats()["device_used"] == device_before
    st = scheduler_mod.scheduler_stats()
    assert st["running"] == 0 and st["waiting"] == 0
    assert TpuSemaphore.get().usage()["in_use"] == 0
    assert live_stage_threads() == 0 and live_pool_threads() == 0
    assert K.active_count() == 0


# ------------------------------------------------------------------ #
# Tokens, classification, the checkpoint
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("mod", [K, JC], ids=["port", "jax"])
def test_token_semantics(mod):
    tok = mod.CancelToken("t0")
    assert not tok.cancelled and tok.remaining_s() is None
    tok.check()
    assert tok.cancel() and not tok.cancel("deadline_exceeded")
    assert tok.reason == "cancelled"
    with pytest.raises(mod.QueryCancelled) as ei:
        tok.check()
    assert ei.value.reason == "cancelled"
    dl = mod.CancelToken("t0", deadline_ms=1.0)
    assert dl.remaining_s() is not None
    time.sleep(0.01)
    assert dl.expired()
    with pytest.raises(mod.QueryCancelled) as ei:
        dl.check()
    assert ei.value.reason == "deadline_exceeded"
    ts = mod.TokenSet()
    a, b = mod.CancelToken(), mod.CancelToken()
    b.query_id = 7
    ts.add(a), ts.add(b)
    assert ts.cancel(query_id=7) == 1 and b.cancelled and not a.cancelled
    assert ts.cancel() == 1


def test_query_cancelled_never_retryable():
    from spark_rapids_tpu_torch.execs.retry import is_retryable

    e = K.QueryCancelled("deadline_exceeded", "RESOURCE_EXHAUSTED x",
                         query_id=3)
    assert not is_retryable(e)
    assert "deadline_exceeded" in str(e) and "query_id=3" in str(e)


def test_checkpoint_is_inert_without_token():
    K.check_point()
    with K.attach_token(None):
        K.check_point()


# ------------------------------------------------------------------ #
# Explicit cancel
# ------------------------------------------------------------------ #


def test_cancel_from_another_thread_after_the_first_batch():
    """A prepared stream is cancelled from another thread after its
    first batch: the next pull raises QueryCancelled and the unwind
    releases everything; run again, the query equals the JAX result."""
    t = _table()
    s = TorchSession({**SMALL, MAXC: 2}, device="cpu")
    before = s.store.spill_stats()["device_used"]
    pq_ = s.prepare(s.create_dataframe(t).where(col("v") >= 0)
                    .select(col("k"), col("v")))
    gen = pq_.execute_stream()
    first = next(gen)
    assert first.num_rows > 0
    th = threading.Thread(target=s.cancel)
    th.start()
    th.join()
    with pytest.raises(K.QueryCancelled) as ei:
        for _ in gen:
            pass
    assert ei.value.reason == "cancelled" and ei.value.query_id
    assert K.stats()["cancelled"] == 1
    assert_released(s, before)
    assert pq_.execute().num_rows == t.num_rows
    assert digest(_agg_df(s, t).collect()) == _jax_digest(t)


def test_cancel_mid_collect_through_an_exchange_unwinds():
    """A projection's UDF cancels its own session while the reduce side
    reads the exchange: the collect raises at the next checkpoint, the
    exchange's blocks and the map stage's permits are released."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.udf import torch_udf

    t = _table()
    s = TorchSession({**SMALL, MAXC: 1}, device="cpu")
    before = s.store.spill_stats()["device_used"]

    @torch_udf(T.LONG)
    def cancel_me(v):
        s.cancel()
        return v

    df = s.create_dataframe(t).group_by(col("k")).agg(
        (sum_(col("v")), "sv")).select(col("k"), cancel_me(col("sv")))
    with pytest.raises(K.QueryCancelled):
        df.collect()
    assert_released(s, before)
    assert digest(_agg_df(s, t).collect()) == _jax_digest(t)


def test_session_cancel_by_query_id_targets_one():
    ts = K.TokenSet()
    toks = [K.CancelToken() for _ in range(3)]
    for i, tok in enumerate(toks):
        tok.query_id = 10 + i
        ts.add(tok)
    assert ts.cancel(query_id=11) == 1
    assert [tok.cancelled for tok in toks] == [False, True, False]


def test_prepared_cancel_scopes_to_template():
    t = _table()
    s = TorchSession({**SMALL, MAXC: 2}, device="cpu")
    pq1 = s.prepare(s.create_dataframe(t).where(col("v") >= 0)
                    .select(col("k")))
    pq2 = s.prepare(s.create_dataframe(t).where(col("v") >= 1)
                    .select(col("v")))
    g1, g2 = pq1.execute_stream(), pq2.execute_stream()
    next(g1)
    rows = next(g2).num_rows
    assert pq1.cancel() == 1
    with pytest.raises(K.QueryCancelled):
        for _ in g1:
            pass
    rows += sum(b.num_rows for b in g2)  # not in the cancelled scope
    assert rows == int(np.sum(t["v"].to_numpy() >= 1))
    assert pq1.execute().num_rows == t.num_rows


# ------------------------------------------------------------------ #
# Deadlines
# ------------------------------------------------------------------ #


def test_queue_deadline_sheds_with_zero_device_work():
    """With the one admission slot held, a query whose deadline passes
    while it waits is shed from the queue: it raises within the
    deadline, and nothing was uploaded or planned for it."""
    from spark_rapids_tpu_torch.plan import planner as planner_mod

    t = _table()
    s = TorchSession({**SMALL, MAXC: 1, C.DEADLINE_MS: 30.0}, device="cpu")
    df = _agg_df(s, t)
    sched = scheduler_mod.get_scheduler(s.conf)
    hog = sched.admit("hog")
    planned = []
    orig = planner_mod.plan_query
    planner_mod.plan_query = lambda *a, **k: planned.append(1) or orig(
        *a, **k)
    try:
        t0 = time.perf_counter()
        with pytest.raises(K.QueryCancelled) as ei:
            df.collect()
        waited = time.perf_counter() - t0
    finally:
        planner_mod.plan_query = orig
        sched.release(hog)
    assert ei.value.reason == "deadline_exceeded" and waited < 5.0
    assert planned == []
    assert K.stats()["deadline_exceeded"] == 1
    assert scheduler_mod.scheduler_stats()["shed"] == 1


def test_expired_deadline_sheds_before_enqueue():
    s = TorchSession({MAXC: 2, C.DEADLINE_MS: 1e-4}, device="cpu")
    with pytest.raises(K.QueryCancelled) as ei:
        _agg_df(s, _table()).collect()
    assert ei.value.reason == "deadline_exceeded"
    st = scheduler_mod.scheduler_stats()
    assert st["admitted"] == 0 and st["waiting"] == 0


def test_deadline_mid_flight_unwinds():
    """A deadline shorter than the query raises deadline_exceeded at a
    checkpoint inside the run and releases everything."""
    t = _table(n=60000)
    s = TorchSession({C.BATCH_ROWS: 128, C.SHUFFLE_PARTITIONS: 4,
                      MAXC: 1, C.DEADLINE_MS: 20.0}, device="cpu")
    before = s.store.spill_stats()["device_used"]
    with pytest.raises(K.QueryCancelled) as ei:
        _agg_df(s, t).collect()
    assert ei.value.reason == "deadline_exceeded"
    assert_released(s, before)


# ------------------------------------------------------------------ #
# The circuit breaker
# ------------------------------------------------------------------ #


def _poison_df(session, tmp_path):
    """A scan whose file is gone: every execution fails in the scan."""
    import os

    import pyarrow.parquet as pq

    p = str(tmp_path / "poison.parquet")
    pq.write_table(pa.table({"x": [1, 2, 3]}), p)
    df = session.read_parquet(p)
    os.remove(p)
    return df


def test_breaker_quarantines_poison_tenant_and_heals(tmp_path):
    conf = {MAXC: 2, C.BREAKER_THRESHOLD: 2, C.BREAKER_COOLDOWN_MS: 150.0}
    bad = TorchSession(conf, device="cpu", tenant="poison")
    good = TorchSession(conf, device="cpu", tenant="healthy")
    pdf = _poison_df(bad, tmp_path)
    t = _table()
    ref = table_digest(_agg_df(good, t).collect())
    failures = quarantined = 0
    for _ in range(6):
        try:
            pdf.collect()
        except K.TenantQuarantined:
            quarantined += 1
        except (FileNotFoundError, OSError):
            failures += 1
    assert failures == 2 and quarantined == 4
    assert K.breaker_state("poison") == "open"
    assert K.stats()["breaker_trips"] == 1
    assert K.stats()["quarantined"] == 4
    assert table_digest(_agg_df(good, t).collect()) == ref
    assert K.breaker_state("healthy") == "closed"
    time.sleep(0.2)
    assert _agg_df(bad, _table(seed=3)).collect().num_rows > 0
    assert K.breaker_state("poison") == "closed"


def test_breaker_failed_probe_reopens(tmp_path):
    s = TorchSession({MAXC: 2, C.BREAKER_THRESHOLD: 1,
                      C.BREAKER_COOLDOWN_MS: 100.0}, device="cpu",
                     tenant="p2")
    pdf = _poison_df(s, tmp_path)
    with pytest.raises(OSError):
        pdf.collect()
    assert K.breaker_state("p2") == "open"
    time.sleep(0.12)
    with pytest.raises(OSError):
        pdf.collect()
    assert K.breaker_state("p2") == "open"
    assert K.stats()["breaker_trips"] == 2
    with pytest.raises(K.TenantQuarantined):
        pdf.collect()


def test_breaker_steps_as_the_jax_breaker():
    """One script of admits, outcomes, releases and cooldowns through
    both modules' breakers: the same states, errors and trip counts."""
    from spark_rapids_tpu.config import TpuConf

    script = ["fail", "fail", "admit", "sleep", "admit", "release",
              "admit", "fail", "admit", "sleep", "admit", "ok", "admit",
              "ok", "fail", "fail", "fail", "admit"]

    def run(mod, conf):
        mod.reset()
        out = []
        for step in script:
            try:
                if step == "fail":
                    mod.breaker_result(conf, "w", ok=False)
                elif step == "ok":
                    mod.breaker_result(conf, "w", ok=True)
                elif step == "admit":
                    mod.breaker_admit(conf, "w")
                elif step == "release":
                    mod.breaker_release(conf, "w")
                else:
                    time.sleep(0.06)
                out.append(mod.breaker_state("w"))
            except mod.TenantQuarantined:
                out.append("quarantined")
        out.append(mod.stats()["breaker_trips"])
        mod.reset()
        return out

    keys = {C.BREAKER_THRESHOLD: 2, C.BREAKER_COOLDOWN_MS: 50.0}
    port = run(K, C.TorchConf(keys))
    jax = run(JC, TpuConf(keys))
    assert port == jax
    assert "quarantined" in port and "half_open" in port


def test_breaker_lost_probe_releases_instead_of_wedging():
    conf = C.TorchConf({C.BREAKER_THRESHOLD: 1,
                        C.BREAKER_COOLDOWN_MS: 50.0})
    K.breaker_result(conf, "w1", ok=False)
    assert K.breaker_state("w1") == "open"
    time.sleep(0.06)
    K.breaker_admit(conf, "w1")
    assert K.breaker_state("w1") == "half_open"
    K.breaker_release(conf, "w1")
    K.breaker_admit(conf, "w1")
    K.breaker_result(conf, "w1", ok=True)
    assert K.breaker_state("w1") == "closed"


def test_stream_early_close_is_breaker_neutral():
    s = TorchSession({**SMALL, MAXC: 1, C.BREAKER_THRESHOLD: 1},
                     device="cpu", tenant="ec")
    pq_ = s.prepare(s.create_dataframe(_table()).where(col("k") >= 0)
                    .select(col("k")))
    gen = pq_.execute_stream()
    next(gen)
    gen.close()
    assert K.breaker_state("ec") == "closed"
    assert K.stats()["breaker_trips"] == 0
    assert pq_.execute().num_rows > 0


def test_explicit_cancel_is_breaker_neutral():
    s = TorchSession({**SMALL, MAXC: 1, C.BREAKER_THRESHOLD: 1},
                     device="cpu", tenant="n1")
    pq_ = s.prepare(s.create_dataframe(_table()).where(col("k") >= 0)
                    .select(col("k")))
    gen = pq_.execute_stream()
    next(gen)
    s.cancel()
    with pytest.raises(K.QueryCancelled):
        for _ in gen:
            pass
    assert K.breaker_state("n1") == "closed"
    assert K.stats()["breaker_trips"] == 0


# ------------------------------------------------------------------ #
# Off: one conf read; the fault seam
# ------------------------------------------------------------------ #


def test_disabled_is_one_conf_read_and_result_identical():
    t = _table()
    s = TorchSession(SMALL, device="cpu")
    on = _agg_df(s, t).collect()
    reads: list = []
    orig_get = C.TorchConf.get

    def counting_get(self, key):
        if "cancellation" in key or "deadline" in key or "breaker" in key:
            reads.append(key)
        return orig_get(self, key)

    off_s = TorchSession({**SMALL, C.CANCEL_ENABLED: False}, device="cpu")
    df = _agg_df(off_s, t)
    C.TorchConf.get = counting_get
    try:
        off = df.collect()
    finally:
        C.TorchConf.get = orig_get
    assert reads == [C.CANCEL_ENABLED]
    assert table_digest(off) == table_digest(on) and K.active_count() == 0


def test_cancel_check_fault_seam_drives_real_unwind():
    t = _table()
    s = TorchSession(SMALL, device="cpu")
    before = s.store.spill_stats()["device_used"]
    df = _agg_df(s, t)
    faults.install("cancel.check:nth=2", forced=True)
    try:
        with pytest.raises(K.QueryCancelled) as ei:
            df.collect()
    finally:
        faults.disarm()
    assert ei.value.reason == "cancelled"
    assert "injected cancellation" in ei.value.detail
    assert_released(s, before)


# ------------------------------------------------------------------ #
# The storm
# ------------------------------------------------------------------ #


def test_cancellation_storm_bit_identical_and_leak_free():
    """4 sessions x 3 rounds of 3 queries under admission, with seeded
    deadlines (some already expired) and cancels from timers, while
    the split ladder fires at random: every surviving result equals the
    serial run's digest and the JAX engine's, at least one query was
    cancelled, and every gauge is back at zero."""
    n_sessions, iters = 4, 3
    tables = [_table(n=6000, seed=100 + i) for i in range(3)]
    s0 = TorchSession(SMALL, device="cpu")
    before = s0.store.spill_stats()["device_used"]
    serial = [table_digest(_agg_df(s0, t).collect()) for t in tables]
    for t in tables:
        assert digest(_agg_df(s0, t).collect()) == _jax_digest(t)
    faults.install("exec.batch:prob=0.05,seed=13", forced=True)
    mismatches: list = []
    outcomes = {"survived": 0, "cancelled": 0}
    lock = threading.Lock()

    def run_session(i: int) -> None:
        rng = random.Random(70 + i)
        for it in range(iters):
            for qi, t in enumerate(tables):
                roll = rng.random()
                keys = {**SMALL, MAXC: 2, C.SERVING_QUEUE_DEPTH: 64,
                        C.RETRY_BACKOFF_S: 0.0}
                if roll < 0.15:
                    keys[C.DEADLINE_MS] = 1e-4  # expired before admission
                elif roll < 0.3:
                    keys[C.DEADLINE_MS] = round(rng.uniform(0.5, 8.0), 2)
                session = TorchSession(keys, device="cpu",
                                       tenant=f"t{i % 2}")
                df = _agg_df(session, t)
                canceller = None
                if 0.3 <= roll < 0.6:
                    canceller = threading.Timer(rng.uniform(0.001, 0.01),
                                                session.cancel)
                    canceller.start()
                try:
                    r = df.collect()
                    with lock:
                        outcomes["survived"] += 1
                        if table_digest(r) != serial[qi]:
                            mismatches.append((i, it, qi))
                except K.QueryCancelled:
                    with lock:
                        outcomes["cancelled"] += 1
                finally:
                    if canceller is not None:
                        canceller.cancel()
                        canceller.join()

    threads = [threading.Thread(target=run_session, args=(i,))
               for i in range(n_sessions)]
    for th in threads:
        th.start()
    try:
        for th in threads:
            th.join(300.0)
    finally:
        faults.disarm()
    assert not mismatches, mismatches
    assert outcomes["survived"] >= 1 and outcomes["cancelled"] >= 1
    st = K.stats()
    assert st["cancelled"] + st["deadline_exceeded"] == outcomes["cancelled"]
    assert_released(s0, before)


# the storm drives the split ladder on purpose: a fresh plugin a module,
# not torch_quiet's quiet ladder
from torch_plugin import fresh_plugin  # noqa: E402,F401
