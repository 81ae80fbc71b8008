"""The port's device ledger (``trace/ledger.py``), program cache
(``execs/jit_cache.py``) and telemetry sampler (``trace/telemetry.py``)
on the CPU, against the JAX package's where it has the same function.

- ``roofline_fraction``, ``key_tag``, ``program_key_str``, ``delta``,
  ``summarize`` and ``per_op`` return the JAX functions' values on the
  same seeded snapshots, both given the same peaks (the port's
  ``window_ms`` and ``roofline_lower_bound`` under the JAX names
  ``device_ms`` and ``roofline``);
- the peaks default to the H100's, a session's conf sets them, and no
  TPU figure is in the port;
- program keys are structural: equal trees, equal keys; a changed
  literal, type or ordinal, another key; with the ledger on a repeated
  collect misses 0 times, as the JAX engine's own cache does; the
  census names each exec's programs; with the ledger off no key is
  built;
- on the CPU the ledger counts dispatches and no device window (its
  windows on the card are ``test_torch_port.py``'s ``cuda`` case, a
  file the card's machine can import);
- the sampler's gauges, its counter tracks, and no thread after stop.
"""

from __future__ import annotations

import glob
import os
import threading
import time

import numpy as np
import pytest
import torch

import bench
from spark_rapids_tpu.config import get_conf, set_conf
from spark_rapids_tpu.execs import jit_cache as JJ
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.trace import ledger as JL

from spark_rapids_tpu_torch import TorchSession, tpch
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import trace as PT
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.execs import jit_cache as PJ
from spark_rapids_tpu_torch.execs.base import REAPER
from spark_rapids_tpu_torch.exprs import arithmetic as A
from spark_rapids_tpu_torch.exprs.base import BoundReference, Literal
from spark_rapids_tpu_torch.trace import export as PX
from spark_rapids_tpu_torch.trace import ledger as PL
from spark_rapids_tpu_torch.trace import telemetry as TM

TTB = C.TASK_TARGET_BYTES
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM, PEAK = 1.5e12, 9.0e13


@pytest.fixture(autouse=True)
def _ledger_off():
    yield
    PL.disable()
    PL.reset_stats()
    PT.disable()
    PT.clear()
    TM.stop()


# --------------------------------------------------------------------- #
# The JAX functions on equal inputs
# --------------------------------------------------------------------- #


def _snapshot(seed: int, keys: list) -> tuple[dict, dict]:
    """(before, after) snapshots of the ledger's format, seeded."""
    rng = np.random.default_rng(seed)
    before, after = {}, {}
    for i, k in enumerate(keys):
        d0 = int(rng.integers(0, 5))
        rec = {"tag": PL.key_tag(k), "op": [None, "TpuProjectExec",
                                            "TpuHashAggregateExec"][i % 3],
               "donated": False, "dispatches": d0,
               "dispatch_ms": round(float(rng.random()) * 3, 3),
               "window_ms": round(float(rng.random()) * 5, 3),
               "flops": float(rng.integers(0, 10**6)),
               "bytes_accessed": float(rng.integers(0, 10**8)),
               "live_rows": int(rng.integers(0, 10**5)),
               "capacity_rows": int(rng.integers(10**5, 2 * 10**5)),
               "live_capacity_ratio": None}
        key = PL.program_key_str(k)
        before[key] = rec
        grown = dict(rec)
        step = int(rng.integers(0, 4))
        grown["dispatches"] += step
        grown["dispatch_ms"] = round(rec["dispatch_ms"] + step * 0.5, 3)
        grown["window_ms"] = round(rec["window_ms"]
                                   + step * float(rng.random()), 3)
        grown["live_rows"] += step * 100
        grown["capacity_rows"] += step * 128
        if i % 4 == 0:
            grown["devices"], grown["rounds"] = 4, 2
        after[key] = grown
    return before, after


KEYS = [("project", ("Add[...]",), False), ("agg.update", 3),
        ("kernel.hash_columns",), (), "bare", ("join.probe", "inner"),
        (1, 2), ("exchange.split", 8)]


@pytest.mark.parametrize("key", KEYS, ids=repr)
def test_key_functions_match_jax(key):
    assert PL.key_tag(key) == JL.key_tag(key)
    assert PL.program_key_str(key) == JL.program_key_str(key)


@pytest.mark.parametrize("bps", [0.0, 1e9, 3.3e12, 7e13])
def test_roofline_fraction_matches_jax(bps):
    assert PL.roofline_fraction(bps, HBM) == JL.roofline_fraction(bps, HBM)


#: the port's names for what its ledger measures -> the JAX names
JAX_NAMES = {"window_ms": "device_ms", "roofline_lower_bound": "roofline"}


def _jax_named(obj):
    """``obj`` with the port's field names replaced by the JAX ones."""
    if isinstance(obj, dict):
        return {JAX_NAMES.get(k, k): _jax_named(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_jax_named(v) for v in obj]
    return obj


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_snapshot_analytics_match_jax(seed):
    before, after = _snapshot(seed, KEYS)
    jbefore, jafter = _jax_named(before), _jax_named(after)
    d = PL.delta(before, after)
    jd = JL.delta(jbefore, jafter)
    assert _jax_named(d) == jd
    assert _jax_named(PL.summarize(d, 3, HBM, PEAK)) == \
        JL.summarize(jd, 3, HBM, PEAK)
    assert _jax_named(PL.summarize(after, 5, HBM, PEAK)) == \
        JL.summarize(jafter, 5, HBM, PEAK)
    assert _jax_named(PL.per_op(after, HBM)) == JL.per_op(jafter, HBM)
    assert _jax_named(PL.per_op(d, HBM)) == JL.per_op(jd, HBM)


# --------------------------------------------------------------------- #
# The card's peaks, and no TPU figure
# --------------------------------------------------------------------- #


def test_peaks_default_to_the_h100s():
    conf = C.TorchConf()
    assert conf.get(C.LEDGER_HBM_BYTES_PER_S) == 3.35e12
    assert conf.get(C.LEDGER_PEAK_FLOPS) == 67e12
    assert PL.DEFAULT_HBM_BYTES_PER_S == 3.35e12
    assert PL.DEFAULT_PEAK_FLOPS == 67e12


def test_a_sessions_peaks_reach_the_analytics():
    """sync_conf takes the peak keys; summarize and per_op use them
    when no peak is passed."""
    before, after = _snapshot(5, KEYS)
    try:
        TorchSession({C.LEDGER_HBM_BYTES_PER_S: HBM,
                      C.LEDGER_PEAK_FLOPS: PEAK}, device="cpu")
        assert (PL.LEDGER.hbm_bytes_per_s, PL.LEDGER.peak_flops) == \
            (HBM, PEAK)
        assert PL.summarize(after) == PL.summarize(after, 5, HBM, PEAK)
        assert PL.per_op(after) == PL.per_op(after, HBM)
        assert PL.roofline_fraction(3e12) == 2.0
    finally:
        PL.sync_conf(C.TorchConf())
    assert PL.LEDGER.hbm_bytes_per_s == PL.DEFAULT_HBM_BYTES_PER_S


def test_no_tpu_figure_in_the_port():
    files = glob.glob(os.path.join(ROOT, "spark_rapids_tpu_torch", "**",
                                   "*.py"), recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 50
    for f in files:
        text = open(f, encoding="utf-8").read()
        for figure in ("819e9", "197e12", "819 GB", "197 TFLOP", "v5e"):
            assert figure not in text, (f, figure)


# --------------------------------------------------------------------- #
# The program cache
# --------------------------------------------------------------------- #


def _tree(ordinal=0, dtype=T.LONG, value=7):
    return A.Add(BoundReference(ordinal, dtype, True, "a"),
                 Literal(value, dtype))


def test_program_keys_are_structural():
    assert PJ.exprs_key([_tree()]) == PJ.exprs_key([_tree()])
    base = PJ.exprs_key([_tree()])
    for changed in (_tree(value=8), _tree(dtype=T.INT), _tree(ordinal=1)):
        assert PJ.exprs_key([changed]) != base


@pytest.fixture(scope="module")
def q1_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("ledger")
    (d / "q1").mkdir()
    (d / "q3").mkdir()
    return {
        "q1": tpch.make_lineitem(str(d / "q1"), n_files=3,
                                 with_q1_cols=True, rows_per_file=4096),
        "q3": (tpch.make_lineitem(str(d / "q3"), n_files=3,
                                  with_orderkey=True, n_orders=2048,
                                  rows_per_file=4096),
               tpch.make_orders(str(d / "q3"), n_orders=2048))}


def test_repeated_collect_misses_nothing_in_both_packages(q1_paths):
    df = tpch.q1_dataframe(TorchSession({TTB: 1}, device="cpu"),
                           q1_paths["q1"])
    PL.enable()
    first = df.collect()
    PJ.reset_cache_stats()
    assert df.collect().equals(first)
    st = PJ.cache_stats()
    assert st["misses"] == 0 and st["hits"] > 0, st
    conf = get_conf()
    saved = dict(conf._values)
    conf.set(TTB, 1)
    set_conf(conf)
    try:
        jdf = bench.q1_dataframe(TpuSession(conf), q1_paths["q1"])
        jdf.collect()
        JJ.reset_cache_stats()
        jdf.collect()
        jst = JJ.cache_stats()
    finally:
        conf._values.clear()
        conf._values.update(saved)
        set_conf(conf)
    assert jst["misses"] == 0 and jst["hits"] > 0, jst


def test_program_census_names_each_execs_programs(q1_paths):
    s = TorchSession({TTB: 1, C.BROADCAST_THRESHOLD: -1}, device="cpu")
    PL.enable()
    tpch.q3_dataframe(s, *q1_paths["q3"]).collect()
    ids = BoundReference(0, T.LONG, True, "id")
    s.range(0, 5000).where(ids.__gt__(Literal(10, T.LONG))).select(
        A.Multiply(ids, Literal(3, T.LONG)).alias("x")).order_by(
        "x", desc=True).collect()
    census = PJ.program_census()
    for tag in ("agg.update", "agg.merge", "agg.final", "exchange.split",
                "join.probe", "topn.candidates", "topn.final", "sort",
                "project", "filter"):
        assert census.get(tag, 0) >= 1, (tag, census)
    # q3's exchanges partition on different keys: a program each
    assert census["exchange.split"] >= 2, census
    assert PJ.cache_stats()["size"] == sum(census.values())


def test_with_the_ledger_off_no_key_is_built():
    """Off, an exec's program is its callable: the key is never
    called, the cache's figures stay as they were."""
    from spark_rapids_tpu_torch.execs.base import TpuExec

    def no_key():
        raise AssertionError("key built with the ledger off")

    def fn(x):
        return x + 1

    PL.disable()
    before = PJ.cache_stats()
    exec_ = TpuExec.__new__(TpuExec)
    assert exec_.program("test.off", no_key, fn) is fn
    assert PJ.cache_stats() == before


def test_cache_miss_is_a_trace_event_and_first_build():
    PT.enable()
    PT.clear()
    PL.enable()
    key = ("test.program", time.perf_counter_ns())
    before = PJ.cache_stats()

    def mul(x, y):
        return x * y

    first = PJ.cached_program(key, mul, op="TestExec")
    second = PJ.cached_program(key, mul)
    after = PJ.cache_stats()
    assert (after["misses"] - before["misses"],
            after["hits"] - before["hits"],
            after["size"] - before["size"]) == (1, 1, 1)
    assert first(5, y=3) == 15 and second(2, 4) == 8
    (rec,) = [r for k, r in PL.snapshot().items()
              if k == PL.program_key_str(key)]
    assert (rec["op"], rec["dispatches"]) == ("TestExec", 2)
    assert [e.attrs["key"] for e in PT.snapshot()
            if e.name == "jit.cache_miss"] == [repr(key)[:200]]


def test_program_cache_does_not_keep_an_exec_alive():
    """The entry is the dispatch hook, not the exec's callable: an exec
    (and what its tree holds) goes with its query."""
    import gc
    import weakref

    s = TorchSession({TTB: 1}, device="cpu")
    PL.enable()
    plan = s.range(0, 100).select(
        A.Multiply(BoundReference(0, T.LONG, True, "id"),
                   Literal(2, T.LONG)).alias("x")).physical_plan()
    from spark_rapids_tpu_torch.plan.planner import collect_exec

    collect_exec(plan, s.conf)
    REAPER.flush()
    gone = weakref.ref(plan)
    del plan
    gc.collect()
    assert gone() is None


# --------------------------------------------------------------------- #
# The ledger
# --------------------------------------------------------------------- #


def test_ledger_on_the_cpu_counts_dispatches_and_no_device_time(q1_paths):
    # speculation off: every program then runs at its live rows (ratio
    # 1.0); tests/test_torch_speculation.py holds the speculated ratio
    s = TorchSession({TTB: 1, C.BROADCAST_THRESHOLD: -1,
                      C.SPECULATION_ENABLED: False}, device="cpu")
    df = tpch.q3_dataframe(s, *q1_paths["q3"])
    want = df.collect()
    PL.enable()
    before = PL.snapshot()
    got = df.collect()
    PL.LEDGER.flush(10)
    progs = PL.delta(before, PL.snapshot())
    assert got.equals(want)
    tags = {p["tag"] for p in progs.values()}
    assert {"kernel.hash_columns", "exchange.split", "join.probe",
            "agg.update"} <= tags
    assert all(p["dispatches"] > 0 and p["window_ms"] == 0
               for p in progs.values())
    assert all(p["bytes_accessed"] > 0 for p in progs.values())
    k1 = [p for p in progs.values() if p["op"] == "K1"]
    assert k1 and all(p["live_capacity_ratio"] is None for p in k1)
    tot = PL.summarize(progs)["totals"]
    assert tot["window_ms"] == 0 and tot["live_capacity_ratio"] == 1.0
    PL.disable()
    assert not PL.LEDGER.settle_thread_alive()


def test_ledger_off_is_a_passthrough():
    PL.disable()
    calls = []
    fn = PL.LEDGER.wrap(("test.off",), lambda *a: calls.append(a) or 3)
    assert fn(1, 2) == 3 and calls == [(1, 2)]
    assert all(k != PL.program_key_str(("test.off",))
               for k in PL.snapshot())


def test_a_failed_settle_raises_on_the_path():
    """Nothing swallows a failed event: what the settle worker or the
    metric reaper met raises at the next dispatch or timed region."""
    from spark_rapids_tpu_torch.execs.base import MetricTimer, TimeMetric

    PL.enable()
    fn = PL.LEDGER.wrap(("test.failed",), lambda x: x)
    PL.LEDGER.errors.append(RuntimeError("event failed"))
    with pytest.raises(RuntimeError, match="event failed"):
        fn(1)
    assert fn(2) == 2
    REAPER.errors.append(RuntimeError("region failed"))
    with pytest.raises(RuntimeError, match="region failed"):
        with MetricTimer(TimeMetric("t")) as t:
            t.observe(torch.zeros(1))
    REAPER.flush()


def test_sync_conf_ownership_rule():
    on = C.TorchConf({C.LEDGER_ENABLED: True})
    PL.sync_conf(on)
    assert PL.is_enabled()
    PL.sync_conf(C.TorchConf())
    assert PL.is_enabled()
    PL.sync_conf(on.set(C.LEDGER_ENABLED, False))
    assert not PL.is_enabled()


# --------------------------------------------------------------------- #
# Telemetry
# --------------------------------------------------------------------- #


def test_sampler_gauges_tracks_and_no_thread_after_stop():
    sample = TM.sample_now()
    for key in ("store.device_bytes", "store.host_bytes",
                "store.disk_bytes", "semaphore.permits",
                "semaphore.in_use", "admission.running",
                "admission.waiting", "pipeline.occupancy",
                "cancel.active", "pipeline.stage_threads",
                "scan.inflight", "result_cache.bytes",
                "device.allocated_bytes", "device.reserved_bytes"):
        assert isinstance(sample[key], (int, float)), key
    PT.enable()
    PT.clear()
    TM.start(hz=200)
    deadline = time.monotonic() + 5
    while TM.SAMPLER.samples < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    TM.stop()
    assert not any(t.name == TM.THREAD_NAME for t in threading.enumerate())
    doc = PX.chrome_trace()
    tracks = {e["name"] for e in doc["traceEvents"] if e["ph"] == "C"}
    assert {"telemetry.store_bytes", "telemetry.semaphore",
            "telemetry.admission", "telemetry.device_bytes"} <= tracks


def test_sampler_follows_its_owning_conf():
    on = C.TorchConf({C.TELEMETRY_ENABLED: True, C.TELEMETRY_HZ: 50.0})
    TM.sync_conf(on)
    assert TM.is_enabled()
    TM.sync_conf(C.TorchConf())
    assert TM.is_enabled()
    TM.sync_conf(on.set(C.TELEMETRY_ENABLED, False))
    assert not TM.is_enabled()
    assert not any(t.name == TM.THREAD_NAME for t in threading.enumerate())


def _filter_plan():
    s = TorchSession({TTB: 1}, device="cpu")
    df = s.range(0, 5000).where(BoundReference(0, T.LONG, True, "id")
                                .__gt__(Literal(10, T.LONG)))
    return s, df.physical_plan()


def test_reaper_settles_exec_time_and_leaves():
    s, plan = _filter_plan()
    from spark_rapids_tpu_torch.plan.planner import collect_exec

    PT.enable()
    collect_exec(plan, s.conf)
    REAPER.flush()
    assert any(e.name.startswith("metric.settle.") for e in PT.snapshot())
    assert sum(n.total_time.value for n in plan.walk()) > 0
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and any(
            t.name == "srt-metric-reaper" for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "srt-metric-reaper"
                   for t in threading.enumerate())


def test_with_every_key_off_exec_time_is_the_hosts(monkeypatch):
    """Tracing and the ledger off: a timed region adds its host time as
    it ends, and hands nothing to the reaper."""
    from spark_rapids_tpu_torch.plan.planner import collect_exec

    def no_submit(*a):
        raise AssertionError("a region went to the reaper")

    PT.disable()
    PL.disable()
    s, plan = _filter_plan()
    monkeypatch.setattr(REAPER, "submit", no_submit)
    collect_exec(plan, s.conf)
    assert sum(n.total_time.value for n in plan.walk()) > 0
