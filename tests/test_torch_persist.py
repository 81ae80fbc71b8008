"""The port's warm-start store (``spark_rapids_tpu_torch/persist.py``) on
the CPU, held against the JAX package's (``spark_rapids_tpu/persist.py``).

Counterparts of ``tests/test_persist.py`` that apply to the port: the
off path's cost (one conf read a probe site, no store, no thread, the
module not even imported, results and dispatches as in a process that
cannot import it); the poisoning matrix over plan and result entries
(truncated, bad checksum, bad magic, old format: each an honest miss);
two processes writing one entry at once; the LRU budget; the plan
tier's prepare lineage across three caches; a result frame restored and
then invalidated by a changed digest; the counter surface and the
gauge; HC017 against the JAX rule on the same records; and the cold
processes of ``tools/cold_start.py`` (digests, rows and dispatches equal
across off, empty and warm; the result tier restoring with no dispatch;
a source file rewritten in place making it miss).

Left out: the JAX tests of the program tier
(``test_disabled_compile_path_untouched``,
``test_program_roundtrip_restores_without_compiling``,
``test_compiles_counter_is_first_invocation``, the program half of the
poisoning matrix with its jax and device stamps) and the zero-compile
and 2x wall gates of ``test_warm_start_cold_process_acceptance`` and
``test_warm_start_smoke_tier1``.  That tier stores ``jax.export``
artifacts and points the XLA compilation cache at the store; the port
compiles no programs (its kernel library is built once into
``_build/``, keyed by source), so it has no such tier and no compile to
save (ROADMAP §3).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.tools import history as JH

from spark_rapids_tpu_torch import TorchSession, col, persist, sum_
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.eventlog import table_digest
from spark_rapids_tpu_torch.serving import work_share as ws
from spark_rapids_tpu_torch.serving.plan_cache import CacheEntry, PlanCache
from spark_rapids_tpu_torch.tools import cold_start as cs
from spark_rapids_tpu_torch.tools import history as PH
from torch_ops_isolation import ops_teardown

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET = 256 << 20


@pytest.fixture(autouse=True)
def _sandbox():
    """Every test starts and ends with no activated store, no writer
    thread, zeroed counters and an empty result cache."""
    persist.reset_for_tests()
    ws.reset()
    yield
    ops_teardown()


def _on(tmp_path, **extra) -> C.TorchConf:
    return C.TorchConf({C.PERSIST_ENABLED: True,
                        C.PERSIST_DIR: str(tmp_path / "store"), **extra})


def _entries(root: str, kind: str) -> list[str]:
    d = os.path.join(root, kind)
    return sorted(os.path.join(d, n) for n in os.listdir(d)
                  if n.endswith(persist._SUFFIX))


def _persist_threads() -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.name.startswith("srt-persist")]


# -- the off path ------------------------------------------------------- #

def test_disabled_is_one_conf_read(monkeypatch):
    """persist.enabled off: active() reads that one key and returns
    None; no store, no directory, no thread."""
    reads = []
    orig = C.TorchConf.get

    def counting(self, key):
        reads.append(key)
        return orig(self, key)

    monkeypatch.setattr(C.TorchConf, "get", counting)
    assert persist.active(C.TorchConf()) is None
    assert reads == [C.PERSIST_ENABLED]
    assert persist._STORES == {} and _persist_threads() == []


_OFF_CHILD = r"""
import json, sys, threading
block = sys.argv[1] == "block"
if block:
    # the module cannot be imported: any probe that imports it fails
    sys.modules["spark_rapids_tpu_torch.persist"] = None
import numpy as np, pyarrow as pa
from spark_rapids_tpu_torch import TorchSession, col, sum_
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.eventlog import table_digest
from spark_rapids_tpu_torch.trace import ledger
sites = {}
orig = C.TorchConf.get
def counting(self, key):
    if key.startswith("spark.rapids.tpu.persist."):
        name = sys._getframe(1).f_code.co_name
        sites[name] = sites.get(name, 0) + 1
    return orig(self, key)
C.TorchConf.get = counting
rng = np.random.default_rng(3)
t = pa.table({"k": rng.integers(0, 16, 4096).astype(np.int64),
              "v": rng.integers(0, 1000, 4096).astype(np.int64)})
ledger.enable()
s = TorchSession({C.SHARING_ENABLED: True}, device="cpu")
prepared = s.prepare(s.create_dataframe(t).group_by(col("k"))
                     .agg((sum_(col("v")), "sv")).order_by(col("k")))
out = prepared.execute()
ledger.LEDGER.flush(timeout=30)
print(json.dumps({
    "digest": table_digest(out),
    "dispatches": ledger.summarize(ledger.snapshot())["totals"]["dispatches"],
    "sites": sites,
    "imported": sys.modules.get("spark_rapids_tpu_torch.persist") is not None,
    "threads": [x.name for x in threading.enumerate()
                if x.name.startswith("srt-persist")]}))
"""


def _off_child(mode: str) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _OFF_CHILD, mode],
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_disabled_probe_sites_read_one_key_each():
    """Off (the default), a prepared query with sharing on passes the
    four probe sites (the plan cache's lookup and insert, the result
    cache's lookup and insert): each reads the one key once, and
    nothing imports the store's module or starts its thread.  The
    result and the ledger's dispatches equal those of a process in
    which the module cannot be imported at all."""
    seen = _off_child("count")
    # PlanCache._store serves lookup and insert; the result cache's
    # two sites are _restore_persisted and insert
    assert seen["sites"] == {"_store": 2, "_restore_persisted": 1,
                             "insert": 1}, seen["sites"]
    assert not seen["imported"] and seen["threads"] == []
    blocked = _off_child("block")
    assert (blocked["digest"], blocked["dispatches"]) \
        == (seen["digest"], seen["dispatches"])
    assert seen["dispatches"] > 0


# -- the poisoning matrix ----------------------------------------------- #

def _poison_truncate(path: str) -> None:
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:-16] if len(blob) > len(persist._MAGIC) + 64
                else blob[:-2])


def _rewrite_header(path: str, edit) -> None:
    blob = open(path, "rb").read()
    rest = blob[len(persist._MAGIC):]
    nl = rest.index(b"\n")
    header = json.loads(rest[:nl])
    edit(header)
    with open(path, "wb") as f:
        f.write(persist._MAGIC + json.dumps(header).encode() + b"\n"
                + rest[nl + 1:])


def _poison_checksum(path: str) -> None:
    _rewrite_header(path, lambda h: h.update(sha256="0" * 64))


def _poison_magic(path: str) -> None:
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(b"X" + blob[1:])


def _poison_old_format(path: str) -> None:
    _rewrite_header(path, lambda h: h["stamp"].update(
        format=persist.FORMAT_VERSION - 1))


POISONS = {"truncated": _poison_truncate, "checksum": _poison_checksum,
           "magic": _poison_magic, "old_format": _poison_old_format}


@pytest.mark.parametrize("poison", sorted(POISONS))
def test_poisoned_plan_entries_are_honest_misses(tmp_path, poison):
    """A corrupt, truncated or old-format plan entry reads as no entry:
    deleted, counted under errors, the insert carries no lineage."""
    conf = _on(tmp_path)
    PlanCache(4, conf).insert("tpl", CacheEntry(object(), {}, "ph"))
    assert persist.flush(30.0)
    (path,) = _entries(str(tmp_path / "store"), "plans")
    POISONS[poison](path)
    persist.reset_stats()
    pc = PlanCache(4, conf)
    assert pc.lookup("tpl") is None
    e = CacheEntry(object(), {}, "ph")
    pc.insert("tpl", e)
    assert e.rehydrated is None
    st = persist.stats()
    assert st["plan_hits"] == 0 and st["errors"] == 1, st
    assert persist.flush(30.0)
    # the next generation starts the lineage again from 1
    again = CacheEntry(object(), {}, "ph")
    pc2 = PlanCache(4, conf)
    pc2.lookup("tpl")
    pc2.insert("tpl", again)
    assert again.rehydrated["prepares"] == 1


@pytest.mark.parametrize("poison", sorted(POISONS))
def test_poisoned_result_entries_are_honest_misses(tmp_path, poison):
    """A corrupt, truncated or old-format result frame reads as a miss,
    never an exception or a wrong row: deleted and counted; a query over
    it runs and answers as the unpoisoned one did."""
    conf = _on(tmp_path, **{C.SHARING_ENABLED: True})
    s = TorchSession(conf, device="cpu")
    t = pa.table({"k": np.arange(64, dtype=np.int64) % 8,
                  "v": np.arange(64, dtype=np.int64)})
    df = (s.create_dataframe(t).group_by(col("k"))
          .agg((sum_(col("v")), "sv")).order_by(col("k")))
    want = df.collect()
    assert persist.flush(30.0)
    (path,) = _entries(str(tmp_path / "store"), "results")
    POISONS[poison](path)
    ws.reset()  # the next process's empty memory tier
    persist.reset_stats()
    got = df.collect()
    assert table_digest(got) == table_digest(want)
    st, share = persist.stats(), ws.stats()
    assert st["result_hits"] == 0 and st["errors"] == 1, st
    assert share["result_misses"] == 1 and share["result_hits"] == 0
    assert persist.flush(30.0)
    # the miss re-executed and wrote a whole frame back
    (fresh,) = _entries(str(tmp_path / "store"), "results")
    assert persist.PersistStore(str(tmp_path / "store"))._read_entry(
        fresh) is not None


def test_concurrent_writers_from_two_processes(tmp_path):
    """Two processes writing one entry's path at once: the temp file and
    os.replace leave one whole entry (its header matches its payload),
    never an interleaved one."""
    root = str(tmp_path / "store")
    persist.PersistStore(root)
    script = (
        "import os, sys\n"
        "root, tag = sys.argv[1], sys.argv[2]\n"
        "from spark_rapids_tpu_torch.persist import PersistStore\n"
        "store = PersistStore(root)\n"
        "path = os.path.join(root, 'results', 'res-shared.tpup')\n"
        "payload = tag.encode() * 4096\n"
        "for _ in range(40):\n"
        "    store._write_entry(path, {'writer': tag}, payload)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", script, root, tag],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for tag in ("A", "B")]
    for p in procs:
        _out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()[-2000:]
    rec = persist.PersistStore(root)._read_entry(
        os.path.join(root, "results", "res-shared.tpup"))
    assert rec is not None, "the surviving entry failed validation"
    meta, payload = rec
    assert meta["writer"] in ("A", "B")
    assert payload == meta["writer"].encode() * 4096
    assert [n for n in os.listdir(os.path.join(root, "results"))
            if n.startswith(".tmp-")] == []


# -- eviction ----------------------------------------------------------- #

def test_lru_eviction_respects_byte_budget(tmp_path):
    """The sweep deletes the oldest entries by mtime until the rest fit;
    a hit touches its entry, so a recently read one outlives an older
    unread one."""
    store = persist.active(_on(tmp_path))
    paths = []
    for i in range(4):
        path = os.path.join(store.root, "results", f"res-e{i}.tpup")
        assert store._write_entry(path, {"i": i}, bytes(1000))
        os.utime(path, (1000.0 + i, 1000.0 + i))
        paths.append(path)
    per_entry = os.stat(paths[0]).st_size
    assert store._read_entry(paths[0]) is not None  # touched
    assert store.evict_over_budget(per_entry * 2) == 2
    assert persist.stats()["evictions"] == 2
    assert os.path.exists(paths[0]) and os.path.exists(paths[3])
    assert not os.path.exists(paths[1]) and not os.path.exists(paths[2])


def test_writes_sweep_to_max_bytes(tmp_path):
    """persist.maxBytes bounds the store after each write."""
    conf = _on(tmp_path, **{C.PERSIST_MAX_BYTES: 1})
    pc = PlanCache(4, conf)
    for i in range(3):
        pc.insert(f"tpl-{i}", CacheEntry(object(), {}, "ph"))
    assert persist.flush(30.0)
    assert _entries(str(tmp_path / "store"), "plans") == []
    assert persist.stats()["evictions"] == 3


# -- the plan tier ------------------------------------------------------ #

def test_plan_cache_rehydrates_prepare_lineage(tmp_path):
    """A fresh cache's miss probes the disk tier; the insert that
    follows carries the persisted metadata and writes back the next
    generation (prepares 1, then 2)."""
    conf = _on(tmp_path)
    pc = PlanCache(4, conf)
    assert pc.lookup("tpl-1") is None
    pc.insert("tpl-1", CacheEntry(object(), {}, "ph-abc"))
    assert persist.flush(30.0)
    assert persist.stats()["plan_writes"] == 1

    pc2 = PlanCache(4, conf)  # the next process
    assert pc2.lookup("tpl-1") is None  # the tree itself is lowered again
    assert persist.stats()["plan_hits"] == 1
    e2 = CacheEntry(object(), {}, "ph-abc")
    pc2.insert("tpl-1", e2)
    assert e2.rehydrated == {"plan_hash": "ph-abc", "prepares": 1}
    assert persist.flush(30.0)
    assert persist.stats()["plan_writes"] == 2

    pc3 = PlanCache(4, conf)
    assert pc3.lookup("tpl-1") is None
    e3 = CacheEntry(object(), {}, "ph-abc")
    pc3.insert("tpl-1", e3)
    assert int(e3.rehydrated["prepares"]) == 2


# -- the result tier ---------------------------------------------------- #

def _result_table():
    return pa.table({"k": [1, 2, 3], "v": [10, 20, 30]})


def test_result_cache_disk_tier_roundtrip(tmp_path):
    """A frame persists as its exact IPC bytes with its stat triples and
    restores lazily on the first probe of a fresh cache, re-entering the
    memory tier (a second probe is a memory hit)."""
    conf = _on(tmp_path)
    TorchSession(device="cpu")  # the process store the frames enter
    digests = [("li.parquet", 1234, 567890)]
    tbl = _result_table()
    rc = ws.ResultCache()
    assert rc.insert("res-key", digests, tbl, BUDGET, conf)
    assert persist.flush(30.0)
    assert persist.stats()["result_writes"] == 1

    rc2 = ws.ResultCache()  # the next process
    got = rc2.lookup("res-key", digests, conf)
    assert got is not None and got.equals(tbl)
    assert persist.stats()["result_hits"] == 1
    assert len(rc2) == 1
    assert rc2.lookup("res-key", digests, conf).equals(tbl)
    assert persist.stats()["result_hits"] == 1
    assert persist.flush(30.0)
    assert persist.stats()["result_writes"] == 1  # its file was there
    rc.reset()
    rc2.reset()


def test_result_cache_persisted_frame_invalidated_by_digest(tmp_path):
    """A frame whose stat triples differ from the inputs' current ones is
    deleted and reads as a miss: the file-change contract crosses a
    restart."""
    conf = _on(tmp_path)
    TorchSession(device="cpu")
    digests = [("li.parquet", 1234, 567890)]
    rc = ws.ResultCache()
    assert rc.insert("res-key", digests, _result_table(), BUDGET, conf)
    assert persist.flush(30.0)
    rc.reset()
    rc2 = ws.ResultCache()
    assert rc2.lookup("res-key", [("li.parquet", 1234, 999999)],
                      conf) is None
    assert persist.stats()["result_hits"] == 0
    assert ws.stats()["result_invalidations"] == 1
    assert _entries(str(tmp_path / "store"), "results") == []


# -- observability ------------------------------------------------------ #

def test_persist_counter_surface_and_gauge(tmp_path):
    """The persist.* counters ride the event log's monotonic surface;
    persist_cache.bytes is a gauge, 0 with no directory walk while no
    store was activated, then the store's bytes."""
    from spark_rapids_tpu.eventlog import MONOTONIC_COUNTERS as JMONO

    from spark_rapids_tpu_torch.eventlog import (
        MONOTONIC_COUNTERS,
        counters_snapshot,
    )
    from spark_rapids_tpu_torch.trace.telemetry import sample_now

    persisted = [k for k in JMONO if k.startswith("persist.")]
    assert persisted and set(persisted) <= set(MONOTONIC_COUNTERS)
    assert "persist_cache.bytes" not in MONOTONIC_COUNTERS
    walks = []
    real = persist.PersistStore.bytes_used
    persist.PersistStore.bytes_used = \
        lambda self: walks.append(1) or real(self)
    try:
        assert counters_snapshot()["persist_cache.bytes"] == 0
        assert sample_now()["persist_cache.bytes"] == 0
        assert walks == []
        store = persist.active(_on(tmp_path))
        assert persist.cache_bytes() == 0
        store._write_entry(os.path.join(store.root, "plans",
                                        "plan-x.tpup"), {}, bytes(512))
        assert counters_snapshot()["persist_cache.bytes"] > 512
        assert sample_now()["persist_cache.bytes"] > 512
    finally:
        persist.PersistStore.bytes_used = real
    snap = counters_snapshot()
    assert snap["persist.writes"] == 1
    assert snap["persist.hits"] == snap["persist.misses"] == 0


def test_event_log_records_the_store(tmp_path):
    """A query record holds every persist.* counter as its window's
    delta and persist_cache.bytes as the gauge read at its end: the
    second session's record sees the first's entry on disk.  The
    lineage is restored at prepare time, before the query's window,
    as in the JAX package.  The port's records hold jit.compiles at 0,
    so HC017 stays silent on them."""
    from spark_rapids_tpu.eventlog import MONOTONIC_COUNTERS as JMONO

    conf = {C.PERSIST_ENABLED: True, C.PERSIST_DIR: str(tmp_path / "p"),
            C.EVENTLOG_ENABLED: True, C.EVENTLOG_DIR: str(tmp_path / "log")}
    t = pa.table({"k": np.arange(256, dtype=np.int64) % 4,
                  "v": np.arange(256, dtype=np.int64)})
    paths, lineage = [], []
    for _ in range(2):
        s = TorchSession(conf, device="cpu")
        prepared = s.prepare(s.create_dataframe(t).group_by(col("k"))
                             .agg((sum_(col("v")), "sv"))
                             .order_by(col("k")))
        assert prepared.execute().num_rows == 4
        assert persist.flush(30.0)
        s.history.events  # the worker appended the record
        paths.append(s.event_log_path)
        lineage.append(prepared.last_rehydrated)
    assert lineage[0] is None and lineage[1]["prepares"] == 1
    second = PH.load_application(paths[1]).queries[-1]
    for key in JMONO:
        if key.startswith("persist."):
            assert key in second.counters, key
    assert second.counter("persist_cache.bytes") > 0
    assert second.counter("jit.compiles") == 0
    assert not [f for f in PH.health_check(PH.load_application(paths[1]))
                if f.rule == "HC017"]


HC017_RECORDS = {
    "low": {"persist.hits": 1, "persist.misses": 9, "jit.compiles": 4},
    "healthy": {"persist.hits": 9, "persist.misses": 1, "jit.compiles": 1},
    "persist_off": {"jit.compiles": 5},
    "all_restored": {"persist.hits": 3, "persist.misses": 7},
}


@pytest.mark.parametrize("name", sorted(HC017_RECORDS))
def test_hc017_verdicts_equal_the_jax_rule(name):
    """HC017 fires on the record the JAX rule fires on (a window that
    probed the store, paid real compiles and hit under
    persist.health.minHitRate) and stays silent on the rest."""
    assert any(r[0] == "HC017" and r[1] == "warning"
               for r in PH.HEALTH_RULES)
    counters = HC017_RECORDS[name]

    def record(tool):
        return tool.QueryRecord(
            query_id="q", plan="", plan_hash="", engine="tpu", wall_s=1.0,
            start_ts=0.0, end_ts=1.0, conf_hash="", counters=counters,
            operators=None, spans=None, pipeline=None, faults=None,
            result_digest=None, rows=0, raw={})

    got = PH._hc_persist_low_hit(record(PH))
    want = JH._hc_persist_low_hit(record(JH))
    assert got == want
    assert (got is not None) == (name == "low")


# -- the cold processes ------------------------------------------------- #

def test_cold_processes_off_empty_warm_and_result_tier(tmp_path):
    """Five fresh processes run the fixture on the CPU: persistence off,
    an empty store, the warm store (the lineage restored: prepares 2,
    plan_hits 1), then the result-tier mode (sharing on) twice: the first
    writes the frame, the second restores it with result_hits 1 and no
    dispatch.  Digests and rows are equal everywhere, and the plan mode
    dispatches alike off, empty and warm.  A fixture file rewritten in
    place (its stat triple moves) makes the next result-tier child miss,
    delete the frame and run again to the same digest."""
    data, root = str(tmp_path / "data"), str(tmp_path / "store")
    os.makedirs(data)
    cs.make_fixture(data)

    def child(persist_dir, mode="plan"):
        return cs.run_subprocess(data, persist_dir, mode=mode,
                                 device="cpu", timeout=120)

    off = child(None)
    empty = child(root)
    warm = child(root)
    populate = child(root, "result")
    restored = child(root, "result")
    runs = (off, empty, warm, populate, restored)
    assert len({r["digest"] for r in runs}) == 1
    assert {r["rows"] for r in runs} == {4}
    assert off["dispatches"] == empty["dispatches"] == warm["dispatches"] \
        == populate["dispatches"] > 0
    assert off["k1_dispatches"] == warm["k1_dispatches"] == cs.FIXTURE_FILES
    assert {r["compiles"] for r in runs} == {0}
    assert (empty["prepares"], warm["prepares"]) == (1, 2)
    assert warm["persist"]["plan_hits"] == 1
    assert empty["persist"]["plan_hits"] == 0
    assert off["persist"]["writes"] == 0
    assert populate["persist"]["result_writes"] == 1
    assert restored["result_hits"] == 1
    assert restored["persist"]["result_hits"] == 1
    assert restored["dispatches"] == restored["k1_dispatches"] == 0
    assert restored["prepares"] == 2

    path = cs.fixture_paths(data)[0]
    table = pq.read_table(path)
    time.sleep(0.01)
    pq.write_table(table, path)
    moved = child(root, "result")
    assert moved["result_hits"] == 0 and moved["result_invalidations"] == 1
    assert moved["digest"] == off["digest"]
    assert moved["dispatches"] == off["dispatches"]


def test_run_once_in_process_counts_its_own_run(tmp_path):
    """In a process that has run queries before, ``run_once``'s
    dispatches are its own run's: the ledger's delta over it, equal from
    one call to the next and to a cold child's."""
    data = str(tmp_path / "data")
    os.makedirs(data)
    cs.make_fixture(data)
    first = cs.run_once(data, None, device="cpu")
    second = cs.run_once(data, None, device="cpu")
    child = cs.run_subprocess(data, None, device="cpu", timeout=120)
    assert first["digest"] == second["digest"] == child["digest"]
    assert first["dispatches"] == second["dispatches"] \
        == child["dispatches"] > 0
    assert first["k1_dispatches"] == second["k1_dispatches"] \
        == cs.FIXTURE_FILES
