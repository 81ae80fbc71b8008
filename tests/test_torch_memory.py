"""The port's buffer store, its disk frame and its keys, against the JAX
package's (``spark_rapids_tpu/memory/store.py``, ``columnar/serde.py``).

The store tests mirror ``tests/test_memory.py``: round trip, spill to
host and back, the chain to disk, priority order, the leak report.
The tier each handle ends in is held against the JAX ``BufferStore``
for the same sequence of registers, gets, unpins and closes, at device
budgets of 1 byte (every register spills every earlier unpinned entry)
and 1 << 30 (nothing spills): the two stores count bytes differently
(the JAX one pads to a power-of-two capacity), so only at those budgets
do they decide alike.  Frames are held byte for byte both ways.
"""

import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar import serde as jserde
from spark_rapids_tpu.memory import store as jstore

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar import serde
from spark_rapids_tpu_torch.columnar.arrow import from_arrow, to_arrow
from spark_rapids_tpu_torch.memory import device_manager
from torch_plugin import fresh_plugin, sized_plugin  # noqa: F401
from spark_rapids_tpu_torch.memory.store import (
    BufferStore,
    SpillPriorities,
    StorageTier,
    batch_device_bytes,
    get_store,
    reset_store,
)

CPU = torch.device("cpu")
JSCHEMA = JT.Schema([JT.Field("a", JT.LONG), JT.Field("s", JT.STRING)])


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.integers(0, 100, n).astype(np.int64),
            "s": [f"row{i}-{'x' * (i % 7)}" for i in range(n)]}


def port_batch(n, seed=0):
    d = _data(n, seed)
    return from_arrow(pa.table({"a": d["a"], "s": d["s"]}), CPU)


def jax_batch(n, seed=0):
    d = _data(n, seed)
    return JBatch.from_numpy({"a": d["a"], "s": np.asarray(d["s"], object)},
                             JSCHEMA)


def rows(batch):
    return to_arrow(batch).to_pydict()


def test_register_get_round_trip():
    store = BufferStore(device_budget=1 << 30, host_budget=1 << 30)
    b = port_batch(100)
    want = rows(b)
    h = store.register(b)
    assert h.tier == StorageTier.DEVICE
    assert store.device_used == batch_device_bytes(b) > 0
    assert rows(h.get()) == want
    h.close()
    assert store.device_used == 0
    assert store.spill_stats()["peak_device_used"] == batch_device_bytes(b)
    store.close()


def test_spill_to_host_and_back():
    store = BufferStore(device_budget=1, host_budget=1 << 30)
    b1, b2 = port_batch(200, 1), port_batch(200, 2)
    want = rows(b1)
    h1 = store.register(b1, SpillPriorities.COALESCE_PENDING)
    store.register(b2, SpillPriorities.ACTIVE_ON_DECK)
    assert h1.tier == StorageTier.HOST
    st = store.spill_stats()
    assert st["spilled_device_to_host"] == batch_device_bytes(b1)
    assert rows(h1.get()) == want
    assert h1.tier == StorageTier.DEVICE
    assert store.spill_stats()["restores"] == 1
    store.close()
    assert store.leak_report() == []


def test_spill_chain_to_disk(tmp_path):
    store = BufferStore(device_budget=1, host_budget=1,
                        spill_dir=str(tmp_path))
    b1 = port_batch(150, 3)
    want = rows(b1)
    h1 = store.register(b1)
    store.register(port_batch(150, 4))
    assert h1.tier == StorageTier.DISK
    assert store.spilled_host_to_disk > 0
    assert list(tmp_path.glob("spill-*.tpub"))
    assert rows(h1.get()) == want
    store.close()
    assert not list(tmp_path.glob("spill-*"))


def test_spill_priority_order():
    store = BufferStore(device_budget=1, host_budget=1 << 30)
    hs = [store.register(port_batch(50, i), prio)
          for i, prio in enumerate([SpillPriorities.JOIN_BUILD,
                                    SpillPriorities.OUTPUT_FOR_SHUFFLE,
                                    SpillPriorities.ACTIVE_ON_DECK])]
    assert [h.tier for h in hs] == [StorageTier.HOST, StorageTier.HOST,
                                    StorageTier.DEVICE]
    store.close()


def test_victims_lowest_priority_then_oldest():
    """Room for two of four equal batches: the lowest (priority, id)
    go first."""
    b = port_batch(64, 9)
    nb = batch_device_bytes(b)
    store = BufferStore(device_budget=2 * nb, host_budget=1 << 30)
    prios = [SpillPriorities.BROADCAST, SpillPriorities.AGGREGATE_PARTIAL,
             SpillPriorities.AGGREGATE_PARTIAL, SpillPriorities.JOIN_BUILD]
    hs = [store.register(port_batch(64, 9), p) for p in prios]
    assert [h.tier.name for h in hs] == ["DEVICE", "HOST", "HOST", "DEVICE"]
    store.close()


def test_pinned_entries_are_never_victims():
    store = BufferStore(device_budget=1, host_budget=1 << 30)
    h1 = store.register(port_batch(10, 1))
    got = h1.get()  # pinned
    store.register(port_batch(10, 2))
    assert h1.tier == StorageTier.DEVICE
    h1.unpin()
    store.register(port_batch(10, 3))
    assert h1.tier == StorageTier.HOST
    assert rows(got) == rows(h1.get())
    store.close()


#: the op sequence both stores run: ("reg", seed, priority) |
#: ("get", i) | ("unpin", i) | ("close", i) on the i-th handle
OPS = [("reg", 1, SpillPriorities.JOIN_BUILD),
       ("reg", 2, SpillPriorities.OUTPUT_FOR_SHUFFLE),
       ("reg", 3, SpillPriorities.ACTIVE_ON_DECK),
       ("get", 0), ("reg", 4, SpillPriorities.AGGREGATE_PARTIAL),
       ("unpin", 0), ("get", 1), ("close", 2),
       ("reg", 5, SpillPriorities.BROADCAST), ("unpin", 1),
       ("reg", 6, SpillPriorities.COALESCE_PENDING), ("get", 3),
       ("get", 0), ("close", 1), ("unpin", 3),
       ("reg", 7, SpillPriorities.OUTPUT_FOR_SHUFFLE)]


def _run_ops(store, make, to_rows):
    handles, tiers, out = [], [], []
    for op in OPS:
        if op[0] == "reg":
            handles.append(store.register(make(40 + op[1], op[1]), op[2]))
        elif op[0] == "get":
            # read at once: the JAX store deletes a spilled batch's arrays
            out.append(to_rows(handles[op[1]].get()))
        elif op[0] == "unpin":
            handles[op[1]].unpin()
        else:
            handles[op[1]].close()
            handles[op[1]] = None
        tiers.append([None if h is None else h.tier.name for h in handles])
    return tiers, out


@pytest.mark.parametrize("device_budget,host_budget", [
    (1, 1 << 30), (1, 1), (1 << 30, 1 << 30)])
def test_tiers_equal_the_jax_store(tmp_path, device_budget, host_budget):
    js = jstore.BufferStore(device_budget=device_budget,
                            host_budget=host_budget,
                            spill_dir=str(tmp_path / "jax"))
    ps = BufferStore(device_budget=device_budget, host_budget=host_budget,
                     spill_dir=str(tmp_path / "port"))
    try:
        jt, jout = _run_ops(js, jax_batch, lambda b: b.to_pydict())
        pt, pout = _run_ops(ps, port_batch, rows)
        assert pt == jt
        assert pout == jout
    finally:
        js.close()
        ps.close()


def test_leak_report():
    store = BufferStore(device_budget=1 << 30)
    store.assert_all_released()
    h = store.register(port_batch(10))
    leaks = store.leak_report()
    assert len(leaks) == 1 and "tier=DEVICE" in leaks[0]
    with pytest.raises(AssertionError, match="never released"):
        store.assert_all_released()
    h.close()
    store.assert_all_released()


def test_mark_consumed_hands_the_batch_off():
    from spark_rapids_tpu_torch.memory.store import ConsumedBatchError

    store = BufferStore(device_budget=1 << 30)
    h = store.register(port_batch(10))
    h.mark_consumed()
    assert store.leak_report() == [] and store.device_used == 0
    h.unpin()
    h.close()
    with pytest.raises(ConsumedBatchError):
        h.get()


def test_register_host_and_get_host(tmp_path):
    from spark_rapids_tpu_torch.memory.store import batch_to_host

    store = BufferStore(device_budget=1 << 30, host_budget=1,
                        spill_dir=str(tmp_path))
    b = port_batch(30, 5)
    h = store.register_host(batch_to_host(b), b.schema, CPU)
    assert h.tier == StorageTier.DISK  # over the host budget at once
    host = h.get_host()
    assert int(host["__num_rows"]) == 30
    h.unpin()
    assert rows(h.get()) == rows(b)
    store.close()


def test_registers_from_four_threads():
    """Four threads register, read back and close under a budget that
    keeps the store spilling; every batch comes back intact and the
    accounting returns to zero."""
    nb = batch_device_bytes(port_batch(64, 0))
    store = BufferStore(device_budget=3 * nb, host_budget=6 * nb)
    errors = []

    def worker(t):
        try:
            hs = [(store.register(port_batch(64, 100 * t + i),
                                  SpillPriorities.OUTPUT_FOR_SHUFFLE),
                   100 * t + i) for i in range(12)]
            for h, seed in hs:
                assert rows(h.get()) == rows(port_batch(64, seed))
                h.unpin()
            for h, _ in hs:
                h.close()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors, errors
    st = store.spill_stats()
    assert st["spilled_device_to_host"] > 0 and st["spilled_host_to_disk"] > 0
    assert (st["device_used"], st["host_used"], st["disk_used"]) == (0, 0, 0)
    assert store.leak_report() == []
    store.close()


def _frame_arrays():
    rng = np.random.default_rng(5)
    return {"c0_data": rng.integers(-9, 9, 17).astype(np.int64),
            "c0_valid": rng.random(17) < 0.8,
            "c1_chars": rng.integers(0, 255, (17, 5)).astype(np.uint8),
            "c1_lengths": rng.integers(0, 5, 17).astype(np.int32),
            "f": rng.random(17),
            "empty": np.zeros(0, np.int32),
            "__num_rows": np.asarray(17, np.int64)}


def test_serde_frames_equal_both_ways():
    arrays = _frame_arrays()
    frame = serde.serialize_arrays(arrays)
    assert frame == jserde.serialize_arrays(arrays, "none")
    back = jserde.deserialize_arrays(frame)
    mine = serde.deserialize_arrays(jserde.serialize_arrays(arrays, "none"))
    for k, a in arrays.items():
        a = np.ascontiguousarray(a)  # both frame a 0-d array as 1-d
        for got in (back[k], mine[k]):
            assert got.dtype == a.dtype and got.shape == a.shape
            assert np.array_equal(got, a)


def test_serde_refuses_byte_codecs():
    """The byte codecs the registry lacks, or that have no byte form,
    raise as in the JAX registry (``zlib`` is ported:
    tests/test_torch_wire_compression.py)."""
    for name in ("lz4", "bitpack"):
        with pytest.raises(ValueError, match=name):
            serde.serialize_arrays(_frame_arrays(), name)
        with pytest.raises(ValueError, match=name):
            jserde.serialize_arrays(_frame_arrays(), name)
        with pytest.raises(ValueError, match=name):
            BufferStore(codec=name)
    frame = bytearray(serde.serialize_arrays(_frame_arrays(), "zlib"))
    at = frame.index(b'"codec": "zlib"')
    frame[at:at + 15] = b'"codec": "zzzz"'
    with pytest.raises(ValueError, match="zzzz"):
        serde.deserialize_arrays(bytes(frame))


def test_keys_default_as_in_the_jax_package():
    from spark_rapids_tpu.execs import coalesce as jcoalesce
    from spark_rapids_tpu.execs import retry as jretry
    from spark_rapids_tpu.execs import sort as jsort
    from spark_rapids_tpu.memory import device_manager as jdm
    from spark_rapids_tpu.robustness import faults as jfaults

    jax_keys = [jstore.HBM_BUDGET_BYTES, jstore.HOST_SPILL_BYTES,
                jstore.SPILL_DIR, jdm.MEMORY_FRACTION,
                jserde.SPILL_COMPRESSION, jretry.TASK_MAX_FAILURES,
                jretry.RETRY_BACKOFF_S, jretry.SPLIT_RETRY_ENABLED,
                jretry.SPLIT_MIN_ROWS, jsort.SORT_SINGLE_BATCH_ROWS,
                jsort.SORT_MAX_BUCKETS, jcoalesce.COALESCE_ENABLED,
                jcoalesce.COALESCE_TARGET_ROWS,
                jcoalesce.COALESCE_TARGET_BYTES, jfaults.FAULTS_ENABLED,
                jfaults.FAULTS_SPEC]
    for k in jax_keys:
        assert C.DEFAULTS[k.key] == k.default, k.key
    assert "spark.rapids.tpu.sql.recovery.cpuFallbackOnDeviceError" \
        not in C.DEFAULTS


def test_initialize_on_the_cpu_keeps_the_budget_key(tmp_path):
    conf = C.TorchConf({C.HBM_BUDGET_BYTES: 12345, C.HOST_SPILL_BYTES: 77,
                        C.SPILL_DIR: str(tmp_path)})
    try:
        store = device_manager.initialize(conf, CPU)
        assert get_store() is store
        assert (store.device_budget, store.host_budget) == (12345, 77)
        assert device_manager.device_budget(C.TorchConf(), CPU) == 12 << 30
    finally:
        reset_store()


def test_host_buffer_pool_recycles():
    pool = device_manager.HostBufferPool(max_bytes=1 << 20)
    buf = pool.take(5000)
    assert buf.dtype == torch.uint8 and buf.numel() == 8192
    pool.give(buf)
    assert pool.take(6000) is buf
    pool.give(torch.empty(100, dtype=torch.uint8))  # not a bucket: dropped
    assert pool._held == 0


def test_session_store_is_empty_after_collect(tmp_path):
    """A session spills everything (device budget 1, host budget 1):
    the aggregate over an exchange equals the unconstrained run bit for
    bit, its spill counters moved, and the store is empty after."""
    from spark_rapids_tpu_torch import TorchSession, col, sum_

    rng = np.random.default_rng(3)
    t = pa.table({"k": rng.integers(0, 5, 1000), "v": rng.random(1000)})
    base = {C.BATCH_ROWS: 128, C.SHUFFLE_PARTITIONS: 3}

    def run(conf):
        # the store is the process's: size it from this conf
        with sized_plugin(conf):
            s = TorchSession(conf, device="cpu")
            df = s.create_dataframe(t).group_by(col("k")).agg(
                (sum_(col("v")), "s"))
            got = df.collect()
            return s.spill_stats(), s.store.leak_report(), got

    _, _, want = run(base)
    st, leaks, got = run({**base, C.HBM_BUDGET_BYTES: 1,
                          C.HOST_SPILL_BYTES: 1, C.SPILL_DIR: str(tmp_path)})
    assert got.equals(want)
    assert st["spilled_device_to_host"] > 0 and st["spilled_host_to_disk"] > 0
    assert leaks == []
    assert not list(tmp_path.glob("spill-*"))


def _nested_table(n=120, seed=5):
    """A struct with a STRING field, an array and a map, NULLs at every
    level, as one table."""
    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.2
    s = pa.StructArray.from_arrays(
        [pa.array(rng.integers(0, 9, n), pa.int64(),
                  mask=rng.random(n) < 0.2),
         pa.array([f"w{i}" for i in range(n)])], names=["x", "w"],
        mask=pa.array(null))
    lists = [None if null[i] else rng.integers(0, 50, i % 4).tolist()
             for i in range(n)]
    maps = [None if rng.random() < 0.1 else
            [(j, float(j) / 3) for j in range(i % 3)] for i in range(n)]
    return pa.table({"s": s, "a": pa.array(lists, pa.list_(pa.int64())),
                     "m": pa.array(maps, pa.map_(pa.int64(), pa.float64()))})


@pytest.mark.parametrize("sliced", [False, True])
def test_nested_batch_spills_to_disk_and_restores_bit_for_bit(tmp_path,
                                                             sliced):
    """Arrays, maps and structs spill DEVICE -> HOST -> DISK as their
    offsets, validity and children's leaves, and come back equal, a
    sliced batch (offsets rebased, children its own elements) too."""
    t = _nested_table()
    b = from_arrow(t, CPU)
    if sliced:
        b, t = b.slice(17, 90), t.slice(17, 73)
    store = BufferStore(device_budget=1, host_budget=1,
                        spill_dir=str(tmp_path))
    h = store.register(b, SpillPriorities.COALESCE_PENDING)
    h.unpin()
    store.register(port_batch(50, 6))
    assert h.tier == StorageTier.DISK
    host = h.get_host()
    assert any(k.startswith("c0_f0") for k in host)
    assert {"c1_offsets", "c1_e_data", "c2_k_data", "c2_v_valid"} <= set(host)
    back = to_arrow(h.get())
    for c in t.column_names:
        assert back.column(c).combine_chunks().equals(
            t.column(c).combine_chunks()), c
    store.close()
    assert store.leak_report() == []


def test_nested_queries_spill_and_equal_the_unconstrained_run(tmp_path):
    """explode over an exchange and a partitioned collect_list, every
    batch spilled to host and disk: the rows equal the unconstrained
    run's bit for bit and the store is empty after."""
    from spark_rapids_tpu_torch import TorchSession, col
    from spark_rapids_tpu_torch.session import collect_list, explode

    t = _nested_table(600, 7).append_column(
        "k", pa.array(np.arange(600) % 7))
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"n{i}.parquet"))
        pq.write_table(t.slice(i * 200, 200), paths[-1])
    base = {C.BATCH_ROWS: 64, C.SHUFFLE_PARTITIONS: 3,
            C.TASK_TARGET_BYTES: 1}

    def run(conf):
        with sized_plugin(conf):
            s = TorchSession(conf, device="cpu")
            df = s.read_parquet(*paths).select(
                col("k"), col("s"), explode(col("a")).alias("x")).group_by(
                col("k")).agg((collect_list(col("x")), "xs"))
            got = df.collect().sort_by("k")
            return s.spill_stats(), s.store.leak_report(), got

    _, _, want = run(base)
    st, leaks, got = run({**base, C.HBM_BUDGET_BYTES: 1,
                          C.HOST_SPILL_BYTES: 1,
                          C.SPILL_DIR: str(tmp_path / "spill")})
    assert got.equals(want)
    assert st["spilled_device_to_host"] > 0 and st["spilled_host_to_disk"] > 0
    assert leaks == []
