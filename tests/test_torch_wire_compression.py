"""The port's codecs (``spark_rapids_tpu_torch/columnar/compression/``)
and what uses them: the compressed wire, the spill frames, the
compressed host tier, and q6, q1 and q3ds on the three upload paths.

Counterparts of ``tests/test_wire_compression.py``, each held against
the JAX package on the CPU.  Compression re-encodes losslessly: every
array codec's packed words equal the JAX codec's for the same array,
and its torch decode rebuilds the array bit for bit; compression off is
byte for byte the uncompressed wire (the chooser is never consulted);
a zlib frame either package writes, the other reads.  The JAX package's
``test_fused_decode_roundtrip`` waits for the fused chains (ROADMAP
item 9.1) and ``test_shuffle_server_stats_surface`` for the network
shuffle (item 10).
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import bench
from spark_rapids_tpu.columnar import compression as JWC
from spark_rapids_tpu.columnar import serde as jserde
from spark_rapids_tpu.columnar import transfer as JTR
from spark_rapids_tpu.config import get_conf, set_conf
from spark_rapids_tpu.exprs.base import lit as jlit
from spark_rapids_tpu.session import SortKey as JSortKey
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import sum_ as jsum
from spark_rapids_tpu.tools import tpcds_schema

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession, col, count_star, lit, sum_
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import tpcds, tpch
from spark_rapids_tpu_torch import trace as PT
from spark_rapids_tpu_torch.columnar import compression as WC
from spark_rapids_tpu_torch.columnar import serde
from spark_rapids_tpu_torch.columnar import transfer as TR
from spark_rapids_tpu_torch.columnar.arrow import (
    from_arrow,
    schema_from_arrow,
    to_arrow,
)
from spark_rapids_tpu_torch.columnar.compression.codecs import (
    storage_dtype,
)
from spark_rapids_tpu_torch.execs import retry as R
from spark_rapids_tpu_torch.memory.store import (
    BufferStore,
    StorageTier,
    _HostFrame,
)
from spark_rapids_tpu_torch.plan.planner import collect_exec
from spark_rapids_tpu_torch.robustness import faults
from spark_rapids_tpu_torch.trace import ledger as PL
from torch_plugin import fresh_plugin  # noqa: F401

CPU = torch.device("cpu")
TTB = C.TASK_TARGET_BYTES
WIRE_KEY = "spark.rapids.tpu.sql.wireCompression.enabled"
ALL = ("bitpack", "delta", "rle")
BLOCK = 256
#: codec -> the logical dtypes its round trip covers (the JAX matrix)
ROUND_TRIP_MATRIX = {
    "bitpack": ["int32", "int64", "date32", "timestamp", "dict-codes",
                "validity"],
    "delta": ["int32", "int64", "date32", "timestamp"],
    "rle": ["int32", "int64", "dict-codes", "validity"],
    "none": ["bytes"],
    "zlib": ["bytes"],
}
#: the upload paths: packedUpload off, on, on with the default codecs
PATHS = {"plain": {C.PACKED_UPLOAD: False},
         "wire": {C.PACKED_UPLOAD: True},
         "compressed": {C.PACKED_UPLOAD: True, C.WIRE_COMPRESSION: True}}


@pytest.fixture(autouse=True)
def _reset_stats():
    WC.reset_stats()
    TR.reset_upload_stats()
    conf = get_conf()
    saved = conf.get(WIRE_KEY)
    yield
    conf.set(WIRE_KEY, saved)
    faults.disarm()
    WC.reset_stats()


def _gen(kind: str, n: int, rng) -> np.ndarray:
    if kind == "int32":
        return np.sort(rng.integers(0, 5000, n)).astype(np.int32)
    if kind == "int64":
        return (rng.integers(0, 100, n) + 10**14).astype(np.int64)
    if kind == "date32":
        return np.sort(rng.integers(8766, 10957, n)).astype(np.int32)
    if kind == "timestamp":
        base = 1_600_000_000_000_000
        return np.sort(base + rng.integers(0, 10**9, n)).astype(np.int64)
    if kind == "dict-codes":
        return rng.integers(0, 7, n).astype(np.uint16)
    if kind == "validity":
        return rng.random(n) < 0.95
    raise AssertionError(kind)


def _torch_decode(codec: str, arrays, meta, dtype) -> np.ndarray:
    """The torch decode of host-packed arrays (each held as
    ``storage_dtype`` holds a component), as the original's dtype."""
    ts = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.dtype.kind == "u" and a.dtype.itemsize > 1:
            a = a.view(f"i{a.dtype.itemsize}")
        ts.append(torch.from_numpy(a))
    out = WC.get_codec(codec).decode_array(ts, meta, np.dtype(dtype))
    assert out.dtype == storage_dtype(np.dtype(dtype))
    return out.numpy().view(np.dtype(dtype))


def _assert_same_pack(codec: str, v: np.ndarray):
    """The port's and the JAX codec's packing of ``v`` alike, and the
    torch decode rebuilding ``v``."""
    enc = WC.get_codec(codec).encode_array(v, BLOCK)
    jenc = JWC.get_codec(codec).encode_array(v, BLOCK)
    assert (enc is None) == (jenc is None)
    if enc is None:
        return
    (arrays, meta), (jarrays, jmeta) = enc, jenc
    assert meta == jmeta
    assert [a.tobytes() for a in arrays] == [a.tobytes() for a in jarrays]
    dec = _torch_decode(codec, arrays, meta, v.dtype)
    assert dec.dtype == v.dtype and np.array_equal(dec, v)


@pytest.mark.parametrize("codec,kind", [
    (c, k) for c in ALL for k in ROUND_TRIP_MATRIX[c]])
def test_codec_roundtrip_randomized(codec, kind):
    for seed in range(3):
        rng = np.random.default_rng(0xA11CE + seed)
        _assert_same_pack(codec, _gen(kind, 4096 + 131 * seed, rng))


@pytest.mark.parametrize("codec", ALL)
def test_codec_roundtrip_edge_shapes(codec):
    """Single-value runs, one partial block, block-boundary lengths,
    zero tails, spikes (exception blocks), unsigned words past 2**15."""
    cases = [
        np.full(4096, 42, np.int64),
        np.arange(BLOCK, dtype=np.int32),
        np.arange(BLOCK + 7, dtype=np.int32),
        np.concatenate([np.sort(np.random.default_rng(0)
                                .integers(0, 2000, 5000)),
                        np.zeros(120, np.int64)]),
        np.concatenate([np.arange(4000, dtype=np.int64), [10**15],
                        np.arange(96, dtype=np.int64)]),
        np.repeat(np.arange(60000, 60040, dtype=np.uint16), 100),
        np.repeat(np.array([3, 2**32 - 5, 7], np.uint32), 700),
    ]
    for v in cases:
        _assert_same_pack(codec, v)


def test_chooser_rejects_high_entropy():
    rng = np.random.default_rng(7)
    v = rng.integers(-2**62, 2**62, 8192).astype(np.int64)
    assert WC.choose_and_encode(v, ALL, 1.3, BLOCK) is None
    v = np.array([np.iinfo(np.int64).min,
                  np.iinfo(np.int64).max] * 2048, np.int64)
    assert WC.choose_and_encode(v, ALL, 1.3, BLOCK) is None
    assert JWC.choose_and_encode(v, ALL, 1.3, BLOCK) is None


def test_chooser_skips_tiny_and_float_components():
    rng = np.random.default_rng(8)
    assert WC.choose_and_encode(np.zeros(64, np.int32), ("rle",), 1.1,
                                BLOCK) is None
    assert WC.choose_and_encode(rng.random(8192), ALL, 1.1, BLOCK) is None
    # the same pick and bytes as the JAX chooser on a compressible one
    v = np.sort(rng.integers(0, 900, 8192)).astype(np.int32)
    name, arrays, meta = WC.choose_and_encode(v, ALL, 1.3, BLOCK)
    jname, jarrays, jmeta = JWC.choose_and_encode(v, ALL, 1.3, BLOCK)
    assert (name, meta) == (jname, jmeta)
    assert [a.tobytes() for a in arrays] == [a.tobytes() for a in jarrays]
    st = WC.stats()[name]
    assert st["compress_calls"] == 1 and st["ratio"] > 1.3


def test_bytes_codecs_roundtrip_and_stats():
    arrays = {"a": np.arange(4096, dtype=np.int64),
              "b": np.zeros((64, 32), np.uint8)}
    for codec in ("none", "zlib"):
        back = serde.deserialize_arrays(serde.serialize_arrays(arrays,
                                                               codec))
        for k, v in arrays.items():
            assert np.array_equal(back[k], v), (codec, k)
    st = WC.stats()
    assert st["zlib"]["compress_calls"] == 1
    assert st["zlib"]["decompress_calls"] == 1
    assert st["zlib"]["wire_bytes"] < st["zlib"]["raw_bytes"]
    assert st["none"]["wire_bytes"] == st["none"]["raw_bytes"]
    with pytest.raises(ValueError, match="unknown codec"):
        serde.serialize_arrays(arrays, "lz77")
    with pytest.raises(ValueError, match="no byte-stream form"):
        serde.serialize_arrays(arrays, "bitpack")


@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_frames_read_across_packages(codec):
    """A frame either package writes is the other's byte for byte and
    reads in the other."""
    rng = np.random.default_rng(31)
    arrays = {"c0_data": rng.integers(-9, 9, 500).astype(np.int64),
              "c0_valid": rng.random(500) < 0.8,
              "c1_chars": rng.integers(0, 3, (500, 7)).astype(np.uint8),
              "f": rng.random(500),
              "__num_rows": np.asarray(500, np.int64)}
    mine = serde.serialize_arrays(arrays, codec)
    theirs = jserde.serialize_arrays(arrays, codec)
    assert mine == theirs
    if codec == "zlib":
        assert len(mine) < sum(a.nbytes for a in arrays.values())
    for back in (serde.deserialize_arrays(theirs),
                 jserde.deserialize_arrays(mine)):
        for k, a in arrays.items():
            a = np.ascontiguousarray(a)
            assert back[k].dtype == a.dtype and back[k].shape == a.shape
            assert np.array_equal(back[k], a), k


def _mixed_arrays(n=4096, seed=3):
    rng = np.random.default_rng(seed)
    t = pa.table({
        "d": pa.array(np.sort(rng.integers(8766, 10957, n)).astype(np.int32),
                      pa.date32()),
        "k": pa.array((rng.integers(0, 50, n) + 10**12).astype(np.int64)),
        "s": pa.array(rng.choice(["AAA", "BB", "C"], n)),
        "f": pa.array([None if rng.random() < 0.1 else float(x)
                       for x in rng.integers(0, 30, n)]),
        "o": pa.array(np.sort(rng.integers(0, 2**40, n)).astype(np.int64)),
    })
    return t


def _arrays(t):
    return [c.combine_chunks() for c in t.combine_chunks().columns]


def _port_enc(t, codecs):
    return TR.encode_for_device(_arrays(t), schema_from_arrow(t.schema),
                                t.num_rows, codecs)


def _jax_enc(t, on: bool):
    from spark_rapids_tpu.columnar.arrow import schema_from_arrow as js

    get_conf().set(WIRE_KEY, on)
    return JTR.encode_for_device(_arrays(t), js(t.schema), t.num_rows)


def test_disabled_is_bit_for_bit_uncompressed(monkeypatch):
    """Compression off: the plan and components the JAX encoder gives
    with its key off, and the chooser never consulted."""
    t = _mixed_arrays()
    jcomps, jplan = _jax_enc(t, False)

    def boom(*a, **k):
        raise AssertionError("compression off consulted the chooser")

    monkeypatch.setattr(WC.registry, "choose_and_encode", boom)
    monkeypatch.setattr(WC, "choose_and_encode", boom)
    conf = C.TorchConf({C.PACKED_UPLOAD: True})
    policy = TR.WirePolicy.from_conf(conf)
    assert policy == TR.WirePolicy(None)
    comps, plan = _port_enc(t, policy.codecs)
    assert plan == jplan and TR.plan_codecs(plan) == ()
    assert [a.tobytes() for a in comps] == [a.tobytes() for a in jcomps]


def test_enabled_roundtrip_identical_columns(monkeypatch):
    """Compression on: the JAX encoder's compressed plan and bytes, the
    decoded columns bit for bit the uncompressed ones, fewer bytes; the
    constants ``WIRE_MIN_RATIO`` and ``WIRE_BLOCK_ROWS`` steer it."""
    t = _mixed_arrays()
    cfg = WC.wire_codec_config(C.TorchConf({C.WIRE_COMPRESSION: True}))
    assert cfg == (ALL, 1.3, 256)
    comps_on, plan_on = _port_enc(t, cfg)
    jcomps, jplan = _jax_enc(t, True)
    assert plan_on == jplan and TR.plan_codecs(plan_on)
    assert [a.tobytes() for a in comps_on] == [a.tobytes() for a in jcomps]
    comps_off, _ = _port_enc(t, None)
    assert sum(a.nbytes for a in comps_on) < sum(a.nbytes for a in comps_off)
    off = to_arrow(from_arrow(t, CPU, wire=TR.WirePolicy()))
    WC.reset_stats()
    on = to_arrow(from_arrow(t, CPU, wire=TR.WirePolicy(cfg)))
    assert on.equals(off) and on.equals(
        to_arrow(from_arrow(t, CPU)))
    st = WC.stats()
    assert sum(e["compress_calls"] for e in st.values()) \
        == sum(e["decompress_calls"] for e in st.values()) > 0
    monkeypatch.setattr(WC.registry, "WIRE_BLOCK_ROWS", 64)
    monkeypatch.setattr(WC.registry, "WIRE_MIN_RATIO", 1e9)
    assert WC.wire_codec_config(C.TorchConf({C.WIRE_COMPRESSION: True})) \
        == (ALL, 1e9, 64)
    assert TR.plan_codecs(_port_enc(t, (ALL, 1e9, 64))[1]) == ()


# --------------------------------------------------------------------- #
# Queries on the three upload paths
# --------------------------------------------------------------------- #


def _q3_fixture(d: str):
    rng = np.random.default_rng(0xACCE)
    n = 1 << 15
    li = pa.table({
        "l_orderkey": np.sort(rng.integers(0, 2048, n)).astype(np.int64),
        "l_shipdate": np.sort(rng.integers(8766, 10957, n)).astype(np.int32),
        "l_quantity": rng.integers(1, 51, n).astype(np.int64),
    })
    li_path = os.path.join(d, "li.parquet")
    pq.write_table(li, li_path, row_group_size=n)
    orders = pa.table({
        "o_orderkey": np.arange(2048, dtype=np.int64),
        "o_priority": rng.integers(0, 5, 2048).astype(np.int32),
    })
    o_path = os.path.join(d, "orders.parquet")
    pq.write_table(orders, o_path)
    return li_path, o_path


def _q3_query(session, li_path, o_path):
    lidf = session.read_parquet(li_path).where(col("l_shipdate") > lit(9000))
    odf = session.read_parquet(o_path)
    return (lidf.join(odf, left_on=[col("l_orderkey")],
                      right_on=[col("o_orderkey")])
            .group_by(col("o_priority"))
            .agg((sum_(col("l_quantity")), "qty"), (count_star(), "cnt"))
            .order_by(col("o_priority")))


def _wire_bytes(session, make) -> int:
    TR.reset_upload_stats()
    make(session).collect()
    return TR.upload_stats()["wire_bytes"]


def test_acceptance_q3_upload_bytes_halved(tmp_path):
    """A q3-shaped scan -> join uploads at least 2x fewer bytes with
    compression on (the JAX acceptance criterion), the same rows, and a
    ``WireDecode`` program in the device ledger."""
    li, o = _q3_fixture(str(tmp_path))
    make = lambda s: _q3_query(s, li, o)  # noqa: E731
    sessions = {k: TorchSession(v, device="cpu") for k, v in PATHS.items()}
    results = {k: make(s).collect() for k, s in sessions.items()}
    assert results["compressed"].equals(results["plain"])
    assert results["wire"].equals(results["plain"])
    on = _wire_bytes(sessions["compressed"], make)
    off = _wire_bytes(sessions["wire"], make)
    assert off >= 2 * on, (off, on)
    PL.reset_stats()
    PL.enable()
    try:
        make(sessions["compressed"]).collect()
        assert PL.LEDGER.flush(timeout=30.0)
        decodes = [p for p in PL.snapshot().values()
                   if p.get("op") == "WireDecode"]
    finally:
        PL.disable()
        PL.reset_stats()
    assert decodes and all(p["dispatches"] > 0 for p in decodes), decodes
    assert any(e["decompress_calls"] for e in WC.stats().values())


def test_chaos_upload_fault_recompresses_correctly(tmp_path):
    """An injected ``transfer.upload`` failure re-issues the copy from
    the staged buffer: the same rows, no re-encode, nothing plain."""
    li, o = _q3_fixture(str(tmp_path))
    s = TorchSession(PATHS["compressed"], device="cpu")
    clean = _q3_query(s, li, o).collect()
    TR.reset_upload_stats()
    faults.install("transfer.upload:nth=2", forced=True)
    try:
        WC.reset_stats()
        faulted = _q3_query(s, li, o).collect()
        assert faults.fault_stats()["transfer.upload"]["injected"] == 1
        assert faults.fault_stats()["transfer.upload"]["recovered"] == 1
    finally:
        faults.disarm()
    st = TR.upload_stats()
    assert st["plain_batches"] == 0 and st["batches"] == st["copies"] > 0
    compressed = sum(e["compress_calls"] for e in WC.stats().values())
    assert compressed == sum(e["decompress_calls"]
                             for e in WC.stats().values())
    assert clean.equals(faulted)


def test_chaos_batch_split_with_compression(tmp_path):
    """``exec.batch`` faults deep enough to bisect a batch: the decoded
    batch splits, the rows stay the same."""
    li, o = _q3_fixture(str(tmp_path))
    keys = {**PATHS["compressed"], **C.SERIAL, C.RETRY_BACKOFF_S: 0.0,
            C.SPLIT_MIN_ROWS: 16}
    s = TorchSession(keys, device="cpu")
    clean = _q3_query(s, li, o).collect()
    R.reset_retry_stats()
    faults.install("exec.batch:nth=2,times=2", forced=True)
    try:
        faulted = _q3_query(s, li, o).collect()
        assert faults.fault_stats()["exec.batch"]["recovered"] >= 1
        st = R.retry_stats()
        assert st["splits"] + st["spill_retries"] >= 1, st
    finally:
        faults.disarm()
        R.reset_retry_stats()
    assert clean.equals(faulted)


def test_wire_spans_and_stats_through_a_traced_query(tmp_path):
    li, o = _q3_fixture(str(tmp_path))
    s = TorchSession(PATHS["compressed"], device="cpu")
    PT.enable()
    PT.clear()
    try:
        _q3_query(s, li, o).collect()
        names = {e.name for e in PT.snapshot()}
    finally:
        PT.disable()
        PT.clear()
    assert {"wire.compress", "wire.decompress"} <= names
    plan = _q3_query(s, li, o).physical_plan()
    collect_exec(plan, s.conf)
    scans = [n for n in plan.walk() if not n.children]
    assert all(n.metrics["encodedBatches"] > 0 for n in scans)
    assert all(n.metrics["plainBatches"] == 0 for n in scans)
    assert all(n.metrics["wireBytes"] > 0 for n in scans)


def test_spill_host_tier_compression():
    """compressHostTier: a device -> host spill holds one frame (fewer
    host bytes, counted as such), a restore is exact, and a host ->
    disk spill writes the frame as it is."""
    rng = np.random.default_rng(5)
    t = pa.table({"k": np.repeat(rng.integers(0, 4, 64), 64),
                  "v": np.arange(4096, dtype=np.int64),
                  "s": pa.array([f"r{i % 9}" for i in range(4096)])})
    batch = from_arrow(t, CPU)
    store = BufferStore(device_budget=1 << 30, host_budget=1 << 30,
                        codec="zlib", compress_host=True)
    try:
        h = store.register(batch)
        assert store._spill_one_device_locked()
        e = store._entries[h.buffer_id]
        assert isinstance(e.host, _HostFrame)
        st = store.spill_stats()
        assert st["host_used"] == len(e.host.frame)
        assert st["host_used"] < st["host_raw_bytes"] \
            == store._entries[h.buffer_id].host_raw
        frame = e.host.frame
        assert store._spill_one_host_locked()
        assert e.tier == StorageTier.DISK
        with open(e.path, "rb") as f:
            on_disk = f.read()
        assert on_disk == frame and on_disk[:4] == b"TPUB"
        assert b'"codec": "zlib"' in on_disk
        st = store.spill_stats()
        assert (st["host_used"], st["host_raw_bytes"]) == (0, 0)
        assert st["disk_used"] == len(frame)
        restored = h.get()
        assert to_arrow(restored).equals(t)
        h.unpin()
        h.close()
        assert store.spill_stats()["disk_used"] == 0
    finally:
        store.close()


def test_spill_codec_key_reaches_the_disk_tier():
    """``memory.spill.compression.codec=zlib`` through the plugin's
    store: the disk frame is a JAX-readable zlib frame."""
    from torch_plugin import sized_plugin

    rng = np.random.default_rng(6)
    t = pa.table({"v": np.repeat(rng.integers(0, 9, 32), 128)})
    with sized_plugin({C.SPILL_CODEC: "zlib", C.HBM_BUDGET_BYTES: 1,
                       C.HOST_SPILL_BYTES: 1}) as plugin:
        store = plugin.store
        h = store.register(from_arrow(t, CPU))
        store.spill_all_unpinned()
        e = store._entries[h.buffer_id]
        assert e.tier == StorageTier.DISK
        with open(e.path, "rb") as f:
            frame = f.read()
        back = jserde.deserialize_arrays(frame)
        assert np.array_equal(back["c0_data"], t["v"].to_numpy())
        assert to_arrow(h.get()).equals(t)
        h.unpin()
        h.close()


def test_registry_matrix_covers_every_codec():
    names = [n for n, _c in WC.registry_items()]
    assert names == [n for n, _c in JWC.registry_items()]
    for name, codec in WC.registry_items():
        assert name in ROUND_TRIP_MATRIX, name
        assert codec.decoder_program_key \
            == JWC.get_codec(name).decoder_program_key


# --------------------------------------------------------------------- #
# q6, q1 and q3ds through TorchSession on the three paths
# --------------------------------------------------------------------- #


def _jax_q3ds(session, dd, ss_paths, item):
    dt = (session.read_parquet(dd).where(jcol("d_moy").eq(jlit(11)))
          .select(jcol("d_date_sk"), jcol("d_year")))
    ss = session.read_parquet(*ss_paths)
    it = (session.read_parquet(item)
          .where(jcol("i_manufact_id").eq(jlit(128)))
          .select(jcol("i_item_sk"), jcol("i_brand_id"), jcol("i_brand")))
    return (dt.join(ss, left_on=[jcol("d_date_sk")],
                    right_on=[jcol("ss_sold_date_sk")])
            .join(it, left_on=[jcol("ss_item_sk")],
                  right_on=[jcol("i_item_sk")])
            .group_by(jcol("d_year"), jcol("i_brand_id"), jcol("i_brand"))
            .agg((jsum(jcol("ss_ext_sales_price")), "sum_agg"))
            .order_by(JSortKey(jcol("d_year")),
                      JSortKey(jcol("sum_agg"), True, True),
                      JSortKey(jcol("i_brand_id")))
            .limit(100))


@pytest.fixture(scope="module")
def query_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("wire_queries")
    li = tpch.make_lineitem(str(d), n_files=2, with_q1_cols=True,
                            rows_per_file=4096)
    cat = tpcds_schema.generate(0.5, seed=7)
    dd, item = str(d / "date_dim.parquet"), str(d / "item.parquet")
    pq.write_table(cat["date_dim"], dd)
    pq.write_table(cat["item"], item)
    ss = cat["store_sales"]
    per = -(-ss.num_rows // 2)
    ssp = []
    for i in range(2):
        p = str(d / f"store_sales-{i}.parquet")
        pq.write_table(ss.slice(i * per, per), p)
        ssp.append(p)
    return {"q6": (li,), "q1": (li,), "q3ds": (dd, ssp, item)}


PORT_QUERIES = {"q6": tpch.q6_dataframe, "q1": tpch.q1_dataframe,
                "q3ds": tpcds.q3_dataframe}
JAX_QUERIES = {"q6": bench.q6_dataframe, "q1": bench.q1_dataframe,
               "q3ds": _jax_q3ds}


@pytest.fixture(scope="module")
def jax_results(query_data):
    conf = get_conf()
    saved = dict(conf._values)
    try:
        conf.set(TTB, 1)
        set_conf(conf)
        return {q: JAX_QUERIES[q](TpuSession(conf), *query_data[q])
                .collect(engine="tpu") for q in JAX_QUERIES}
    finally:
        conf._values.clear()
        conf._values.update(saved)
        set_conf(conf)


def _significant(table: pa.Table, digits: int = 12) -> pa.Table:
    """Float columns to 12 significant digits: the engines sum in other
    orders (``tests/test_torch_q1.py``'s rule)."""
    cols = []
    for c in table.columns:
        if pa.types.is_floating(c.type):
            c = pa.array([None if v is None else float(f"{v:.{digits - 1}e}")
                          for v in c.to_pylist()], c.type)
        cols.append(c)
    return pa.Table.from_arrays(cols, names=table.schema.names)


@pytest.mark.parametrize("query", sorted(PORT_QUERIES))
@pytest.mark.parametrize("path", sorted(PATHS))
def test_queries_on_each_upload_path_match_jax(query, path, query_data,
                                               jax_results):
    """Each path's rows equal the JAX engine's (floats to 12 significant
    digits) and the plain path's bit for bit; every batch is counted
    under its path."""
    plain = PORT_QUERIES[query](TorchSession({TTB: 1}, device="cpu"),
                                *query_data[query]).collect()
    s = TorchSession({TTB: 1, **PATHS[path]}, device="cpu")
    TR.reset_upload_stats()
    got = PORT_QUERIES[query](s, *query_data[query]).collect()
    assert got.equals(plain)
    assert_tables_equal(_significant(got), _significant(jax_results[query]),
                        ignore_order=query == "q1", approx_float=True)
    st = TR.upload_stats()
    if path == "plain":
        assert st["batches"] == 0 and st["plain_batches"] > 0
    else:
        assert st["plain_batches"] == 0
        assert st["batches"] == st["copies"] > 0
