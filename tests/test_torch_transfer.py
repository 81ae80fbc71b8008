"""The port's wire path (``spark_rapids_tpu_torch/columnar/transfer.py``)
against the JAX package's (``spark_rapids_tpu/columnar/transfer.py``).

Counterparts of ``tests/test_transfer.py``.  Each table goes through
both encoders: at a row count the JAX encoder does not pad (a power of
two of at least 1024, or a small ``n`` of its own bucket) the plan and
every component are equal byte for byte, and the port's decode equals
the JAX decode's live rows and the port's plain upload, floats compared
as their bits.  The upload runs on the CPU here (its one copy is a
plain ``.to``), so these tests cover the encode, the staging buffer,
the views and the decode.
"""

import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.columnar import transfer as JTR
from spark_rapids_tpu.columnar.arrow import (
    schema_from_arrow as jschema_from_arrow,
)
from spark_rapids_tpu.config import get_conf
from spark_rapids_tpu.exprs.base import lit as jlit
from spark_rapids_tpu.session import TpuSession, col as jcol

from spark_rapids_tpu_torch import TorchSession, col, lit
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar import transfer as TR
from spark_rapids_tpu_torch.columnar.arrow import (
    from_arrow,
    schema_from_arrow,
    to_arrow,
)
from spark_rapids_tpu_torch.columnar.column import StringColumn
from torch_quiet import quiet_ladder  # noqa: F401

CPU = torch.device("cpu")
WIRE = TR.WirePolicy()
PACKED = {C.PACKED_UPLOAD: True}


def arrays_of(t: pa.Table) -> list:
    return [c.combine_chunks() for c in t.combine_chunks().columns]


def port_encode(t: pa.Table, use_native: bool = True):
    return TR.encode_for_device(arrays_of(t), schema_from_arrow(t.schema),
                                t.num_rows, use_native=use_native)


def jax_encode(t: pa.Table):
    return JTR.encode_for_device(arrays_of(t), jschema_from_arrow(t.schema),
                                 t.num_rows)


def assert_same_wire(t: pa.Table) -> tuple:
    """Both encoders' plans and components equal byte for byte (the
    JAX encoder must not pad ``t``); the port's (components, plan)."""
    comps, plan = port_encode(t)
    jcomps, jplan = jax_encode(t)
    assert jplan[:2] == (t.num_rows, t.num_rows), "the JAX wire is padded"
    assert plan == jplan
    assert len(comps) == len(jcomps)
    for a, b in zip(comps, jcomps):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        assert a.tobytes() == b.tobytes()
    return comps, plan


def bits(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind == "f":
        return a.view(np.int64 if a.itemsize == 8 else np.int32)
    return a


def assert_decodes_alike(t: pa.Table) -> None:
    """The port's wire decode = the JAX decode's live rows = the port's
    plain upload, column by column, floats by their bits."""
    n = t.num_rows
    wire = from_arrow(t, CPU, wire=WIRE)
    plain = from_arrow(t, CPU)
    jcomps, jplan = jax_encode(t)
    jcols = JTR.decode_on_device(jcomps, jplan,
                                 jschema_from_arrow(t.schema))
    for f, w, p, j in zip(t.schema, wire.columns, plain.columns, jcols):
        jvalid = np.asarray(j.validity)[:n]
        assert np.array_equal(w.validity.numpy(), jvalid), f.name
        assert np.array_equal(p.validity.numpy(), jvalid), f.name
        if isinstance(w, StringColumn):
            lens = w.lengths.numpy()
            assert np.array_equal(lens, np.asarray(j.lengths)[:n]), f.name
            assert np.array_equal(lens, p.lengths.numpy()), f.name
            jchars = np.asarray(j.chars)[:n]
            assert np.array_equal(w.chars.numpy(), jchars), f.name
            width = p.width
            assert np.array_equal(w.chars.numpy()[:, :width],
                                  p.chars.numpy()), f.name
            assert not w.chars.numpy()[:, width:].any(), f.name
            continue
        got = bits(w.data.numpy())
        # a NULL slot holds 0 in the port (the JAX dictionary decode
        # leaves its first entry there)
        assert np.array_equal(got[jvalid],
                              bits(np.asarray(j.data)[:n])[jvalid]), f.name
        assert np.array_equal(got, bits(p.data.numpy())), f.name


def roundtrip(t: pa.Table) -> pa.Table:
    return to_arrow(from_arrow(t, CPU, wire=WIRE))


def assert_tables_equal(got: pa.Table, want: pa.Table):
    assert got.schema == want.schema
    for cg, cw, f in zip(got.columns, want.columns, want.schema):
        assert cg.to_pylist() == cw.to_pylist(), f.name


def _mixed_table(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({
        "small_i64": pa.array(rng.integers(100, 140, n), pa.int64()),
        "mid_i32": pa.array(rng.integers(8766, 10957, n).astype(np.int32)),
        "wide_i64": pa.array(rng.integers(-2**62, 2**62, n), pa.int64()),
        "lowcard_f64": pa.array(rng.integers(0, 11, n) / 100.0),
        "rand_f64": pa.array(rng.random(n)),
        "flag": pa.array(rng.integers(0, 2, n).astype(bool)),
        "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8)),
        "i16": pa.array(rng.integers(-2**15, 2**15, n).astype(np.int16)),
        "f32": pa.array(rng.random(n).astype(np.float32)),
        "day": pa.array(rng.integers(8000, 12000, n).astype(np.int32),
                        pa.date32()),
        "ts": pa.array(1_600_000_000_000_000
                       + rng.integers(0, 10**12, n),
                       pa.timestamp("us", tz="UTC")),
    })


def test_encoded_roundtrip_mixed():
    t = _mixed_table()
    assert_same_wire(t)
    assert_decodes_alike(t)
    assert_tables_equal(roundtrip(t), t)


def test_encoded_roundtrip_with_nulls():
    rng = np.random.default_rng(1)
    n = 2048
    vals = rng.integers(0, 50, n)
    mask = rng.random(n) < 0.3
    t = pa.table({
        "a": pa.array([None if m else int(v)
                       for v, m in zip(vals, mask)], pa.int64()),
        "b": pa.array([None if m else float(v) / 7
                       for v, m in zip(vals, ~mask)], pa.float64()),
        "c": pa.array([None if m else float(v) / 4
                       for v, m in zip(vals, mask)], pa.float64()),
        "none": pa.nulls(n, pa.int32()),
        "d": pa.array([None if m else int(v) for v, m in zip(vals, mask)],
                      pa.date32()),
    })
    comps, plan = assert_same_wire(t)
    assert [e[1] for e in plan[3]] == ["bias", "dict", "dict", "null",
                                       "bias"]
    assert_decodes_alike(t)
    assert_tables_equal(roundtrip(t), t)


def test_encoded_strings_raw_and_dict():
    n = 4096
    rng = np.random.default_rng(2)
    cats = ["SHIP", "RAIL", "TRUCK", "AIR", None]
    dict_col = [cats[i] for i in rng.integers(0, 5, n)]
    raw_col = [f"row-{i}-{rng.integers(0, 1 << 30)}" for i in range(n)]
    nul = ["a\x00b", "\x00", "", None]
    t = pa.table({"mode": pa.array(dict_col, pa.string()),
                  "uid": pa.array(raw_col, pa.string()),
                  "nul": pa.array([nul[i] for i in rng.integers(0, 4, n)])})
    comps, plan = assert_same_wire(t)
    assert [e[0] for e in plan[3]] == ["sdict", "sraw", "sdict"]
    assert_decodes_alike(t)
    assert_tables_equal(roundtrip(t), t)
    wire = from_arrow(t, CPU, wire=WIRE)
    # NULL rows of a string dictionary carry zeroed chars and a sidecar
    mode = wire.columns[0]
    valid = mode.validity.numpy()
    assert not mode.chars.numpy()[~valid].any()
    assert mode.codes is not None and mode.codes.dtype == torch.int32
    assert not mode.codes.numpy()[~valid].any()


def test_dictionary_arrays_straight_from_parquet():
    """A DictionaryArray (the Parquet scan's string columns, the
    native decoder's codes) takes ``_encode_dict_direct``: NUL bytes
    inside values kept, a NULL inside the dictionary to the plain
    form."""
    rng = np.random.default_rng(12)
    n = 1024
    codes = rng.integers(0, 4, n).astype(np.int32)
    null = rng.random(n) < 0.2
    words = pa.array(["", "x\x00y", "\x00\x00", "longer value"])
    t = pa.table({
        "s": pa.DictionaryArray.from_arrays(
            pa.array(codes, mask=null), words),
        "f": pa.DictionaryArray.from_arrays(
            pa.array(codes), pa.array([1.5, -0.0, 2.25, 1e300])),
        "i": pa.DictionaryArray.from_arrays(
            pa.array(codes, mask=null), pa.array([7, -7, 9, 2**40])),
        "held": pa.DictionaryArray.from_arrays(
            pa.array(codes), pa.array([1, None, 3, 4], pa.int64())),
    })
    comps, plan = assert_same_wire(t)
    assert [e[0] if e[0] != "fixed" else e[1] for e in plan[3]] == [
        "sdict", "dict", "dict", "bias"]
    assert_decodes_alike(t)
    got = roundtrip(t)
    for name in t.column_names:
        assert got[name].to_pylist() == \
            t[name].cast(t[name].type.value_type).to_pylist(), name


def test_encode_plan_kinds():
    t = _mixed_table()
    comps, plan = port_encode(t)
    kinds = [e[1] for e in plan[3] if e[0] == "fixed"]
    assert kinds.count("bias") >= 2
    assert "dict" in kinds
    assert "raw" in kinds
    total = sum(a.nbytes for a in comps)
    assert total < 0.7 * t.nbytes


def test_wire_bytes_shrink_vs_raw():
    """A q6-shaped batch ships a small fraction of its raw bytes: the
    quantity and discount as uint8 codes, the price as int32 cents,
    the ship date as a uint16 bias; through the upload, one copy."""
    rng = np.random.default_rng(3)
    n = 1 << 17
    t = pa.table({
        "l_quantity": rng.integers(1, 51, n).astype(np.float64),
        "l_extendedprice": np.round(rng.uniform(900, 105000, n), 2),
        "l_discount": rng.integers(0, 11, n) / 100.0,
        "l_shipdate": rng.integers(8766, 10957, n).astype(np.int32),
    })
    comps, plan = assert_same_wire(t)
    assert [e[1] for e in plan[3]] == ["dict", "scaled", "dict", "bias"]
    total = sum(a.nbytes for a in comps)
    assert total < 0.35 * t.nbytes
    TR.reset_upload_stats()
    got = from_arrow(t, CPU, wire=WIRE)
    st = TR.upload_stats()
    assert (st["batches"], st["copies"], st["plain_batches"]) == (1, 1, 0)
    assert st["wire_bytes"] < 0.35 * t.nbytes
    assert to_arrow(got).equals(t)


def test_scaled_decimal_floats():
    """Two-decimal doubles ship as int32 cents and come back bit for bit,
    those near x.xx5 and the negative ones too; NaN and wide values
    refuse the form."""
    rng = np.random.default_rng(4)
    n = 16384
    prices = np.round(rng.uniform(900, 105000, n), 2)
    # values whose cents are odd multiples of 0.005 away from a
    # rounding edge: only a true division by 100.0 rebuilds them
    edge = np.round(rng.integers(-10**6, 10**6, n) / 100.0, 2)
    t = pa.table({"price": prices, "edge": edge,
                  "wild": rng.random(n) * 1e18,
                  "withnan": np.where(rng.random(n) < 0.01, np.nan,
                                      np.round(rng.random(n), 2))})
    comps, plan = assert_same_wire(t)
    entries = {f.name: e[1] for f, e in zip(t.schema, plan[3])}
    assert entries == {"price": "scaled", "edge": "scaled", "wild": "raw",
                       "withnan": "raw"}
    assert_decodes_alike(t)
    got = roundtrip(t)
    for name, want in (("price", prices), ("edge", edge)):
        assert np.array_equal(np.asarray(got.column(name)).view(np.int64),
                              want.view(np.int64)), name
    # the reciprocal multiply the decode must never do differs on them
    cents = np.rint(edge * 100).astype(np.int32)
    assert (cents.astype(np.float64) * 0.01 != edge).any()


def test_host_prefilter_differential(tmp_path):
    """The scan's host prefilter and pushdown run before the encode:
    with packedUpload on, prefilter on and off give the JAX engine's
    rows, and only the kept rows cross the wire."""
    rng = np.random.default_rng(8)
    n = 30000
    vals = rng.integers(0, 100, n).astype(np.float64)
    nulls = rng.random(n) < 0.1
    t = pa.table({
        "x": pa.array([None if m else float(v)
                       for v, m in zip(vals, nulls)], pa.float64()),
        "y": rng.random(n),
    })
    p = str(tmp_path / "pf.parquet")
    pq.write_table(t, p)
    want = (TpuSession(get_conf()).read_parquet(p)
            .where(jcol("x") < jlit(10.0)).collect(engine="cpu"))
    for pre in (True, False):
        s = TorchSession({**PACKED, C.HOST_PREFILTER: pre}, device="cpu")
        df = s.read_parquet(p).where(col("x") < lit(10.0))
        plan = df.physical_plan()
        from spark_rapids_tpu_torch.plan.planner import collect_exec

        got = collect_exec(plan, s.conf)
        assert sorted(map(str, got.to_pylist())) \
            == sorted(map(str, want.to_pylist()))
        scan = next(x for x in plan.walk() if not x.children)
        assert scan.metrics["encodedBatches"] > 0
        assert scan.metrics["plainBatches"] == 0
        if pre:
            assert scan.metrics["numOutputRows"] == want.num_rows


def test_host_prefilter_spark_nan_semantics(tmp_path):
    rng = np.random.default_rng(9)
    n = 20000
    x = rng.random(n) * 10
    x[rng.random(n) < 0.05] = np.nan
    t = pa.table({"x": x, "y": rng.random(n)})
    p = str(tmp_path / "nanpf.parquet")
    pq.write_table(t, p)
    js = TpuSession(get_conf())
    s = TorchSession(PACKED, device="cpu")
    for cond, jcond in ((col("x") > lit(5.0), jcol("x") > jlit(5.0)),
                        (col("x") <= lit(5.0), jcol("x") <= jlit(5.0)),
                        (col("x") >= col("x"), jcol("x") >= jcol("x"))):
        got = s.read_parquet(p).where(cond).collect()
        want = js.read_parquet(p).where(jcond).collect(engine="cpu")
        assert got.num_rows == want.num_rows, str(cond)
        assert sorted(map(str, got.to_pylist())) \
            == sorted(map(str, want.to_pylist()))


def test_legacy_fallback_for_decimal_and_list():
    """A schema with a type the encoder does not take uploads plain,
    chosen before any copy, in both packages."""
    t = pa.table({
        "d": pa.array([decimal.Decimal("1.23"), None], pa.decimal128(9, 2)),
        "l": pa.array([[1, 2], None], pa.list_(pa.int64())),
    })
    assert port_encode(t) is None
    assert jax_encode(t) is None
    assert port_encode(t.select(["d"])) is None
    TR.reset_upload_stats()
    assert_tables_equal(roundtrip(t), t)
    st = TR.upload_stats()
    assert (st["batches"], st["plain_batches"]) == (0, 1)


def test_long_string_lengths_survive():
    """Strings of 64 KiB or more must not wrap the uint16 length."""
    t = pa.table({"s": pa.array(["A" * 70000, "short", None])})
    comps, plan = port_encode(t)
    jcomps, jplan = jax_encode(t)
    assert plan[3] == jplan[3]
    assert_decodes_alike(t)
    assert roundtrip(t).column("s").to_pylist() == ["A" * 70000, "short",
                                                    None]


def test_negative_zero_floats_survive():
    """-0.0 keeps its sign bit: the dictionary is refused and the raw
    or cents form carries it; NaN payloads ride raw."""
    vals = np.array([0.0, -0.0, 1.5, -0.0, 0.0, 1.5] * 100)
    nan_bits = np.array([0x7FF8000000000001, 0x7FF0000000000ABC,
                         0xFFF8000000000000] * 200, np.uint64)
    t = pa.table({"z": vals, "nan": nan_bits.view(np.float64)})
    got = roundtrip(t)
    assert np.array_equal(np.asarray(got.column("z")).view(np.int64),
                          vals.view(np.int64))
    assert np.array_equal(np.asarray(got.column("nan")).view(np.uint64),
                          nan_bits)
    assert_decodes_alike(t)
    # a dictionary holds 0.0 and -0.0 apart only where the bit check
    # passes; NaN payloads never take one
    plan, jplan = port_encode(t)[1], jax_encode(t)[1]
    assert plan[3] == jplan[3] and plan[3][1][1] == "raw"


@pytest.mark.parametrize("n", [0, 1])
def test_empty_and_single_row(n):
    t = pa.table({"x": pa.array([42] * n, pa.int64()),
                  "s": pa.array(["hi"] * n, pa.string())})
    if n == 0:
        assert port_encode(t) is None and jax_encode(t) is None
        assert roundtrip(t).num_rows == 0
        return
    comps, plan = port_encode(t)
    assert plan[:2] == (1, 1)
    assert_decodes_alike(t)
    assert_tables_equal(roundtrip(t), t)


def test_bias32_wire_for_wide_range_i64():
    """int64 with a 32-bit (not 16-bit) range ships as a u32 bias, half
    the raw bytes, and round-trips bit for bit, a base near INT64_MIN
    too."""
    rng = np.random.default_rng(11)
    n = 4096
    lo = np.iinfo(np.int64).min
    t = pa.table({
        "orderkey": pa.array(
            7_000_000_000 + rng.integers(0, 1 << 31, n), pa.int64()),
        "deep_neg": pa.array(
            lo + rng.integers(0, (1 << 32) - 1, n).astype(np.uint64)
            .astype(np.int64), pa.int64()),
    })
    comps, plan = assert_same_wire(t)
    for e in plan[3]:
        assert e[1] == "bias" and comps[e[2][1]].dtype == np.uint32
    assert_decodes_alike(t)
    assert_tables_equal(roundtrip(t), t)


# --------------------------------------------------------------------- #
# The host codec's passes against their numpy forms
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_int_range_native_equals_numpy(dtype):
    rng = np.random.default_rng(21)
    info = np.iinfo(dtype)
    for lo, span in ((0, 200), (-40000, 60000), (info.min, 255),
                     (info.max - 65535, 65535)):
        v = (lo + rng.integers(0, span + 1, 5000)).astype(dtype)
        mn, rng_, e8, e16 = TR.int_range(v, use_native=True)
        nmn, nrng, n8, n16 = TR.int_range(v, use_native=False)
        assert (mn, rng_) == (nmn, nrng) == (int(v.min()),
                                             int(v.max()) - int(v.min()))
        for a, b in ((e8(v, mn), n8(v, mn)), (e16(v, mn), n16(v, mn))):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_scaled_encode_native_equals_numpy():
    rng = np.random.default_rng(22)
    cases = [np.round(rng.uniform(-1e6, 1e6, 4000), 2),
             np.round(rng.uniform(0, 1, 4000), 3),
             np.array([0.0, -0.0, 0.01]),
             # -21474836.48 (INT32_MIN cents): the C++ takes it, the
             # numpy form refuses it, in the JAX package alike
             np.array([21474836.47, -21474836.47]),
             np.array([21474836.48]),
             np.array([np.inf, 1.0]), np.array([np.nan]),
             rng.random(100)]
    for v in cases:
        a = TR.scaled_encode(v, use_native=True)
        b = TR.scaled_encode(v, use_native=False)
        assert (a is None) == (b is None), v[:3]
        if a is not None:
            assert np.array_equal(a, b)


def test_chars_matrix_native_equals_numpy():
    rng = np.random.default_rng(23)
    words = ["", "a", "x\x00y", "é" * 9, "z" * 33] + \
        [f"w{i}" * int(rng.integers(0, 6)) for i in range(200)]
    arr = pa.array([words[i] for i in rng.integers(0, len(words), 3000)]
                   + [None], pa.large_string())
    for a in (arr, arr.slice(17, 900)):
        c1, l1 = TR.chars_matrix(a, use_native=True)
        c2, l2 = TR.chars_matrix(a, use_native=False)
        assert c1.shape == c2.shape and np.array_equal(c1, c2)
        assert np.array_equal(l1, l2)


def test_encoder_native_equals_numpy_encoder():
    t = pa.concat_tables([_mixed_table(2048), _mixed_table(2048, seed=5)])
    a, pa_ = port_encode(t, use_native=True)
    b, pb = port_encode(t, use_native=False)
    assert pa_ == pb
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))
