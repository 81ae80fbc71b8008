"""The scalar types in the port against the JAX package: the type
mapping, the Arrow upload and download, the Parquet scan's layouts, the
spill tiers, the datetime rebase policy and K1's plain version.

- Type mapping: ``from_arrow_type`` / ``to_arrow_type`` and the physical
  dtypes equal the JAX functions' for every scalar type (int8 stays
  int8, int16 int16, float32 float32; TIMESTAMP and DECIMAL int64).
- Arrow: decimal128 at precision 1, 9, 10 and 18 (negatives and
  +/-(10^p - 1)) uploads to the unscaled int64 the JAX ``from_arrow``
  makes, read as a strided int64 view, and downloads to the same
  Decimals; read back from Parquet in the INT32, INT64 and
  FIXED_LEN_BYTE_ARRAY layouts, through the scan, with the native
  decoder off and on.  Timestamps of every Arrow unit, with and without
  a zone, upload as microseconds (ns floored, as Spark converts an
  instant); the JAX ``from_arrow`` casts the raw count, which is
  microseconds only for a microsecond column (ROADMAP.md §3).  float32
  -0.0 and NaN payloads and the int8 / int16 extremes keep their bits.
- Spill: a batch of every type goes DEVICE -> HOST -> DISK and back
  equal, its DECIMAL keeping (p, s).
- Rebase: ``io/rebase.py::check_rebase`` raises exactly where the JAX
  function raises, over files with and without Spark's legacy-calendar
  metadata, both modes; the scan applies it.
- K1's plain version over TINYINT, SMALLINT, FLOAT (-0.0, NaN payloads,
  +/-inf), TIMESTAMP (before 1970) and DECIMAL (negatives) equals the
  JAX ``hash_columns`` and ``partition_ids`` bit for bit.
All comparisons are exact.
"""

import datetime as dt
import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.arrow import from_arrow as jfrom_arrow
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.exprs import hashing as JH
from spark_rapids_tpu.io import rebase as jrebase

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import from_arrow, to_arrow
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.exprs import hashing as H
from spark_rapids_tpu_torch.io import rebase
from spark_rapids_tpu_torch.memory.store import BufferStore, StorageTier

CPU = torch.device("cpu")
D = decimal.Decimal
DECIMALS = [(1, 0), (9, 2), (10, 3), (18, 4), (18, 0), (7, 7)]


def _jax_type(dt_):
    if isinstance(dt_, T.DecimalType):
        return JT.DecimalType(dt_.precision, dt_.scale)
    return getattr(JT, next(k for k in ("BOOLEAN", "BYTE", "SHORT", "INT",
                                        "LONG", "FLOAT", "DOUBLE", "STRING",
                                        "DATE", "TIMESTAMP", "NULL")
                            if getattr(T, k) == dt_))


SCALARS = [T.BOOLEAN, T.BYTE, T.SHORT, T.INT, T.LONG, T.FLOAT, T.DOUBLE,
           T.STRING, T.DATE, T.TIMESTAMP] + [T.DecimalType(p, s)
                                              for p, s in DECIMALS]


@pytest.mark.parametrize("dtype", SCALARS, ids=str)
def test_type_mapping_equals_jax(dtype):
    jt = _jax_type(dtype)
    at = T.to_arrow_type(dtype)
    assert at == JT.to_arrow_type(jt)
    assert T.from_arrow_type(at) == dtype
    assert JT.from_arrow_type(at) == jt
    assert dtype.name == jt.name
    if not isinstance(dtype, T.StringType):
        phys = torch.empty(0, dtype=T.to_torch_dtype(dtype)).numpy().dtype
        assert phys == JT.to_numpy_dtype(jt)


def test_decimal_precision_past_18_is_refused():
    with pytest.raises(ValueError):
        T.DecimalType(19, 2)
    with pytest.raises(TypeError):
        T.from_arrow_type(pa.decimal128(19, 2))
    assert T.from_arrow_type(pa.timestamp("ns")) == T.TIMESTAMP
    for a, b in (((7, 2), (10, 4)), ((9, 2), (18, 0)), ((3, 0), (3, 3))):
        got = T.common_type(T.DecimalType(*a), T.DecimalType(*b))
        want = JT.common_type(JT.DecimalType(*a), JT.DecimalType(*b))
        assert (got and got.name) == (want and want.name)
    for other in ("BYTE", "SHORT", "INT", "LONG", "FLOAT", "DOUBLE"):
        got = T.common_type(T.DecimalType(7, 2), getattr(T, other))
        want = JT.common_type(JT.DecimalType(7, 2), getattr(JT, other))
        assert (got and got.name) == (want and want.name)


def _decimals(p, s, n=200, seed=0):
    rng = np.random.default_rng(seed + p)
    top = 10 ** p - 1
    vals = [int(v) for v in rng.integers(-min(top, 2 ** 62),
                                         min(top, 2 ** 62) + 1, n)]
    vals[:4] = [top, -top, 0, -1]
    vals = [D(v).scaleb(-s) for v in vals]
    for i in range(5, n, 9):
        vals[i] = None
    return pa.array(vals, pa.decimal128(p, s))


def _unscaled(arr, s):
    return [None if v is None else int(v.scaleb(s)) for v in arr.to_pylist()]


def _port_col(table):
    c = from_arrow(table, CPU).columns[0]
    return c.data.numpy(), c.validity.numpy()


def _jax_col(table):
    c = jfrom_arrow(table).columns[0]
    n = table.num_rows
    return np.asarray(c.data)[:n], np.asarray(c.validity)[:n]


@pytest.mark.parametrize("p,s", [(1, 0), (9, 2), (10, 3), (18, 4)])
def test_decimal_upload_equals_jax_and_round_trips(p, s):
    arr = _decimals(p, s)
    t = pa.table({"d": arr})
    data, valid = _port_col(t)
    jdata, jvalid = _jax_col(t)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(data[valid], jdata[jvalid])
    assert [int(v) if ok else None for v, ok in zip(data, valid)] \
        == _unscaled(arr, s)
    assert to_arrow(from_arrow(t, CPU)).equals(t)
    # a slice: the strided view starts at the slice's offset
    part = t.slice(7, 50)
    assert to_arrow(from_arrow(part, CPU)).equals(part)


@pytest.mark.parametrize("p,s,layout", [
    (1, 0, "int32"), (9, 2, "int32"), (10, 3, "int64"), (18, 4, "int64"),
    (9, 2, "flba"), (18, 4, "flba")])
@pytest.mark.parametrize("fast", [False, True], ids=["pyarrow", "fastpar"])
def test_decimal_parquet_layouts_scan_exactly(tmp_path, p, s, layout,
                                              fast):
    arr = _decimals(p, s, 300, seed=9)
    t = pa.table({"d": arr, "k": pa.array(np.arange(300, dtype=np.int64))})
    path = str(tmp_path / "d.parquet")
    pq.write_table(t, path, store_decimal_as_integer=layout != "flba")
    phys = pq.ParquetFile(path).schema.column(0).physical_type
    assert phys == {"int32": "INT32", "int64": "INT64",
                    "flba": "FIXED_LEN_BYTE_ARRAY"}[layout]
    session = TorchSession({C.FAST_DECODE: fast}, device="cpu")
    df = session.read_parquet(path)
    got = df.collect()
    assert got.equals(t)
    scan = next(n for n in df.physical_plan().walk() if not n.children)
    list(scan.execute())
    # the native decoder takes INT32 / INT64 decimals and sends a
    # FIXED_LEN_BYTE_ARRAY one to pyarrow, by its support check
    assert scan.metrics["fastDecodedFiles"] == int(fast and layout != "flba")


@pytest.mark.parametrize("unit", ["s", "ms", "us", "ns"])
@pytest.mark.parametrize("tz", [None, "UTC", "America/New_York"])
def test_timestamp_units_upload_as_microseconds(unit, tz):
    per_unit = {"s": 10 ** 6, "ms": 10 ** 3, "us": 1}
    raw = np.array([0, 1, -1, 1_600_000_000_123, -86_400_001, 7_777_777],
                   np.int64)
    arr = pa.array(raw, pa.timestamp(unit, tz=tz), mask=np.array(
        [False, False, False, False, True, False]))
    t = pa.table({"t": arr})
    data, valid = _port_col(t)
    want = raw // 1000 if unit == "ns" else raw * per_unit[unit]
    np.testing.assert_array_equal(data[valid], want[valid])
    got = to_arrow(from_arrow(t, CPU)).column(0)
    assert got.type == pa.timestamp("us", tz="UTC")
    jdata, jvalid = _jax_col(t)
    np.testing.assert_array_equal(valid, jvalid)
    if unit == "us":
        np.testing.assert_array_equal(data[valid], jdata[jvalid])
    else:  # the JAX package reads the raw count of the unit
        np.testing.assert_array_equal(jdata[jvalid], raw[valid])


def test_float32_bits_and_integer_extremes_round_trip():
    f = np.array([-0.0, 0.0, np.inf, -np.inf, 1.5, np.nan], np.float32)
    bits = f.view(np.int32)
    bits[5] = 0x7FC00001  # a NaN payload
    t = pa.table({
        "f": pa.array(f),
        "b": pa.array(np.array([-128, 127, 0, -1, 5, 6], np.int8)),
        "h": pa.array(np.array([-32768, 32767, 0, -1, 5, 6], np.int16),
                      mask=np.array([0, 0, 0, 0, 1, 0], bool)),
    })
    b = from_arrow(t, CPU)
    assert [c.data.dtype for c in b.columns] == [torch.float32, torch.int8,
                                                 torch.int16]
    np.testing.assert_array_equal(b.columns[0].data.numpy().view(np.int32),
                                  bits)
    out = to_arrow(b)
    assert out.schema == t.schema
    np.testing.assert_array_equal(
        out["f"].to_numpy().view(np.int32), bits)
    assert out.column(1).equals(t.column(1))
    assert out.column(2).equals(t.column(2))


def _all_types_table(n=120, seed=3):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.2
    return pa.table({
        "b": pa.array(rng.integers(-128, 128, n).astype(np.int8), mask=mask),
        "h": pa.array(rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16)),
        "f": pa.array(rng.normal(0, 1e3, n).astype(np.float32), mask=mask),
        "t": pa.array(rng.integers(-2 ** 50, 2 ** 50, n),
                      pa.timestamp("us", tz="UTC")),
        "d": pa.array([D(int(v)).scaleb(-2) for v in
                       rng.integers(-10 ** 15, 10 ** 15, n)],
                      pa.decimal128(17, 2), mask=mask),
        "s": pa.array([f"r{i}" for i in range(n)]),
    })


def test_each_type_spills_to_disk_and_back(tmp_path):
    t = _all_types_table()
    store = BufferStore(device_budget=1, host_budget=1,
                        spill_dir=str(tmp_path))
    h = store.register(from_arrow(t, CPU))
    store.register(from_arrow(t.slice(0, 10), CPU))
    assert h.tier == StorageTier.DISK
    back = h.get()
    assert back.schema.fields[4].dtype == T.DecimalType(17, 2)
    assert to_arrow(back).equals(t)
    store.close()
    assert store.leak_report() == []


def _legacy_file(tmp_path, name, meta, with_date):
    cols = {"k": pa.array([1, 2], pa.int64())}
    if with_date:
        cols["d"] = pa.array([dt.date(1500, 1, 1), dt.date(2000, 1, 1)])
    t = pa.table(cols).replace_schema_metadata(meta)
    path = str(tmp_path / f"{name}.parquet")
    pq.write_table(t, path)
    return path


REBASE_FILES = {
    "pyarrow": None,
    "spark3": {b"org.apache.spark.version": b"3.3.0"},
    "spark2": {b"org.apache.spark.version": b"2.4.8"},
    "spark3_legacy": {b"org.apache.spark.version": b"3.3.0",
                      b"org.apache.spark.legacyDateTime": b""},
}


@pytest.mark.parametrize("name", list(REBASE_FILES))
@pytest.mark.parametrize("with_date", [True, False])
@pytest.mark.parametrize("mode", ["EXCEPTION", "CORRECTED"])
def test_rebase_check_equals_jax(tmp_path, name, with_date, mode):
    path = _legacy_file(tmp_path, name, REBASE_FILES[name], with_date)
    md = pq.ParquetFile(path).metadata
    fields = [("k", T.LONG, JT.LONG)] + (
        [("d", T.DATE, JT.DATE)] if with_date else [])
    schema = T.Schema([T.Field(n, t) for n, t, _ in fields])
    jschema = JT.Schema([JT.Field(n, t) for n, _, t in fields])

    def raises(fn, *args):
        try:
            fn(*args)
        except ValueError:
            return True
        return False

    got = raises(rebase.check_rebase, path, md, schema, mode)
    want = raises(jrebase.check_rebase, path, md, jschema, mode)
    assert got == want
    assert got == (mode == "EXCEPTION" and with_date
                   and name in ("spark2", "spark3_legacy"))
    assert rebase.file_is_legacy_calendar(md) \
        == jrebase.file_is_legacy_calendar(md)
    # the scan checks each file it opens, under the session's mode
    session = TorchSession({rebase.REBASE_MODE_READ: mode}, device="cpu")
    df = session.read_parquet(path)
    if got:
        with pytest.raises(ValueError, match="legacy hybrid"):
            df.collect()
    else:
        assert df.collect().num_rows == 2


def _hash_inputs(n=257, seed=11):
    """numpy columns of every new type: -0.0, NaN payloads and +/-inf
    floats, MIN_VALUE tinyints and smallints, instants before 1970,
    negative decimals; 20 % NULLs."""
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 100, n).astype(np.float32)
    f[::7] = -0.0
    f[1::11] = 0.0
    f[2::13] = np.nan
    f[5::19] = np.inf
    f[6::23] = -np.inf
    fb = f.view(np.int32)
    fb[3::13] = 0x7F800001
    fb[4::17] = np.int32(-0x00400000)
    b = rng.integers(-128, 128, n).astype(np.int8)
    b[::9] = -128
    h = rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16)
    h[::9] = -32768
    ts = rng.integers(-2 ** 55, 2 ** 55, n).astype(np.int64)
    dec = rng.integers(-10 ** 17, 10 ** 17, n).astype(np.int64)
    out = {}
    for name, vals, pt, jt in (
            ("b", b, T.BYTE, JT.BYTE), ("h", h, T.SHORT, JT.SHORT),
            ("f", f, T.FLOAT, JT.FLOAT), ("t", ts, T.TIMESTAMP, JT.TIMESTAMP),
            ("d", dec, T.DecimalType(18, 2), JT.DecimalType(18, 2))):
        valid = rng.random(n) >= 0.2
        out[name] = (Column(torch.from_numpy(vals.copy()),
                            torch.from_numpy(valid), pt),
                     JColumn(jnp.asarray(vals), jnp.asarray(valid), jt))
    return out


@pytest.mark.parametrize("names", [["b"], ["h"], ["f"], ["t"], ["d"],
                                   ["b", "h", "f", "t", "d"],
                                   ["d", "f", "t", "h", "b"]])
@pytest.mark.parametrize("parts", [0, 8, 200])
def test_plain_k1_over_new_types_equals_jax(names, parts):
    cols = _hash_inputs()
    n = len(cols["b"][0])
    port = [cols[k][0] for k in names]
    jax = [cols[k][1] for k in names]
    if parts:
        got = H.partition_ids(port, n, CPU, parts).numpy()
        want = np.asarray(JH.partition_ids(jax, n, parts))
    else:
        got = H.hash_columns(port, n, CPU).numpy()
        want = np.asarray(JH.hash_columns(jax, n))
    np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_a_type_the_kernel_lacks_still_raises():
    from spark_rapids_tpu_torch.ops import kernels

    col = Column(torch.zeros(3, dtype=torch.int64),
                 torch.ones(3, dtype=torch.bool), T.NULL)
    with pytest.raises(TypeError, match="murmur3 unsupported"):
        kernels.hash_columns([col], 3, CPU)

