"""The port's native Parquet decoder (``io/fastpar.py``) against the JAX
package's, on the same files.

Every file case of ``tests/test_fastpar.py`` is written once and read by
both ``read_file``s with the same row groups, columns, conjuncts
(each built from its own package's classes, bound to the same schema)
and runtime filters.  Both must refuse the same files (None: the scan
then reads the file with pyarrow), and the tables they return must be
equal, column for column, after dictionary columns are decoded (the
port keeps every dictionary; the JAX decoder materializes one of more
than 0xFFFF entries).  A case also holds the port against
``pyarrow.parquet``'s read.  The one departure: strings with NUL bytes,
which the JAX decoder cuts at the NUL; there the port is held against
pyarrow alone.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs import predicates as JP
from spark_rapids_tpu.io import fastpar as jfastpar

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs import predicates as P
from spark_rapids_tpu_torch.io import fastpar


def _write(tmp_path, table, name="t.parquet", **kw):
    p = str(tmp_path / name)
    pq.write_table(table, p, **kw)
    return p


def _plain(table: pa.Table) -> pa.Table:
    cols = []
    for c in table.columns:
        c = c.combine_chunks()
        if pa.types.is_dictionary(c.type):
            c = c.cast(c.type.value_type)
        cols.append(c)
    return pa.table(cols, names=table.column_names)


def _read_both(path, columns=None, conjuncts=None, schemas=None):
    """(port tables, JAX tables) of one file's row groups; conjuncts is
    a function of a namespace (B/P or JB/JP) to a list of unbound
    conjuncts, bound here to each package's schema."""
    f = pq.ParquetFile(path)
    cols = columns or list(f.schema_arrow.names)
    rgs = list(range(f.metadata.num_row_groups))
    pconj = jconj = pschema = jschema = None
    if conjuncts is not None:
        pschema, jschema = schemas
        pconj = [B.bind_references(c, pschema)
                 for c in conjuncts(B, P)]
        jconj = [JB.bind_references(c, jschema)
                 for c in conjuncts(JB, JP)]
    got = fastpar.read_file(path, rgs, cols, pconj, pschema)
    want = jfastpar.read_file(path, rgs, cols, jconj, jschema)
    return got, want


def _assert_equal_to_jax(path, columns=None, **kw):
    got, want = _read_both(path, columns, **kw)
    assert (got is None) == (want is None)
    assert got is not None, "the decoder refused a supported file"
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _plain(g).equals(_plain(w))
    return pa.concat_tables([_plain(t) for t in got])


def _assert_equal_to_pyarrow(path, columns=None):
    got = _assert_equal_to_jax(path, columns)
    want = pq.read_table(path, columns=columns)
    assert got.equals(want.select(got.column_names))


@pytest.mark.parametrize("compression", ["snappy", "gzip", "zstd", "none"])
def test_low_cardinality_dictionary_columns(tmp_path, compression):
    rng = np.random.default_rng(7)
    t = pa.table({
        "i32": rng.integers(0, 50, 10_000).astype(np.int32),
        "i64": rng.integers(-100, 100, 10_000),
        "f32": rng.integers(0, 20, 10_000).astype(np.float32),
        "f64": rng.integers(0, 11, 10_000) / 100.0,
    })
    _assert_equal_to_pyarrow(_write(tmp_path, t, compression=compression))


@pytest.mark.parametrize("compression", ["snappy", "gzip", "zstd", "none"])
def test_nulls_and_codecs(tmp_path, compression):
    rng = np.random.default_rng(3)
    n = 6000
    t = pa.table({
        "i": pa.array(rng.integers(0, 40, n), pa.int64(),
                      mask=rng.random(n) < 0.15),
        "f": pa.array(rng.integers(0, 9, n).astype(np.float64),
                      mask=rng.random(n) < 0.05),
        "dense": rng.integers(0, 1000, n),
    })
    _assert_equal_to_pyarrow(_write(tmp_path, t, compression=compression))


@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_data_page_versions(tmp_path, version):
    rng = np.random.default_rng(21)
    t = pa.table({"k": pa.array(rng.integers(0, 30, 5000), pa.int64(),
                                mask=rng.random(5000) < 0.1)})
    _assert_equal_to_pyarrow(_write(tmp_path, t,
                                    data_page_version=version))


def test_plain_fallback_pages(tmp_path):
    """The dictionary overflows mid-chunk: later pages are PLAIN."""
    rng = np.random.default_rng(8)
    t = pa.table({
        "x": np.round(rng.uniform(0, 1e6, 300_000), 2),
        "y": rng.integers(0, 1 << 40, 300_000),
    })
    p = _write(tmp_path, t, row_group_size=150_000)
    meta = pq.ParquetFile(p).metadata.row_group(0).column(0)
    assert "PLAIN" in meta.encodings and meta.has_dictionary_page
    _assert_equal_to_pyarrow(p)


def test_plain_only_chunks(tmp_path):
    rng = np.random.default_rng(9)
    t = pa.table({"x": rng.random(50_000)})
    _assert_equal_to_pyarrow(_write(tmp_path, t, use_dictionary=False))


def test_several_row_groups_and_a_column_subset(tmp_path):
    rng = np.random.default_rng(10)
    t = pa.table({
        "a": rng.integers(0, 5, 40_000),
        "b": rng.random(40_000),
        "c": rng.integers(0, 3, 40_000).astype(np.int32),
    })
    p = _write(tmp_path, t, row_group_size=9_000)
    _assert_equal_to_pyarrow(p, columns=["b", "a"])


def test_every_caller_decodes_its_columns_on_one_shared_pool(
        tmp_path, monkeypatch):
    """Row groups read from several threads at once decode their
    columns on the one pool of a thread a core, and read as pyarrow's."""
    import os
    import threading
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(10)
    t = pa.table({
        "a": rng.integers(0, 5, 30_000),
        "b": rng.random(30_000),
        "c": pa.array(rng.integers(0, 9, 30_000).astype(str)),
    })
    p = _write(tmp_path, t, row_group_size=7_000)
    threads = set()
    decode = fastpar._decode_chunk_bytes

    def recorded(*a):
        threads.add(threading.current_thread().name)
        return decode(*a)

    monkeypatch.setattr(fastpar, "_decode_chunk_bytes", recorded)
    cols = ["c", "a", "b"]
    with ThreadPoolExecutor(4) as callers:
        got = list(callers.map(lambda _: fastpar.read_file(
            p, [0, 1, 2, 3, 4], cols, None, None), range(4)))
    assert threads and all(n.startswith("fastpar") for n in threads)
    assert len(threads) <= (os.cpu_count() or 1)
    assert fastpar._shared_column_pool() is fastpar._shared_column_pool()
    want = pq.read_table(p, columns=cols)
    for tables in got:
        assert len(tables) == 5
        assert pa.concat_tables([_plain(x) for x in tables]).equals(want)


def test_dictionary_strings_and_nulls(tmp_path):
    rng = np.random.default_rng(11)
    vals = np.array(["N", "O", "F", "ünï", "日本語", ""])[
        rng.integers(0, 6, 20_000)]
    t = pa.table({"flag": pa.array(vals, mask=rng.random(20_000) < 0.1),
                  "v": rng.integers(0, 9, 20_000)})
    p = _write(tmp_path, t)
    _assert_equal_to_pyarrow(p)
    got, _ = _read_both(p)
    assert pa.types.is_dictionary(got[0].column("flag").type)


def test_a_string_dictionary_over_0xffff_entries_stays_a_dictionary(
        tmp_path):
    n = 0x10000 + 500
    vals = np.array([f"k{i:06d}" for i in range(n)])
    t = pa.table({"s": vals[np.random.default_rng(2).permutation(n)]})
    p = _write(tmp_path, t, dictionary_pagesize_limit=1 << 24)
    _assert_equal_to_pyarrow(p)
    got, want = _read_both(p)
    assert pa.types.is_dictionary(got[0].column("s").type)
    assert not pa.types.is_dictionary(want[0].column("s").type)


def test_strings_with_nul_bytes_equal_pyarrow(tmp_path):
    """The one departure from the JAX decoder, which cuts at a NUL."""
    words = ["a\0", "a\0b", "\0", "ab", "", "x\0\0y"]
    vals = np.array(words, dtype=object)[
        np.random.default_rng(4).integers(0, len(words), 3000)]
    p = _write(tmp_path, pa.table({"s": pa.array(list(vals), pa.string())}))
    got, want = _read_both(p)
    assert got is not None and want is not None
    got = _plain(got[0])
    assert got.equals(pq.read_table(p))
    assert not _plain(want[0]).equals(got)  # the JAX decoder's cut


def test_invalid_utf8_sends_the_file_to_pyarrow(tmp_path):
    bad = pa.Array.from_buffers(pa.string(), 2, [
        None, pa.py_buffer(np.array([0, 2, 3], np.int32)),
        pa.py_buffer(b"a\xff\x80")])
    t = pa.table({"s": pa.array([b"a\xff", b"\x80"] * 50, pa.binary())})
    p = _write(tmp_path, t)
    # the file's column is BINARY: read it as it is, both decoders alike
    got, want = _read_both(p)
    assert (got is None) == (want is None)
    schema = pa.schema([pa.field("s", pa.string())])
    p2 = str(tmp_path / "bad_utf8.parquet")
    with pq.ParquetWriter(p2, schema) as w:
        w.write_table(pa.Table.from_arrays([bad], schema=schema))
    got, want = _read_both(p2)
    assert got is None and want is None


def test_dates_and_timestamps(tmp_path):
    rng = np.random.default_rng(12)
    days = rng.integers(8766, 10957, 5_000).astype(np.int32)
    t = pa.table({
        "d": pa.array(days, pa.int32()).cast(pa.date32()),
        "ts": pa.array(rng.integers(0, 1 << 48, 5_000)).cast(
            pa.timestamp("us")),
    })
    _assert_equal_to_pyarrow(_write(tmp_path, t))


def test_nested_and_lz4_are_refused(tmp_path):
    nested = _write(tmp_path, pa.table({"x": pa.array([[1, 2], [3]] * 100)}),
                    name="nested.parquet")
    lz4 = _write(tmp_path, pa.table({"x": np.arange(1000.0)}),
                 name="lz4.parquet", compression="lz4")
    for p in (nested, lz4):
        got, want = _read_both(p)
        assert got is None and want is None


def test_the_decoded_size_cap_refuses_the_file(tmp_path):
    p = _write(tmp_path, pa.table({"x": np.arange(20_000.0)}))
    rg = pq.ParquetFile(p).metadata.row_group(0).column(0)
    size = rg.total_uncompressed_size
    for cap, refused in ((size, False), (size - 1, True)):
        got = fastpar.read_file(p, [0], ["x"], None, None,
                                max_decoded_bytes=cap)
        want = jfastpar.read_file(p, [0], ["x"], None, None,
                                  max_decoded_bytes=cap)
        assert (got is None) == (want is None) == refused


def _disc_qty(tmp_path):
    rng = np.random.default_rng(13)
    disc = rng.integers(0, 11, 30_000) / 100.0
    qty = rng.integers(1, 51, 30_000).astype(np.float64)
    p = _write(tmp_path, pa.table({"disc": disc, "qty": qty}))
    schemas = (T.Schema([T.Field("disc", T.DOUBLE), T.Field("qty", T.DOUBLE)]),
               JT.Schema([JT.Field("disc", JT.DOUBLE),
                          JT.Field("qty", JT.DOUBLE)]))
    return p, disc, qty, schemas


def test_the_lut_filter_on_the_dictionary(tmp_path):
    p, disc, qty, schemas = _disc_qty(tmp_path)

    def conj(b, pr):
        d, q = b.ColumnReference("disc"), b.ColumnReference("qty")
        return [pr.GreaterThanOrEqual(d, b.Literal.of(0.05)),
                pr.LessThanOrEqual(d, b.Literal.of(0.07)),
                pr.LessThan(q, b.Literal.of(24.0))]

    got = _assert_equal_to_jax(p, conjuncts=conj, schemas=schemas)
    mask = (disc >= 0.05) & (disc <= 0.07) & (qty < 24.0)
    assert got.num_rows == int(mask.sum()) > 0
    np.testing.assert_array_equal(got["disc"].to_numpy(), disc[mask])
    np.testing.assert_array_equal(got["qty"].to_numpy(), qty[mask])


def _nullable_k(tmp_path):
    t = pa.table({
        "k": pa.array([1, None, 3, None, 1, 3] * 500, pa.int64()),
        "v": pa.array(np.arange(3000.0)),
    })
    schemas = (T.Schema([T.Field("k", T.LONG), T.Field("v", T.DOUBLE)]),
               JT.Schema([JT.Field("k", JT.LONG), JT.Field("v", JT.DOUBLE)]))
    return _write(tmp_path, t), schemas


def test_the_null_aware_filter_drops_null_rows(tmp_path):
    p, schemas = _nullable_k(tmp_path)
    got = _assert_equal_to_jax(
        p, conjuncts=lambda b, pr: [pr.GreaterThanOrEqual(
            b.ColumnReference("k"), b.Literal.of(2))], schemas=schemas)
    assert got.num_rows == 1000 and got["k"].null_count == 0


def test_is_null_keeps_the_null_rows(tmp_path):
    p, schemas = _nullable_k(tmp_path)
    got = _assert_equal_to_jax(
        p, conjuncts=lambda b, pr: [pr.IsNull(b.ColumnReference("k"))],
        schemas=schemas)
    assert got.num_rows == 1000 and got["k"].null_count == 1000


def test_a_string_filter_on_the_dictionary(tmp_path):
    rng = np.random.default_rng(17)
    vals = np.array(["A", "N", "R", "F", "O"])[rng.integers(0, 5, 8000)]
    t = pa.table({"f": pa.array(vals, mask=rng.random(8000) < 0.1),
                  "x": rng.integers(0, 100, 8000)})
    p = _write(tmp_path, t)
    schemas = (T.Schema([T.Field("f", T.STRING), T.Field("x", T.LONG)]),
               JT.Schema([JT.Field("f", JT.STRING), JT.Field("x", JT.LONG)]))
    got = _assert_equal_to_jax(
        p, conjuncts=lambda b, pr: [
            pr.GreaterThan(b.ColumnReference("f"), b.Literal.of("F")),
            pr.LessThan(b.ColumnReference("x"), b.Literal.of(50))],
        schemas=schemas)
    keep = (np.asarray(t["f"].to_pylist(), dtype=object) != None)  # noqa: E711
    keep &= np.array([v is not None and v > "F"
                      for v in t["f"].to_pylist()])
    keep &= t["x"].to_numpy() < 50
    assert got.num_rows == int(keep.sum()) > 0


class _KeysAtMost:
    """A stand-in runtime filter keeping the keys <= ``hi``."""

    ready = True

    def __init__(self, hi):
        self.hi = hi

    def probe_host(self, values, validity=None):
        keep = np.asarray(values, np.int64) <= self.hi
        return keep if validity is None else keep & validity


def test_runtime_filters_probe_the_dictionary(tmp_path):
    p, disc, qty, schemas = _disc_qty(tmp_path)
    t = pq.read_table(p).append_column(
        "key", pa.array(np.arange(30_000) % 97, pa.int64()))
    p = _write(tmp_path, t, name="rf.parquet")
    pschema = T.Schema(list(schemas[0].fields) + [T.Field("key", T.LONG)])
    jschema = JT.Schema(list(schemas[1].fields) + [JT.Field("key", JT.LONG)])
    out = []
    for mod, schema, b, pr in ((fastpar, pschema, B, P),
                               (jfastpar, jschema, JB, JP)):
        conj = [b.bind_references(pr.LessThan(
            b.ColumnReference("qty"), b.Literal.of(24.0)), schema)]
        counters: dict = {}
        tables = mod.read_file(p, [0], ["disc", "key"], conj, schema,
                               runtime_filters=[("key", _KeysAtMost(40))],
                               counters=counters)
        out.append((_plain(tables[0]), counters))
    (got, gc), (want, wc) = out
    # the port also says whether the conjuncts reached every row
    assert got.equals(want) and {k: gc[k] for k in wc} == wc
    assert gc["rf_complete"] and gc["rf_pruned"] > 0
    assert gc["filter_complete"]
    keys = np.arange(30_000) % 97
    assert got.num_rows == int(((qty < 24.0) & (keys <= 40)).sum())
