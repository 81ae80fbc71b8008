"""The port's host codec (``spark_rapids_tpu_torch/native``) against its
plain versions.

The C++ snappy decoder is held against ``pyarrow.Codec("snappy")`` and
the C++ RLE / bit-packed decoder against the numpy one
(``fastpar._rle_decode_numpy``), on random and edge inputs: every bit
width 0-32, runs that cross bit-packed group boundaries, streams cut
short (which must give a nonzero return code), and real Parquet pages.
Equality is exact: these are byte and integer decoders.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.io import fastpar


def _snappy_c(comp: bytes, n: int):
    """(return code, output) of the C++ decoder after the preamble."""
    buf = np.frombuffer(comp, np.uint8)
    pos = 0
    while buf[pos] & 0x80:
        pos += 1
    body = np.ascontiguousarray(buf[pos + 1:])
    out = np.zeros(max(n, 1), np.uint8)
    rc = native.load().snappy_raw_decompress(body.ctypes.data, len(body),
                                             out.ctypes.data, n)
    return rc, out[:n]


def _snappy_inputs():
    rng = np.random.default_rng(15)
    return {
        "low_entropy": rng.integers(0, 5, 100_000).astype(np.uint8).tobytes(),
        "random": rng.integers(0, 256, 100_000).astype(np.uint8).tobytes(),
        "one_byte_run": b"a" * 70_000,
        "empty": b"",
        "short_literal": b"xyz",
        "repeated_pattern": bytes(rng.integers(0, 3, 10).astype(np.uint8))
        * 9000,
        "long_literal_then_copies": rng.integers(
            0, 256, 70_000).astype(np.uint8).tobytes() * 2,
        "parquet_like_doubles": (np.round(rng.uniform(0, 1e4, 20_000), 2)
                                 .tobytes()),
    }


@pytest.mark.parametrize("name", list(_snappy_inputs()))
def test_snappy_equals_the_pyarrow_codec(name):
    data = _snappy_inputs()[name]
    comp = pa.Codec("snappy").compress(data, asbytes=True)
    want = pa.Codec("snappy").decompress(comp, decompressed_size=len(data),
                                         asbytes=True)
    rc, out = _snappy_c(comp, len(data))
    assert rc == 0 and out.tobytes() == want == data
    got = fastpar._snappy_decompress(np.frombuffer(comp, np.uint8),
                                     len(data))
    assert got is not None and got.tobytes() == data


def test_snappy_refuses_truncated_and_mislengthed_streams():
    data = np.random.default_rng(3).integers(0, 4, 50_000).astype(
        np.uint8).tobytes()
    comp = pa.Codec("snappy").compress(data, asbytes=True)
    for cut in (1, 2, len(comp) // 2, len(comp) - 1):
        rc, _ = _snappy_c(comp[:cut] if cut > 3 else comp[:3], len(data))
        assert rc != 0, cut
    # the preamble's length must be the page header's
    assert fastpar._snappy_decompress(np.frombuffer(comp, np.uint8),
                                      len(data) + 1) is None
    # a copy reaching before the start of the output
    rc, _ = _snappy_c(bytes([4, 0x01 | (0 << 2), 9]), 4)
    assert rc != 0


# --------------------------------------------------------------------- #
# RLE / bit-packed hybrid
# --------------------------------------------------------------------- #


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _encode(runs, bit_width: int) -> tuple[bytes, np.ndarray]:
    """A hybrid stream from [("rle", value, count) | ("packed", values)]
    and the values it decodes to (bit-packed runs padded to groups of
    8, as the format has them)."""
    out = bytearray()
    vals = []
    byte_w = (bit_width + 7) // 8
    for run in runs:
        if run[0] == "rle":
            _, v, count = run
            out += _varint(count << 1)
            out += int(v).to_bytes(byte_w, "little") if byte_w else b""
            vals += [v] * count
        else:
            values = list(run[1])
            groups = -(-len(values) // 8)
            padded = values + [0] * (groups * 8 - len(values))
            out += _varint((groups << 1) | 1)
            acc = 0
            for i, v in enumerate(padded):
                acc |= int(v) << (i * bit_width)
            out += acc.to_bytes(groups * bit_width, "little")
            vals += padded
    return bytes(out), np.array(vals, np.uint32)


def _random_runs(rng, bit_width: int, n_runs: int):
    hi = 1 << bit_width
    runs = []
    for _ in range(n_runs):
        if rng.random() < 0.5:
            runs.append(("rle", int(rng.integers(0, hi)),
                         int(rng.integers(1, 40))))
        else:
            k = int(rng.integers(1, 30))
            runs.append(("packed", rng.integers(0, hi, k, dtype=np.uint64)))
    return runs


def _both(stream: bytes, bit_width: int, n: int):
    data = np.frombuffer(stream, np.uint8)
    return (fastpar._rle_decode(data, bit_width, n),
            fastpar._rle_decode_numpy(data, bit_width, n))


@pytest.mark.parametrize("bit_width", range(0, 33))
def test_rle_equals_the_numpy_decoder_at_every_bit_width(bit_width):
    rng = np.random.default_rng(100 + bit_width)
    runs = _random_runs(rng, bit_width, 12)
    stream, want = _encode(runs, bit_width)
    if bit_width == 0:
        want[:] = 0
    got, plain = _both(stream, bit_width, len(want))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)
    # fewer values than the stream holds: a run is cut at n
    for n in (1, len(want) // 2, len(want) - 1):
        got, plain = _both(stream, bit_width, n)
        np.testing.assert_array_equal(got, want[:n])
        np.testing.assert_array_equal(plain, want[:n])


@pytest.mark.parametrize("bit_width", [1, 3, 8, 13, 20, 32])
def test_rle_runs_across_group_boundaries(bit_width):
    hi = (1 << bit_width) - 1
    runs = [("packed", [hi, 0, 1, hi, 2 & hi, 0, 1]),  # 7: padded
            ("rle", hi, 9),                         # crosses a group of 8
            ("packed", [1] * 17),                   # three groups
            ("rle", 0, 1),
            ("packed", [hi] * 8),
            ("rle", 1 % (hi + 1), 1000)]
    stream, want = _encode(runs, bit_width)
    got, plain = _both(stream, bit_width, len(want))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)


@pytest.mark.parametrize("bit_width", [1, 7, 16, 32])
def test_rle_truncated_stream_gives_a_nonzero_return_code(bit_width):
    rng = np.random.default_rng(bit_width)
    stream, want = _encode(_random_runs(rng, bit_width, 10), bit_width)
    for cut in (0, 1, len(stream) // 2, len(stream) - 1):
        data = np.frombuffer(stream[:cut], np.uint8).copy()
        out = np.empty(len(want), np.uint32)
        rc = native.load().rle_unpack_u32(data.ctypes.data, len(data),
                                          bit_width, out.ctypes.data,
                                          len(want))
        assert rc != 0, cut
        got, plain = _both(stream[:cut], bit_width, len(want))
        assert got is None and plain is None, cut


def test_rle_refuses_a_bit_width_over_32():
    data = np.zeros(8, np.uint8)
    out = np.empty(4, np.uint32)
    assert native.load().rle_unpack_u32(data.ctypes.data, 8, 33,
                                        out.ctypes.data, 4) != 0
    assert fastpar._rle_decode(data, 33, 4) is None
    assert fastpar._rle_decode_numpy(data, 33, 4) is None


def test_rle_decodes_real_parquet_dictionary_codes(tmp_path):
    """The codes of a file pyarrow wrote, decoded both ways, gather the
    values pyarrow reads back."""
    import pyarrow.parquet as pq

    rng = np.random.default_rng(5)
    vals = rng.integers(0, 700, 20_000)
    p = str(tmp_path / "codes.parquet")
    pq.write_table(pa.table({"x": vals}), p, compression="none")
    meta = pq.ParquetFile(p).metadata.row_group(0).column(0)
    with open(p, "rb") as fh:
        fc = fastpar._decode_chunk(fh, meta, 1, 0)
    assert fc is not None and fc.codes is not None
    np.testing.assert_array_equal(fc.dict_values[fc.codes], vals)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """A missing compiler is an error, never a silent change of path."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "none")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda _name: None)
    with pytest.raises(native.HostCodecError, match="g.. not found"):
        native.load()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native.shutil, "which", lambda _name: "g++")
    with pytest.raises(native.HostCodecError, match="g.. failed"):
        native.load()


def test_the_build_is_keyed_by_the_source(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    first = native.build()
    assert first.exists() and first.parent == tmp_path
    assert native.build() == first  # built once
    src = tmp_path / "hostcodec.cpp"
    src.write_text(native.SOURCE.read_text() + "\n// another key\n")
    monkeypatch.setattr(native, "SOURCE", src)
    assert native.library_path() != first
    assert not list(tmp_path.glob("*.tmp"))


def _python_headers(seg: np.ndarray, n_total: int) -> list:
    """The page records by the plain thrift reader, as the C walker
    lays them out (absent fields -1)."""
    recs, pos, seen = [], 0, 0
    while pos < len(seg) and seen < n_total:
        hdr, body = fastpar._parse_page_header(seg, pos)
        dp, dd, v2 = hdr.get(5, {}), hdr.get(7, {}), hdr.get(8, {})
        rec = [hdr.get(1, -1), body, hdr.get(3, -1), hdr.get(2, -1),
               *(dp.get(f, -1) for f in range(1, 5)),
               dd.get(1, -1), dd.get(2, -1),
               *(int(v2[f]) if f in v2 else -1 for f in range(1, 8))]
        recs.append(rec)
        pos = body + rec[2]
        seen += max(rec[4], 0) + max(rec[10], 0)
    return recs


@pytest.mark.parametrize("kw", [
    {"compression": "snappy"}, {"compression": "none"},
    {"compression": "zstd", "data_page_version": "2.0"},
    {"compression": "gzip", "use_dictionary": False},
    {"compression": "snappy", "data_page_size": 512},
], ids=["snappy", "none", "zstd_v2", "gzip_plain", "small_pages"])
def test_page_headers_equal_the_thrift_reader(tmp_path, kw):
    import pyarrow.parquet as pq

    rng = np.random.default_rng(8)
    n = 30_000
    t = pa.table({
        "k": pa.array(rng.integers(0, 50, n), pa.int64(),
                      mask=rng.random(n) < 0.1),
        "x": np.round(rng.uniform(0, 1e5, n), 2),
        "s": pa.array(np.array(["a", "bb", "ccc"])[rng.integers(0, 3, n)]),
    })
    p = str(tmp_path / "pages.parquet")
    pq.write_table(t, p, **kw)
    md = pq.ParquetFile(p).metadata
    with open(p, "rb") as fh:
        for ci in range(md.num_columns):
            cm = md.row_group(0).column(ci)
            start = cm.data_page_offset
            if cm.has_dictionary_page and cm.dictionary_page_offset:
                start = min(start, cm.dictionary_page_offset)
            fh.seek(start)
            seg = np.frombuffer(fh.read(cm.total_compressed_size), np.uint8)
            got = fastpar._page_headers(seg, cm.num_values).tolist()
            want = _python_headers(seg, cm.num_values)
            assert got == want and len(got) >= 2, ci


def test_page_headers_refuse_a_cut_header():
    import pyarrow.parquet as pq
    import io

    buf = io.BytesIO()
    pq.write_table(pa.table({"x": np.arange(5000)}), buf)
    raw = np.frombuffer(buf.getvalue(), np.uint8)
    md = pq.ParquetFile(io.BytesIO(buf.getvalue())).metadata
    cm = md.row_group(0).column(0)
    start = min(cm.data_page_offset, cm.dictionary_page_offset or
                cm.data_page_offset)
    seg = raw[start:start + cm.total_compressed_size]
    assert fastpar._page_headers(seg[:3], cm.num_values) is None
    assert fastpar._page_headers(seg[:-1], cm.num_values) is None


@pytest.mark.parametrize("kw", [
    {"compression": "snappy"}, {"compression": "none"},
    {"compression": "snappy", "data_page_version": "2.0"},
    {"compression": "none", "use_dictionary": False},
    {"compression": "snappy", "data_page_size": 700},
], ids=["snappy", "none", "snappy_v2", "plain", "small_pages"])
def test_the_one_call_page_decoder_equals_the_python_walk(tmp_path, kw,
                                                          monkeypatch):
    """``decode_pages`` (dictionary, PLAIN and NULL-carrying pages in C)
    against the page-by-page walk, which reads every page when the C
    call leaves them all."""
    import pyarrow.parquet as pq

    rng = np.random.default_rng(12)
    n = 40_000
    t = pa.table({
        "k": pa.array(rng.integers(0, 60, n), pa.int64(),
                      mask=rng.random(n) < 0.2),
        "x": pa.array(np.round(rng.uniform(0, 1e6, n), 2),
                      mask=rng.random(n) < 0.05),
        "d": pa.array(rng.integers(0, 9, n).astype(np.int32)),
        "f": pa.array(rng.random(n).astype(np.float32)),
    })
    p = str(tmp_path / "pages.parquet")
    pq.write_table(t, p, **kw)
    md = pq.ParquetFile(p).metadata

    def decode_all():
        with open(p, "rb") as fh:
            return [fastpar._decode_chunk(fh, md.row_group(0).column(ci), 1,
                                          0) for ci in range(md.num_columns)]

    got = decode_all()
    real = fastpar._pages_in_c
    monkeypatch.setattr(fastpar, "_pages_in_c",
                        lambda seg, pages, *a: np.zeros(len(pages), np.int8))
    want = decode_all()
    monkeypatch.setattr(fastpar, "_pages_in_c", real)
    for ci, (g, w) in enumerate(zip(got, want)):
        assert g is not None and w is not None, ci
        for attr in ("codes", "values", "validity"):
            a, b = getattr(g, attr), getattr(w, attr)
            assert (a is None) == (b is None), (ci, attr)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        dv, wv = g.dict_values, w.dict_values
        assert (dv is None) == (wv is None)
        if dv is not None:
            np.testing.assert_array_equal(dv, wv)


@pytest.mark.parametrize("dtype", [np.bool_, np.int16, np.int32, np.int64,
                                   np.float32, np.float64])
def test_gather_codes_equals_numpy_take(dtype):
    from spark_rapids_tpu_torch.columnar.arrow import _gather

    rng = np.random.default_rng(3)
    dictionary = rng.integers(-50, 50, 37).astype(dtype)
    codes = rng.integers(-3, 40, 10_001).astype(np.int32)  # some clipped
    got = np.empty(len(codes), dtype)
    _gather(dictionary, codes, got)
    np.testing.assert_array_equal(
        got, np.take(dictionary, codes, mode="clip"))


def test_byte_array_plain_splits_and_refuses_like_the_page_format():
    import struct

    words = [b"", b"a\0b", "日本".encode(), b"xyz" * 50, b"\0"]
    page = b"".join(struct.pack("<i", len(w)) + w for w in words)
    arr = fastpar._decode_byte_array_dict(np.frombuffer(page, np.uint8),
                                          len(words))
    assert arr.to_pylist() == [w.decode() for w in words]
    for bad in (page[:-1], page[:3],
                struct.pack("<i", -1) + page[4:]):
        assert fastpar._decode_byte_array_dict(
            np.frombuffer(bad, np.uint8), len(words)) is None
    assert fastpar._decode_byte_array_dict(
        np.frombuffer(struct.pack("<i", 2) + b"\xc3(", np.uint8), 1) is None
