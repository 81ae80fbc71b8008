"""The native Parquet decoder, which filters on the dictionary.

Counterpart of ``spark_rapids_tpu/io/fastpar.py``.  A scan decodes the
column chunks it needs itself instead of through ``pyarrow.parquet``:
it reads each chunk with one seek and read, walks its page headers
(the thrift compact protocol, just enough of it for ``PageHeader``),
decompresses each page (SNAPPY in the host codec, ``native/``; GZIP
and ZSTD through ``pyarrow.Codec``) and unpacks dictionary codes and
definition levels (the RLE / bit-packed hybrid, in the host codec).

What that buys over the general read path:

- a pushed conjunct that reads one column is evaluated on that column's
  DICTIONARY (tens to thousands of values), giving a per-code boolean
  LUT; filtering the rows is then one gather.  A NULL row takes the
  conjunct's result on a NULL input (false for a comparison, true for
  IS NULL);
- a runtime join filter probes the dictionary the same way
  (application point 2 of ``plan/runtime_filter.py``), and says whether
  it was applied to every row (``rf_complete``), so the scan does not
  probe the rows again at point 3;
- columns are materialized for the surviving rows only, and a
  dictionary-encoded chunk stays a ``pa.DictionaryArray`` of its codes
  and dictionary: strings reach the coded group-by with their codes,
  and a fixed-width column is gathered once, into the upload's pinned
  buffer (``columnar/arrow.py``).

Scope (anything else makes ``read_file`` return None, and the caller
reads the whole FILE with pyarrow, so a result never depends on which
path ran): INT32 / INT64 / FLOAT / DOUBLE, and BYTE_ARRAY when every
data page is dictionary-encoded; SNAPPY, GZIP, ZSTD or UNCOMPRESSED;
data pages v1 and v2; no repetition levels.  A chunk's physical values
become its logical type by reinterpretation (``_logical``): an INT32
or INT64 DECIMAL's unscaled digits, a TIMESTAMP's count of its unit, a
DATE's day number, a TINYINT's or SMALLINT's INT32; any other pair,
and a FIXED_LEN_BYTE_ARRAY decimal, sends the file to pyarrow.  A
string dictionary is an
Arrow string array built from the page's own bytes, so NUL bytes are
kept (the JAX decoder builds a numpy unicode array, which cuts a string
at its first NUL); invalid UTF-8 sends the file to pyarrow, as there.
"""

from __future__ import annotations

import os
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.io.pa_filter import compile_filter

# -- Parquet enums ---------------------------------------------------- #

_DATA_PAGE = 0
_DICT_PAGE = 2
_DATA_PAGE_V2 = 3

_ENC_PLAIN = 0
_ENC_PLAIN_DICT = 2
_ENC_RLE = 3
_ENC_RLE_DICT = 8

_PHYS_NP = {
    "INT32": np.dtype("<i4"),
    "INT64": np.dtype("<i8"),
    "FLOAT": np.dtype("<f4"),
    "DOUBLE": np.dtype("<f8"),
}

# -- thrift compact protocol (just enough for PageHeader) ------------- #


class _Thrift:
    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int):
        self.buf = buf
        self.pos = pos

    def varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = int(self.buf[self.pos])  # int(): a numpy uint8 would
            self.pos += 1                # wrap in the shift below
            out |= (b & 0x7F) << shift
            if not (b & 0x80):
                return out
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def skip(self, ftype: int) -> None:
        if ftype in (1, 2):        # bool true / false: value in the type
            return
        if ftype == 3:             # i8
            self.pos += 1
        elif ftype in (4, 5, 6):   # i16 / i32 / i64: zigzag varints
            self.varint()
        elif ftype == 7:           # double
            self.pos += 8
        elif ftype == 8:           # binary
            ln = self.varint()     # not `pos += varint()`: the left
            self.pos += ln         # operand would load the old pos
        elif ftype in (9, 10):     # list / set
            head = int(self.buf[self.pos])
            self.pos += 1
            size = head >> 4
            if size == 15:
                size = self.varint()
            et = head & 0x0F
            for _ in range(size):
                self.skip(et)
        elif ftype == 12:          # struct
            self.struct_fields(None)
        else:
            raise ValueError(f"thrift type {ftype}")

    def struct_fields(self, out: Optional[dict]) -> None:
        """Walk one struct; into ``out`` (when a dict) its integer,
        bool and struct fields by field id."""
        fid = 0
        while True:
            head = int(self.buf[self.pos])
            self.pos += 1
            if head == 0:
                return
            delta = head >> 4
            ftype = head & 0x0F
            fid = fid + delta if delta else self.zigzag()
            if out is not None and ftype in (4, 5, 6):
                out[fid] = self.zigzag()
            elif out is not None and ftype in (1, 2):
                out[fid] = ftype == 1
            elif out is not None and ftype == 12:
                sub: dict = {}
                self.struct_fields(sub)
                out[fid] = sub
            else:
                self.skip(ftype)


def _parse_page_header(buf, pos: int) -> tuple[dict, int]:
    """(fields by parquet.thrift PageHeader field id, position after
    the header); nested header structs are dicts."""
    t = _Thrift(buf, pos)
    fields: dict = {}
    t.struct_fields(fields)
    return fields, t.pos


# -- decode primitives ------------------------------------------------ #


def _snappy_decompress(payload: np.ndarray,
                       out_len: int) -> Optional[np.ndarray]:
    """A snappy block -> its ``out_len`` bytes, or None when the stream
    is malformed or decodes to another length."""
    pos = 0
    dec_len = 0
    shift = 0
    while True:  # the varint preamble: the decoded length
        if pos >= len(payload):
            return None
        b = int(payload[pos])
        pos += 1
        dec_len |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    if dec_len != out_len:
        return None
    body = np.ascontiguousarray(payload[pos:])
    out = np.empty(out_len, np.uint8)
    rc = native.load().snappy_raw_decompress(
        body.ctypes.data, len(body), out.ctypes.data, out_len)
    return out if rc == 0 else None


def _rle_decode_into(data: np.ndarray, bit_width: int,
                     out: np.ndarray) -> bool:
    """The RLE / bit-packed hybrid into a contiguous uint32 array (the
    host codec); False when the stream is malformed or too short."""
    if len(out) == 0:
        return True
    data = np.ascontiguousarray(data)
    return native.load().rle_unpack_u32(data.ctypes.data, len(data),
                                        bit_width, out.ctypes.data,
                                        len(out)) == 0


def _rle_decode(data: np.ndarray, bit_width: int,
                n: int) -> Optional[np.ndarray]:
    """The RLE / bit-packed hybrid -> uint32[n], or None."""
    out = np.empty(n, np.uint32)
    return out if _rle_decode_into(data, bit_width, out) else None


def _rle_decode_numpy(data: np.ndarray, bit_width: int,
                      n: int) -> Optional[np.ndarray]:
    """The plain version of ``_rle_decode``: sequential run headers,
    each bit-packed group unpacked with numpy."""
    out = np.empty(n, np.uint32)
    if n == 0:
        return out
    if not 0 <= bit_width <= 32:
        return None
    if bit_width == 0:
        out[:] = 0
        return out
    pos = 0
    op = 0
    byte_w = (bit_width + 7) // 8
    weights = (np.uint64(1) << np.arange(bit_width, dtype=np.uint64))
    while op < n:
        h = 0
        shift = 0
        while True:
            if pos >= len(data):
                return None
            b = int(data[pos])
            pos += 1
            h |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        if h & 1:
            count = (h >> 1) * 8
            nbytes = count * bit_width // 8
            if pos + nbytes > len(data):
                return None
            bits = np.unpackbits(data[pos:pos + nbytes], bitorder="little")
            pos += nbytes
            take = min(count, n - op)
            vals = bits[:take * bit_width].reshape(take, bit_width)
            out[op:op + take] = (vals.astype(np.uint64) @ weights).astype(
                np.uint32)
            op += take
        else:
            count = h >> 1
            if pos + byte_w > len(data):
                return None
            v = 0
            for j in range(byte_w):
                v |= int(data[pos + j]) << (8 * j)
            pos += byte_w
            take = min(count, n - op)
            out[op:op + take] = v
            op += take
    return out


# -- column-chunk decode ---------------------------------------------- #


class FastColumn:
    """A decoded chunk: (dictionary, codes) or plain values.  The
    dictionary is a numpy array for a fixed-width type and a
    ``pa.StringArray`` for BYTE_ARRAY.  ``validity`` (None: every row
    valid) marks rows whose definition level was below the maximum;
    their code or value slots hold zeros."""

    __slots__ = ("dict_values", "codes", "values", "validity")

    def __init__(self, dict_values=None, codes=None, values=None,
                 validity=None):
        self.dict_values = dict_values
        self.codes = codes
        self.values = values
        self.validity = validity


def _decode_byte_array_dict(buf: np.ndarray, n: int) -> Optional[pa.Array]:
    """A PLAIN byte-array dictionary page -> a ``pa.StringArray`` over
    the page's bytes (NUL bytes kept; ``hostcodec.cpp``'s
    ``byte_array_plain`` splits it), or None when the page is short or
    a value is not UTF-8."""
    buf = np.ascontiguousarray(buf)
    offsets = np.empty(n + 1, np.int32)
    data = np.empty(max(len(buf), 1), np.uint8)
    total = native.load().byte_array_plain(buf.ctypes.data, len(buf), n,
                                           offsets.ctypes.data,
                                           data.ctypes.data)
    if total < 0:
        return None
    arr = pa.Array.from_buffers(pa.string(), n,
                                [None, pa.py_buffer(offsets),
                                 pa.py_buffer(data[:total])])
    try:
        arr.validate(full=True)
    except pa.ArrowInvalid:
        return None
    return arr


#: int64s per page in ``parquet_page_headers``' records, and pages a call
_PAGE_FIELDS, _PAGE_BATCH = 17, 1024


def _page_headers(seg: np.ndarray, n_total: int) -> Optional[np.ndarray]:
    """A chunk's page headers as (pages, _PAGE_FIELDS) int64 records
    (``hostcodec.cpp``'s ``parquet_page_headers``: absent fields are
    -1), up to the page that completes ``n_total`` values; None when a
    header is malformed.  ``_parse_page_header`` is the plain version."""
    lib = native.load()
    seg = np.ascontiguousarray(seg)
    recs: list = []
    pos = seen = 0
    while pos < len(seg) and seen < n_total:
        out = np.empty((_PAGE_BATCH, _PAGE_FIELDS), np.int64)
        n = lib.parquet_page_headers(seg.ctypes.data, len(seg), pos,
                                     n_total - seen, out.ctypes.data,
                                     _PAGE_BATCH)
        if n < 0:
            return None
        if n == 0:
            break
        out = out[:n]
        recs.append(out)
        seen += int(np.where(out[:, 0] == _DATA_PAGE, out[:, 4], 0).clip(0)
                    .sum() + np.where(out[:, 0] == _DATA_PAGE_V2,
                                      out[:, 10], 0).clip(0).sum())
        pos = int(out[-1, 1] + out[-1, 2])
    if not recs:
        return np.empty((0, _PAGE_FIELDS), np.int64)
    return np.concatenate(recs)


def _pages_in_c(seg: np.ndarray, pages: np.ndarray, codec: str,
                max_def: int, codes, values, valid: np.ndarray):
    """``hostcodec.cpp``'s ``decode_pages`` over a chunk's data pages,
    into ``codes`` / ``values`` / ``valid`` (uint8): the status of each
    page (1 dictionary, 2 PLAIN, 0 left to the Python walk), or None
    when a page is malformed."""
    status = np.zeros(len(pages), np.int8)
    scratch = np.empty(max(1, int(pages[:, 3].max(initial=0))), np.uint8)
    got = native.load().decode_pages(
        seg.ctypes.data, pages.ctypes.data, len(pages),
        1 if codec == "SNAPPY" else 0, max_def,
        0 if values is None else values.itemsize,
        None if codes is None else codes.ctypes.data,
        None if values is None else values.ctypes.data, valid.ctypes.data,
        len(valid), scratch.ctypes.data, status.ctypes.data)
    return None if got < 0 else status


def _or(v: int, default: int) -> int:
    return default if v < 0 else v


def _read_chunk(fh, col_meta) -> Optional[np.ndarray]:
    """A column chunk's bytes, with one seek and one read."""
    start = col_meta.data_page_offset
    if col_meta.has_dictionary_page \
            and col_meta.dictionary_page_offset is not None:
        start = min(start, col_meta.dictionary_page_offset)
    fh.seek(start)
    seg = np.frombuffer(fh.read(col_meta.total_compressed_size), np.uint8)
    return seg if len(seg) == col_meta.total_compressed_size else None


def _decode_chunk(fh, col_meta, max_def: int,
                  max_rep: int) -> Optional[FastColumn]:
    """One column chunk (a seek and read from ``fh``) -> FastColumn, or
    None when some part of it is outside the decoder's scope."""
    seg = _read_chunk(fh, col_meta)
    if seg is None:
        return None
    return _decode_chunk_bytes(seg, col_meta, max_def, max_rep)


def _decode_chunk_bytes(seg: np.ndarray, col_meta,  # noqa: C901 - pages
                        max_def: int, max_rep: int) -> Optional[FastColumn]:
    """A column chunk's bytes -> FastColumn, or None.  Each data page
    decodes straight into its slice of one array of the chunk's values:
    codes (dictionary pages) or values (PLAIN pages).  With SNAPPY or no
    codec the host codec decodes the data pages in one call
    (``decode_pages``); the pages it leaves (GZIP, ZSTD, a BYTE_ARRAY
    PLAIN page, levels that are not RLE) are walked here."""
    if max_rep > 0:
        return None
    phys = col_meta.physical_type
    is_ba = phys == "BYTE_ARRAY"
    np_dt = _PHYS_NP.get(phys)
    if np_dt is None and not is_ba:
        return None
    codec = col_meta.compression
    if codec not in ("SNAPPY", "UNCOMPRESSED", "GZIP", "ZSTD"):
        return None
    n_total = col_meta.num_values
    pages = _page_headers(seg, n_total)
    if pages is None:
        return None

    dict_values = None
    codes = np.empty(n_total, np.uint32) \
        if col_meta.has_dictionary_page else None
    values = np.empty(n_total, np_dt) if np_dt is not None else None
    valid = np.ones(n_total, np.uint8)
    status = np.zeros(len(pages), np.int8)
    if codec in ("SNAPPY", "UNCOMPRESSED") and len(pages):
        status = _pages_in_c(seg, pages, codec, max_def, codes, values,
                             valid)
        if status is None:
            return None
    kinds: list = []        # (start, end, "dict" / "plain") per data page
    seen = 0
    def_bw = max(1, max_def.bit_length()) if max_def > 0 else 0

    for rec, done in zip(pages.tolist(), status.tolist()):
        ptype, body, comp_sz, uncomp_sz = rec[:4]
        if ptype < 0 or comp_sz < 0 or uncomp_sz < 0:
            return None
        if done:  # decoded by the host codec
            n_vals = rec[4] if ptype == _DATA_PAGE else rec[10]
            kinds.append((seen, seen + n_vals, "dict" if done == 1
                          else "plain"))
            seen += n_vals
            continue
        payload = seg[body:body + comp_sz]
        if ptype == _DICT_PAGE:
            if _or(rec[9], _ENC_PLAIN) not in (_ENC_PLAIN, _ENC_PLAIN_DICT):
                return None
            buf = _page_bytes(payload, uncomp_sz, codec)
            if buf is None:
                return None
            n_dict = _or(rec[8], 0)
            if is_ba:
                dict_values = _decode_byte_array_dict(buf, n_dict)
            elif len(buf) < n_dict * np_dt.itemsize:
                return None
            else:
                dict_values = np.frombuffer(buf, np_dt, count=n_dict).copy()
            if dict_values is None:
                return None
            continue
        if ptype == _DATA_PAGE:
            n_vals = rec[4]
            if n_vals < 0:
                return None
            enc = _or(rec[5], _ENC_PLAIN)
            if _or(rec[6], _ENC_RLE) != _ENC_RLE and max_def > 0:
                return None
            buf = _page_bytes(payload, uncomp_sz, codec)
            if buf is None:
                return None
            off = 0
            page_valid = None
            if max_def > 0:
                if len(buf) < 4:
                    return None
                dl_len = int(buf[:4].view("<i4")[0])
                dl = buf[4:4 + dl_len]
                off = 4 + dl_len
                if not _def_levels_all_valid(dl, def_bw, n_vals, max_def):
                    page_valid = _decode_validity(dl, def_bw, n_vals,
                                                  max_def)
                    if page_valid is None:
                        return None
        elif ptype == _DATA_PAGE_V2:
            n_vals = rec[10]
            if n_vals < 0:
                return None
            n_nulls = _or(rec[11], 0)
            enc = _or(rec[13], _ENC_PLAIN)
            dl_len = _or(rec[14], 0)
            if _or(rec[15], 0):  # repetition levels
                return None
            # v2: the levels are never compressed and precede the values
            levels = payload[:dl_len]
            if _or(rec[16], 1) and codec != "UNCOMPRESSED":
                buf = _page_bytes(payload[dl_len:], uncomp_sz - dl_len,
                                  codec)
                if buf is None:
                    return None
            else:
                buf = payload[dl_len:]
            page_valid = None
            if max_def > 0 and (
                    n_nulls or (dl_len and not _def_levels_all_valid(
                        levels, def_bw, n_vals, max_def))):
                if not dl_len:
                    # NULLs recorded without definition levels: a page
                    # that breaks the format is refused, never misread
                    return None
                page_valid = _decode_validity(levels, def_bw, n_vals,
                                              max_def)
                if page_valid is None:
                    return None
            off = 0
        else:
            return None
        if seen + n_vals > n_total:
            return None

        vals = buf[off:]
        lo, hi = seen, seen + n_vals
        # with NULLs the value stream holds the present entries only:
        # decode those, then scatter them into the page's n_vals slots
        n_present = int(page_valid.sum()) if page_valid is not None \
            else n_vals
        if enc in (_ENC_RLE_DICT, _ENC_PLAIN_DICT):
            if len(vals) < 1:
                return None
            if codes is None:
                codes = np.empty(n_total, np.uint32)
            dst = codes[lo:hi]
            if page_valid is None:
                if not _rle_decode_into(vals[1:], int(vals[0]), dst):
                    return None
            else:
                present = _rle_decode(vals[1:], int(vals[0]), n_present)
                if present is None:
                    return None
                dst[:] = 0
                dst[page_valid] = present
            kinds.append((lo, hi, "dict"))
        elif enc == _ENC_PLAIN and not is_ba:
            if len(vals) < n_present * np_dt.itemsize:
                return None
            arr = vals[:n_present * np_dt.itemsize].view(np_dt)
            dst = values[lo:hi]
            if page_valid is None:
                dst[:] = arr
            else:
                dst[:] = 0
                dst[page_valid] = arr
            kinds.append((lo, hi, "plain"))
        else:
            return None
        if page_valid is not None:
            valid[lo:hi] = page_valid
        seen = hi

    if seen != n_total or not kinds:
        return None
    validity = None if valid.all() else valid.view(bool)
    plain = any(kind == "plain" for _, _, kind in kinds)
    if not plain:  # dictionary pages only
        if dict_values is None:
            return None
        if codes.size and int(codes.max()) >= len(dict_values):
            return None
        return FastColumn(dict_values=dict_values, codes=codes,
                          validity=validity)
    if any(kind == "dict" for _, _, kind in kinds):
        # dictionary pages, then PLAIN fallback pages: materialize
        if dict_values is None or is_ba:
            return None
        for lo, hi, kind in kinds:
            if kind != "dict":
                continue
            c = codes[lo:hi]
            if c.size and int(c.max()) >= len(dict_values):
                return None
            np.take(dict_values, c, out=values[lo:hi])
    return FastColumn(values=values, validity=validity)


def _page_bytes(payload: np.ndarray, uncomp_sz: int,
                codec: str) -> Optional[np.ndarray]:
    if codec == "UNCOMPRESSED":
        return payload
    if codec == "SNAPPY":
        return _snappy_decompress(payload, uncomp_sz)
    if codec in ("GZIP", "ZSTD"):
        try:
            dec = pa.Codec(codec.lower()).decompress(
                payload.tobytes(), decompressed_size=uncomp_sz)
        except (pa.ArrowException, ValueError):
            return None
        return np.frombuffer(dec, np.uint8)
    return None


def _decode_validity(levels: np.ndarray, bw: int, n: int,
                     max_def: int) -> Optional[np.ndarray]:
    """Definition levels -> bool[n] validity (True: a value)."""
    dl = _rle_decode(levels, bw, n)
    if dl is None:
        return None
    return dl == max_def


def _def_levels_all_valid(dl: np.ndarray, bw: int, n: int,
                          max_def: int) -> bool:
    """Whether every definition level is ``max_def`` (no NULL)."""
    if n == 0:
        return True
    # the common case: one repeated run covers all n values
    h = 0
    shift = 0
    pos = 0
    complete = False
    while pos < len(dl):
        b = int(dl[pos])
        pos += 1
        h |= (b & 0x7F) << shift
        if not (b & 0x80):
            complete = True
            break
        shift += 7
    if complete and not (h & 1) and (h >> 1) >= n:
        byte_w = (bw + 7) // 8
        if pos + byte_w <= len(dl):
            v = 0
            for j in range(byte_w):
                v |= int(dl[pos + j]) << (8 * j)
            return v == max_def
    levels = _rle_decode(dl, bw, n)
    if levels is None:
        return False
    return bool((levels == max_def).all())


# -- file-level read and filter --------------------------------------- #


def read_file(path: str, keep_rgs: Sequence[int],
              columns: Sequence[str], conjuncts, engine_schema,
              pqfile=None, max_decoded_bytes: Optional[int] = None,
              runtime_filters=None,
              counters: Optional[dict] = None) -> Optional[list]:
    """Decode and filter one file -> a ``pa.Table`` of surviving rows
    per kept row group, or None when any part is outside the decoder's
    scope (the caller reads the whole file with pyarrow).

    ``conjuncts`` (may be None) are the pushed filter's AND legs, bound
    to ``engine_schema``; a leg that reads exactly one column is applied
    here (on the dictionary where the chunk has one), the rest are left
    to the caller.  ``runtime_filters`` ([(column name, RuntimeFilter)],
    may be None) are probed per dictionary value or per value; the rows
    they drop beyond the conjuncts' go to ``counters["rf_pruned"]``,
    and ``counters["rf_complete"]`` says whether every filter reached
    every row.

    Each needed chunk is read with a seek and a read, never the whole
    file, and a row group whose needed columns decode to more than
    ``max_decoded_bytes`` is refused."""
    try:
        f = pqfile if pqfile is not None else pq.ParquetFile(path)
        # a file opened with read_dictionary names its strings'
        # dictionary type: the value type is what a chunk decodes to
        arrow_types = {fl.name: fl.type.value_type
                       if pa.types.is_dictionary(fl.type) else fl.type
                       for fl in f.schema_arrow}
    except (OSError, pa.ArrowException):
        return None
    md = f.metadata
    pq_schema = md.schema
    name_to_idx = {pq_schema.column(i).path: i
                   for i in range(len(pq_schema))}
    needed = list(columns)
    filter_cols = _conjunct_columns(conjuncts, engine_schema) \
        if conjuncts else {}
    for c in filter_cols:
        if c not in needed and c in name_to_idx:
            needed.append(c)
    rfs = [(n, rf) for n, rf in (runtime_filters or [])
           if n in name_to_idx]
    if counters is not None and runtime_filters:
        # true until a filter's column is missing or some row group
        # could not apply it; the caller then probes the rows itself
        counters["rf_complete"] = len(rfs) == len(runtime_filters)
    if counters is not None and conjuncts:
        # true until a conjunct reads more than one column or some row
        # group could not apply it; the caller then filters the rows
        counters["filter_complete"] = True
    for c, _rf in rfs:
        if c not in needed:
            needed.append(c)
    if any(c not in name_to_idx for c in needed):
        return None

    out: list = []
    with open(path, "rb") as fh:
        for rg in keep_rgs:
            rg_meta = md.row_group(rg)
            if max_decoded_bytes is not None and sum(
                    rg_meta.column(name_to_idx[c]).total_uncompressed_size
                    for c in needed) > max_decoded_bytes:
                return None
            chunks = []
            for name in needed:
                ci = name_to_idx[name]
                seg = _read_chunk(fh, rg_meta.column(ci))
                if seg is None:
                    return None
                sc = pq_schema.column(ci)
                chunks.append((seg, rg_meta.column(ci),
                               sc.max_definition_level,
                               sc.max_repetition_level))
            decoded = _decode_chunks(chunks)
            if any(fc is None for fc in decoded):
                return None
            cols = dict(zip(needed, decoded))
            tbl = _filter_project(cols, filter_cols, rg_meta.num_rows,
                                  engine_schema, columns, arrow_types,
                                  runtime_filters=rfs, counters=counters,
                                  n_conjuncts=len(conjuncts or ()))
            if tbl is None:
                return None
            out.append(tbl)
    return out


#: the pool that decodes a row group's column chunks side by side, one
#: thread per host core, shared by every caller (the scan's pooled tasks
#: too, so that its threads stay bounded by the cores); made at first
#: use
_column_pool: Optional[ThreadPoolExecutor] = None
_column_pool_lock = threading.Lock()


def _shared_column_pool() -> ThreadPoolExecutor:
    global _column_pool
    with _column_pool_lock:
        if _column_pool is None:
            _column_pool = ThreadPoolExecutor(
                max_workers=os.cpu_count() or 1,
                thread_name_prefix="fastpar")
        return _column_pool


def _decode_chunks(chunks: list) -> list:
    """Each (bytes, column meta, max_def, max_rep) decoded, on the
    shared column pool: the codec's calls and numpy's loops release the
    GIL, so the columns decode side by side, as pyarrow's reader decodes
    them.  Decoding them on the calling thread instead when files decode
    side by side left cores idle on an H100 host (PERF.md)."""
    if len(chunks) <= 1:
        return [_decode_chunk_bytes(*c) for c in chunks]
    return list(_shared_column_pool().map(
        lambda c: _decode_chunk_bytes(*c), chunks))


def _eval_runtime_filter_mask(cols: dict, rfs, arrow_types: dict
                              ) -> tuple[Optional[np.ndarray], bool]:
    """(the AND of the runtime filters' keep-masks over the decoded
    chunks, complete): a dictionary chunk probes its dictionary once
    and gathers by code, a plain chunk probes its values.  ``complete``
    is True only when EVERY filter gave a mask; the mask is None when
    none did."""
    mask = None
    complete = True
    for name, rf in rfs:
        fc = cols.get(name)
        if fc is None:
            return None, False  # a partial mask would miscount
        want = arrow_types.get(name)
        if want is not None and pa.types.is_timestamp(want) \
                and want.unit != "us":
            complete = False  # its values are not microseconds
            continue
        if fc.codes is not None:
            dv = fc.dict_values
            if not (isinstance(dv, np.ndarray)
                    and np.issubdtype(dv.dtype, np.integer)):
                complete = False
                continue
            m = rf.probe_host(dv.astype(np.int64))[fc.codes]
            if fc.validity is not None:
                m = np.where(fc.validity, m, False)
        else:
            vals = fc.values
            if not np.issubdtype(vals.dtype, np.integer):
                complete = False
                continue
            m = rf.probe_host(vals.astype(np.int64), fc.validity)
        mask = m if mask is None else mask & m
    return mask, complete


def _filter_project(cols: dict, filter_cols: dict, n_rows: int,
                    engine_schema, columns, arrow_types,
                    runtime_filters=(), counters: Optional[dict] = None,
                    n_conjuncts: int = 0) -> Optional[pa.Table]:
    """The surviving rows of one row group's ``columns``: dictionary
    chunks as ``pa.DictionaryArray`` (whatever the dictionary's size),
    the rest materialized for the kept rows only."""
    mask, applied = _eval_filter_mask(cols, filter_cols, n_rows,
                                      engine_schema, arrow_types)
    if counters is not None and applied < n_conjuncts:
        counters["filter_complete"] = False
    if runtime_filters:
        rf_mask, rf_complete = _eval_runtime_filter_mask(
            cols, runtime_filters, arrow_types)
        if counters is not None and not rf_complete:
            counters["rf_complete"] = False
        if rf_mask is not None:
            base = mask if mask is not None else np.ones(n_rows, bool)
            rf_pruned = int((base & ~rf_mask).sum())
            if counters is not None and rf_pruned:
                counters["rf_pruned"] = counters.get("rf_pruned", 0) \
                    + rf_pruned
            mask = base & rf_mask
    idx = None
    if mask is not None:
        idx = np.flatnonzero(mask)
        if idx.size == n_rows:
            idx = None

    def kept(a: np.ndarray) -> np.ndarray:
        return a if idx is None else np.take(a, idx)

    arrays = []
    for name in columns:
        fc = cols[name]
        validity = None if fc.validity is None else kept(fc.validity)
        null_mask = None if validity is None else ~validity
        want = arrow_types.get(name)
        if fc.codes is not None:
            # codes are below the dictionary's length: int32 as they are
            codes = kept(fc.codes).view(np.int32)
            dvals = fc.dict_values
            if not isinstance(dvals, pa.Array):
                dvals = _logical(dvals, want)  # the small dictionary side
                if dvals is None:
                    return None
            try:
                if want is not None and dvals.type != want:
                    dvals = dvals.cast(want)
            except (pa.ArrowException, ValueError):
                return None
            arrays.append(pa.DictionaryArray.from_arrays(
                pa.array(codes, mask=null_mask), dvals))
            continue
        arr = _logical(kept(fc.values), want, null_mask)
        if arr is None:
            return None
        arrays.append(arr)
    return pa.Table.from_arrays(arrays, list(columns))


def _logical(vals: np.ndarray, want, null_mask=None) -> Optional[pa.Array]:
    """A chunk's physical values as its logical Arrow type ``want``, by
    reinterpretation, never by a value cast: an INT32 or INT64 decimal
    holds its unscaled digits (decimal128's low word, the high word its
    sign), an INT64 timestamp its count of the column's unit, an INT32
    date its day number, an INT32 TINYINT or SMALLINT its value.  None
    when the pair is outside the decoder's scope (the file goes to
    pyarrow)."""
    kind = vals.dtype.kind
    if want is None:
        return pa.array(vals, mask=null_mask)
    if pa.types.is_decimal(want):
        if kind != "i" or want.precision > 18:
            return None
        v = vals.astype(np.int64, copy=False)
        words = np.empty((len(v), 2), np.int64)
        words[:, 0] = v
        words[:, 1] = v >> 63
        bitmap = None if null_mask is None else pa.py_buffer(
            np.packbits(~null_mask, bitorder="little"))
        return pa.Array.from_buffers(
            pa.decimal128(want.precision, want.scale), len(v),
            [bitmap, pa.py_buffer(words)])
    if pa.types.is_timestamp(want) or pa.types.is_date32(want):
        width = 8 if pa.types.is_timestamp(want) else 4
        if kind != "i" or vals.dtype.itemsize != width:
            return None
        return pa.array(vals, mask=null_mask).view(want)
    if pa.types.is_int8(want) or pa.types.is_int16(want):
        if kind != "i":
            return None
        return pa.array(vals.astype(want.to_pandas_dtype()),
                        mask=null_mask)
    arr = pa.array(vals, mask=null_mask)
    return arr if arr.type == want else None


def _conjunct_columns(conjuncts, engine_schema) -> dict:
    """{column name: [the conjuncts that read only that column]}."""
    by_col: dict = {}
    for conj in conjuncts:
        refs = set()
        stack = [conj]
        while stack:
            e = stack.pop()
            if isinstance(e, B.ColumnReference):
                refs.add(e.col_name)
            elif isinstance(e, B.BoundReference):
                refs.add(engine_schema.fields[e.ordinal].name)
            stack.extend(e.children)
        if len(refs) == 1:
            by_col.setdefault(next(iter(refs)), []).append(conj)
    return by_col


def _eval_table(name: str, values: pa.Array, engine_schema) -> pa.Table:
    """A table a bound conjunct can be evaluated on: ``values`` at the
    column's position in ``engine_schema``, NULLs elsewhere."""
    if engine_schema is None:
        return pa.table({name: values})
    return pa.Table.from_arrays(
        [values if f.name == name else pa.nulls(len(values), values.type)
         for f in engine_schema.fields],
        engine_schema.names)


def _as_bool(res, n: int) -> np.ndarray:
    if isinstance(res, pa.ChunkedArray):
        res = res.combine_chunks()
    if isinstance(res, pa.Scalar):
        return np.full(n, bool(res.as_py()))
    return np.asarray(pc.fill_null(res, False)).astype(bool)


def _filter_values(vals: np.ndarray, want, null_mask=None) -> pa.Array:
    """A chunk's values as a conjunct reads them: physical, as the
    compiled comparisons take a DATE's day numbers and a DECIMAL's
    unscaled digits, except a TIMESTAMP, whose unit the comparison
    must know."""
    if want is not None and pa.types.is_timestamp(want):
        arr = _logical(vals, want, null_mask)
        if arr is not None:
            return arr
    return pa.array(vals, mask=null_mask)


def _eval_filter_mask(cols: dict, filter_cols: dict, n_rows: int,
                      engine_schema, arrow_types: dict
                      ) -> tuple[Optional[np.ndarray], int]:
    """(the AND of every single-column conjunct's mask, None to keep
    all; how many conjuncts it applied).
    A dictionary column ANDs its conjuncts' LUTs (and their results on
    a NULL input) first, then gathers once.  A conjunct that does not
    compile, or fails on these values, is left to the caller (the
    result stays a superset, never wrong)."""
    mask, applied = None, 0
    for name, conjs in filter_cols.items():
        fc = cols.get(name)
        if fc is None:
            continue
        fns = [fn for fn in map(compile_filter, conjs) if fn is not None]
        want = arrow_types.get(name)
        if fc.codes is not None:
            dv = fc.dict_values
            dv = dv if isinstance(dv, pa.Array) else _filter_values(dv, want)
            values = _eval_table(name, dv, engine_schema)
            nulls = _eval_table(name, pa.nulls(1, dv.type), engine_schema)
            lut, keep_null, used = np.ones(len(dv), bool), True, False
            for fn in fns:
                try:
                    one = _as_bool(fn(values), len(dv))
                    # a NULL row takes the conjunct's NULL-input result
                    one_null = bool(_as_bool(fn(nulls), 1)[0])
                except (pa.ArrowException, TypeError, ValueError):
                    continue
                lut &= one
                keep_null &= one_null
                used = True
                applied += 1
            if not used:
                continue
            m = lut[fc.codes]
            if fc.validity is not None:
                m = np.where(fc.validity, m, keep_null)
            mask = m if mask is None else mask & m
            continue
        arr = _filter_values(fc.values, want, None
                             if fc.validity is None else ~fc.validity)
        table = _eval_table(name, arr, engine_schema)
        for fn in fns:
            try:
                m = _as_bool(fn(table), len(arr))
            except (pa.ArrowException, TypeError, ValueError):
                continue
            mask = m if mask is None else mask & m
            applied += 1
    return mask, applied
