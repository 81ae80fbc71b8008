"""The wire path of an upload: host encode, one copy, device decode.

Counterpart of ``spark_rapids_tpu/columnar/transfer.py``.  With
``spark.rapids.tpu.sql.scan.packedUpload`` on, the scan's stage thread
re-encodes each decoded batch into a compact wire form
(:func:`encode_for_device`):

- integers bias-packed to uint8 / uint16 from the batch's minimum, a
  64-bit integer with a 32-bit range to uint32;
- low-cardinality floats and strings as dictionaries (codes and
  values), a Parquet dictionary column straight from its dictionary;
- doubles that hold two decimals as int32 cents;
- raw bytes otherwise, and no bytes at all for an all-NULL column or an
  all-valid column's validity.

With ``sql.wireCompression.enabled`` each data component may also ride
packed by a codec of ``columnar/compression/`` (``wire.compress``).
The components and the plan that says how to read them are the JAX
encoder's, byte for byte, for a batch its encoder does not pad.

The upload packs every component into one pinned buffer from the CUDA
caching host allocator, each at an offset aligned to its dtype, and
issues one ``non_blocking`` copy of it on the scan's upload stream
(:func:`upload_staged`, behind the ``transfer.upload`` fault seam: a
retryable failure re-issues the copy from the staged buffer).  The
consumer's stream waits for the copy's event, records the one device
buffer on itself, and :func:`decode_on_device` rebuilds the columns
there from typed views of it (K3, ``_make_decode`` in the JAX file):
gathers for dictionaries, adds for bias, ``/ 100.0`` for cents (a true
IEEE division by a device tensor, the division the host encoder
verified: a CPU scalar divisor lets CUDA multiply by its reciprocal),
and each codec's decompress (``wire.decompress``).  The decode is
plain torch; a hand-written kernel is later work (ROADMAP §2).

What differs from the JAX module:

- no wire-row buckets: a port batch holds exactly its live rows, so the
  encoder takes ``n`` rows and the decode returns ``n`` (JAX pads to at
  most 8 wire lengths a capacity and carries the live count as a device
  scalar, for XLA's compile cache).  The plan's capacity and wire rows
  are both ``n``; the live-count component still rides, as in JAX;
- no buffer donation, so no ``ConsumedBatchError``, ``run_consuming``,
  ``memo_is_dead`` or ``repair_donated_memo``: a torch op frees its
  inputs when their last reference goes (``execs/jit_cache.py``);
- the encoded form lives only between ``stage_upload`` and
  ``finish_upload`` (``columnar/arrow.py``): no exec receives an
  ``EncodedBatch``; the fused consumers that decode one inside their own
  program come with the fused chains (ROADMAP item 9.1);
- the encoder writes the port's physical values (timestamps in
  microseconds, as the plain upload does), and it takes exactly the
  types it has a wire form for: BOOLEAN, the integers, FLOAT, DOUBLE,
  DATE, TIMESTAMP and STRING.  A schema with any other type (DECIMAL,
  NULL, the nested types) uploads plain, chosen from the schema before
  any copy; so does an empty batch, as in JAX.

The host passes that dominate the encode (the chars matrix, min / max,
the bias packs, the cents check) run in ``native/hostcodec.cpp``; their
numpy forms stay here (``use_native=False``) for the tests to hold the C++
against.  ``upload_stats`` and the codec stats are updated from the
scan's stage threads at once, under locks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch import trace as _trace
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import compression as WC
from spark_rapids_tpu_torch.columnar.column import (
    AnyColumn,
    Column,
    StringColumn,
)
from spark_rapids_tpu_torch.columnar.compression.codecs import (
    storage_dtype,
    widen,
)

#: the types with a wire form; a schema with any other uploads plain
WIRE_TYPES = (T.BooleanType, T.IntegralType, T.FractionalType, T.DateType,
              T.TimestampType, T.StringType)

# -- the upload counters ------------------------------------------------ #

_upload_lock = threading.Lock()
_UPLOAD_STATS = dict.fromkeys(("batches", "wire_bytes", "copies",
                               "plain_batches", "plain_bytes",
                               "plain_copies"), 0)


def upload_stats() -> dict:
    """Bytes and copies to the device per path: ``batches``,
    ``wire_bytes`` (a compressed component counts its packed size) and
    ``copies`` of the wire path; ``plain_*`` the same of the plain
    path (one copy a tensor)."""
    with _upload_lock:
        return dict(_UPLOAD_STATS)


def reset_upload_stats() -> None:
    with _upload_lock:
        for k in _UPLOAD_STATS:
            _UPLOAD_STATS[k] = 0


def note_plain_upload(nbytes: int, copies: int) -> None:
    """Count one batch uploaded on the plain path."""
    with _upload_lock:
        _UPLOAD_STATS["plain_batches"] += 1
        _UPLOAD_STATS["plain_bytes"] += int(nbytes)
        _UPLOAD_STATS["plain_copies"] += int(copies)


@dataclasses.dataclass(frozen=True)
class WirePolicy:
    """How a session's uploads take the wire path: ``codecs`` is
    ``compression.wire_codec_config``'s tuple, None for an uncompressed
    wire."""

    codecs: Optional[tuple] = None

    @classmethod
    def from_conf(cls, conf) -> Optional["WirePolicy"]:
        """None (the plain path) with ``sql.scan.packedUpload`` off.
        Read on the session's thread, as the scan's other keys are."""
        from spark_rapids_tpu_torch import config as C

        if not conf.get(C.PACKED_UPLOAD):
            return None
        return cls(WC.wire_codec_config(conf))


def takes_schema(schema: T.Schema) -> bool:
    """Whether every column has a wire form (the choice of path, made
    before any copy)."""
    return all(isinstance(f.dtype, WIRE_TYPES) for f in schema.fields)


# -- host encoding ------------------------------------------------------- #

_INT_KINDS = "iu"
#: the JAX package's string width buckets (``columnar/column.py``)
_WIDTH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def pad_capacity(n: int) -> int:
    """The JAX package's capacity bucket (its default ``pow2`` policy,
    at least 8): the padded size of a dictionary on the wire."""
    c = 8
    while c < n:
        c <<= 1
    return c


def pad_width(w: int) -> int:
    for b in _WIDTH_BUCKETS:
        if w <= b:
            return b
    return ((w + 4095) // 4096) * 4096


def _host_fixed(arr: pa.Array, dtype: T.DataType
                ) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """One fixed-width array -> (the port's physical values, NULL slots
    zeroed; its validity, or None when it has no NULL)."""
    from spark_rapids_tpu_torch.columnar.arrow import (
        _fill_values,
        _numpy_dtype,
    )

    n = len(arr)
    validity = np.asarray(arr.is_valid()) if arr.null_count else None
    vals = np.zeros(n, _numpy_dtype(dtype))
    if n and not pa.types.is_null(arr.type):
        _fill_values(arr, vals)
        if validity is not None:
            vals[~validity] = 0
    return vals, validity


def _sample_low_cardinality(vals: np.ndarray, limit: int = 1024) -> bool:
    """Does a strided sample look low-cardinality?"""
    n = len(vals)
    if n <= 8192:
        return True
    s = vals[:: max(1, n // 4096)]
    return len(np.unique(s)) <= min(limit, len(s) // 2)


def _try_dict(vals: np.ndarray) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """(codes, values) when dictionary encoding pays, else None.  A
    float dictionary is refused when it would hold NaN (payload bits
    would not round-trip) or would lose a -0.0 (Arrow's
    ``dictionary_encode`` unifies it with 0.0)."""
    if vals.dtype.kind == "f" and np.isnan(vals).any():
        return None
    if not _sample_low_cardinality(vals):
        return None
    d = pa.array(vals).dictionary_encode()
    nvals = len(d.dictionary)
    if nvals > 0xFFFF or nvals * 2 > max(len(vals), 1):
        return None
    codes = d.indices.to_numpy(zero_copy_only=False)
    values = d.dictionary.to_numpy(zero_copy_only=False).astype(
        vals.dtype, copy=False)
    if vals.dtype.kind == "f":
        bits = np.int32 if vals.dtype.itemsize == 4 else np.int64
        if not np.array_equal(values[codes].view(bits), vals.view(bits)):
            return None
    return codes, values


def scaled_encode(vals: np.ndarray, use_native: bool = True
                  ) -> Optional[np.ndarray]:
    """int32 cents of doubles that entered as two-decimal values, when
    EVERY one rebuilds bit for bit as ``cents / 100.0``; else None."""
    if len(vals) == 0:
        return None
    if use_native:
        v = np.ascontiguousarray(vals, np.float64)
        out = np.empty(len(v), np.int32)
        ok = native.load().scaled_check_encode(v.ctypes.data, len(v),
                                               out.ctypes.data)
        return out if ok else None
    if not np.isfinite(vals).all():
        return None
    s = np.rint(vals * 100.0)
    if (np.abs(s) >= 2**31).any():
        return None
    s32 = s.astype(np.int32)
    r = s32.astype(np.float64) / 100.0
    if not np.array_equal(r.view(np.int64), vals.view(np.int64)):
        return None
    return s32


def int_range(vals: np.ndarray, use_native: bool = True):
    """(min, range, encode8, encode16) of an integer column: the host
    codec's one-pass scans and packs for int32 / int64, numpy
    otherwise."""
    phys = vals.dtype
    if use_native and phys in (np.dtype(np.int64), np.dtype(np.int32)):
        lib = native.load()
        v = np.ascontiguousarray(vals)
        mnb = np.empty(1, np.int64)
        mxb = np.empty(1, np.int64)
        scan = lib.minmax_i64 if phys.itemsize == 8 else lib.minmax_i32
        scan(v.ctypes.data, len(v), mnb.ctypes.data, mxb.ctypes.data)
        mn = int(mnb[0])
        e8 = lib.bias_encode8_i64 if phys.itemsize == 8 \
            else lib.bias_encode8_i32
        e16 = lib.bias_encode16_i64 if phys.itemsize == 8 \
            else lib.bias_encode16_i32

        def enc(x, base, f, dt):
            x = np.ascontiguousarray(x)
            out = np.empty(len(x), dt)
            f(x.ctypes.data, len(x), base, out.ctypes.data)
            return out

        return (mn, int(mxb[0]) - mn,
                lambda x, b: enc(x, b, e8, np.uint8),
                lambda x, b: enc(x, b, e16, np.uint16))
    mn = int(vals.min())
    rng = int(vals.max()) - mn

    def enc8_np(x, base):
        return (x.astype(np.int64) - base).astype(np.uint8)

    def enc16_np(x, base):
        return (x.astype(np.int64) - base).astype(np.uint16)

    return mn, rng, enc8_np, enc16_np


def _padded(a: np.ndarray, rows: int) -> np.ndarray:
    """Zero-pad a per-row array to ``rows`` rows (a dictionary to its
    capacity bucket, as on the JAX wire)."""
    if len(a) == rows:
        return np.ascontiguousarray(a)
    out = np.zeros((rows,) + a.shape[1:], a.dtype)
    out[: len(a)] = a
    return out


class _Comps:
    """The component list of one batch.  ``add`` returns the ref the
    plan stores; ``add_wire`` is the data-plane form: with compression
    configured it routes the component through the codec chooser and
    returns a ``("comp", codec, refs, meta, dtype, shape)`` ref, and
    with compression off it is ``add``, so the wire is byte for byte
    the uncompressed one."""

    def __init__(self, wire_cfg: Optional[tuple] = None):
        self.arrays: list[np.ndarray] = []
        self.wire_cfg = wire_cfg

    def add(self, a: np.ndarray):
        self.arrays.append(np.ascontiguousarray(a))
        return ("arr", len(self.arrays) - 1)

    def add_wire(self, a: np.ndarray):
        a = np.ascontiguousarray(a)
        if self.wire_cfg is not None:
            with _trace.span("wire.compress", nbytes=a.nbytes,
                             dtype=str(a.dtype)):
                enc = WC.choose_and_encode(a.reshape(-1), *self.wire_cfg)
            if enc is not None:
                name, arrays, meta = enc
                refs = tuple(self.add(x) for x in arrays)
                return ("comp", name, refs, meta, str(a.dtype), a.shape)
        return self.add(a)


def encode_for_device(arrays: Sequence, schema: T.Schema, n: int,
                      wire_cfg: Optional[tuple] = None,
                      use_native: bool = True
                      ) -> Optional[tuple[list, tuple]]:
    """Decoded host Arrow columns -> (components, plan), or None when
    the schema has a type without a wire form or the batch is empty.
    ``wire_cfg``: ``compression.wire_codec_config``'s tuple, or None
    for no compression."""
    if n == 0 or not takes_schema(schema):
        return None
    comps = _Comps(wire_cfg)
    n_ref = comps.add(np.asarray(n, np.int32))  # the live row count
    entries: list[tuple] = []
    for arr, f in zip(arrays, schema.fields):
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        if isinstance(arr, pa.DictionaryArray):
            # straight from the Parquet dictionary: codes and values,
            # no re-encode, and a string column never materialized
            e = _encode_dict_direct(comps, arr, f.dtype, n, use_native)
            if e is not None:
                entries.append(e)
                continue
            arr = arr.cast(arr.type.value_type)
        if isinstance(f.dtype, T.StringType):
            entries.append(_encode_string(comps, arr, n, use_native))
            continue
        vals, validity = _host_fixed(arr, f.dtype)
        if validity is not None and not validity.any():
            # all NULL: nothing crosses the wire
            entries.append(("fixed", "null", -1, str(vals.dtype), (),
                            None, None))
            continue
        vref = comps.add_wire(validity) if validity is not None else None
        phys = vals.dtype
        kind = "raw"
        extra: tuple = ()
        dict_n = None
        if phys.kind in _INT_KINDS and phys.itemsize > 1:
            mn, rng, enc8, enc16 = int_range(vals, use_native)
            if rng <= 0xFF:
                kind = "bias"
                extra = (comps.add(np.asarray(mn, np.int64)),)
                vals = enc8(vals, mn)
            elif phys.itemsize > 2 and rng <= 0xFFFF:
                kind = "bias"
                extra = (comps.add(np.asarray(mn, np.int64)),)
                vals = enc16(vals, mn)
            elif phys.itemsize > 4 and rng <= 0xFFFFFFFF:
                # 64-bit keys with a 32-bit range: base + zero-extended
                # u32 round-trips exactly
                kind = "bias"
                extra = (comps.add(np.asarray(mn, np.int64)),)
                vals = (vals - mn).astype(np.uint32)
        elif phys.kind == "f":
            enc = _try_dict(vals)
            if enc is not None:
                codes, dvals = enc
                code_dt = np.uint8 if len(dvals) <= 0x100 else np.uint16
                nvp = max(8, pad_capacity(len(dvals)))
                kind = "dict"
                dict_n = _dict_len_bound(len(dvals), nvp)
                extra = (comps.add_wire(_padded(dvals, nvp)),)
                vals = codes.astype(code_dt)
            elif phys.itemsize == 8:
                scaled = scaled_encode(vals, use_native)
                if scaled is not None:
                    kind = "scaled"
                    # the divisor rides as a component: the decode
                    # divides by a device tensor, never by a literal
                    extra = (comps.add(np.asarray(100.0, np.float64)),)
                    vals = scaled
        dref = comps.add_wire(vals)
        entries.append(("fixed", kind, dref, str(phys), extra, vref, dict_n))
    return comps.arrays, (n, n, n_ref, tuple(entries))


def _dict_len_bound(n: int, nvp: int) -> int:
    """The JAX plan's bound on a dictionary's entry count: a multiple
    of 16 (at least 8) within the padded capacity."""
    return min(nvp, max(8, -(-n // 16) * 16))


def _encode_dict_direct(comps: _Comps, arr: pa.DictionaryArray,
                        dtype: T.DataType, n: int,
                        use_native: bool) -> Optional[tuple]:
    """A dictionary-encoded column -> a dict / sdict entry, trusting
    its dictionary (the values came from it, so the round trip is exact
    by construction); None: no dictionary wire form for it."""
    dvals = arr.dictionary
    nvals = len(dvals)
    if nvals > 0xFFFF or dvals.null_count:
        # a NULL inside the dictionary hides row NULLs from is_valid():
        # the plain form decodes through the value type and keeps them
        return None
    validity = np.asarray(arr.is_valid()) if arr.null_count else None
    codes = arr.indices.to_numpy(zero_copy_only=False)
    if validity is not None:
        codes = np.where(validity, codes, 0)
    if isinstance(dtype, T.StringType):
        return _sdict_entry(comps, codes, dvals, validity, n, use_native)
    dnp, dvalid = _host_fixed(dvals, dtype)
    if dvalid is not None:
        return None
    code_dt = np.uint8 if nvals <= 0x100 else np.uint16
    nvp = max(8, pad_capacity(max(nvals, 1)))
    vref = comps.add_wire(validity) if validity is not None else None
    cref = comps.add_wire(codes.astype(code_dt))
    extra = (comps.add_wire(_padded(dnp, nvp)),)
    return ("fixed", "dict", cref, str(dnp.dtype), extra, vref,
            _dict_len_bound(nvals, nvp))


def _sdict_entry(comps: _Comps, codes: np.ndarray, dvals: pa.Array,
                 validity: Optional[np.ndarray], n: int,
                 use_native: bool) -> Optional[tuple]:
    """One string-dictionary entry; None when the dictionary exceeds
    the wire's uint16 count or length."""
    nvals = len(dvals)
    if nvals > 0xFFFF:
        return None
    dchars, dlens = chars_matrix(dvals.cast(pa.large_string()),
                                 use_native=use_native)
    if dlens.size and int(dlens.max()) > 0xFFFF:
        return None
    code_dt = np.uint8 if nvals <= 0x100 else np.uint16
    nvp = max(8, pad_capacity(max(nvals, 1)))
    vref = comps.add_wire(validity) if validity is not None else None
    cref = comps.add_wire(codes.astype(code_dt))
    dcref = comps.add_wire(_padded(dchars, nvp))
    dlref = comps.add_wire(_padded(dlens.astype(np.uint16), nvp))
    return ("sdict", cref, dcref, dlref, vref, _dict_len_bound(nvals, nvp))


def _encode_string(comps: _Comps, arr: pa.Array, n: int,
                   use_native: bool) -> tuple:
    """One plain string column's entry: a dictionary when it pays,
    else the raw chars matrix and lengths."""
    sarr = arr.cast(pa.large_string())
    offsets = np.frombuffer(sarr.buffers()[1], dtype=np.int64,
                            count=n + 1, offset=sarr.offset * 8)
    validity = np.asarray(arr.is_valid()) if arr.null_count else None
    lens = (offsets[1:] - offsets[:-1]).astype(np.int32)
    if validity is not None:
        lens = np.where(validity, lens, 0).astype(np.int32)
    if _string_dict_gate(sarr):
        d = sarr.dictionary_encode()
        dvals = d.dictionary
        if len(dvals) * 2 <= max(n, 1) and not dvals.null_count:
            codes = d.indices.to_numpy(zero_copy_only=False)
            if validity is not None:
                codes = np.where(validity, codes, 0)
            e = _sdict_entry(comps, codes, dvals, validity, n, use_native)
            if e is not None:
                return e
            # values of 64 KiB or more would wrap the uint16 length
    vref = comps.add_wire(validity) if validity is not None else None
    chars, _ = chars_matrix(sarr, lens, use_native)
    cref = comps.add_wire(chars)
    len_dt = np.uint16 if (not lens.size or int(lens.max()) <= 0xFFFF) \
        else np.int32
    lref = comps.add_wire(lens.astype(len_dt))
    return ("sraw", cref, lref, vref)


def _string_dict_gate(sarr: pa.Array) -> bool:
    """Does the column's head look low-cardinality enough to try a
    dictionary?"""
    if len(sarr) <= 8192:
        return True
    return len(sarr.slice(0, 4096).dictionary_encode().dictionary) <= 1024


def chars_matrix(sarr: pa.Array, lens: Optional[np.ndarray] = None,
                 use_native: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """A large_string array -> (chars[n, w] zero-padded, w its JAX width
    bucket; lengths[n]).  NUL bytes inside a value are kept."""
    n = len(sarr)
    offsets = np.frombuffer(sarr.buffers()[1], dtype=np.int64,
                            count=n + 1, offset=sarr.offset * 8)
    data_buf = sarr.buffers()[2]
    raw = (np.frombuffer(data_buf, dtype=np.uint8)
           if data_buf is not None else np.zeros(1, np.uint8))
    if lens is None:
        lens = (offsets[1:] - offsets[:-1]).astype(np.int32)
    maxw = int(lens.max()) if n else 0
    w = pad_width(max(maxw, 1))
    if n == 0:
        return np.zeros((0, w), np.uint8), lens
    if use_native:
        chars = np.zeros((n, w), np.uint8)
        off = np.ascontiguousarray(offsets)
        cl = np.ascontiguousarray(np.minimum(lens, w).astype(np.int32))
        rb = np.ascontiguousarray(raw)
        native.load().chars_fill(rb.ctypes.data, off.ctypes.data,
                                 cl.ctypes.data, n, w, chars.ctypes.data)
        return chars, lens
    idx = offsets[:-1, None] + np.arange(w)[None, :]
    mask = np.arange(w)[None, :] < lens[:, None]
    safe = np.clip(idx, 0, max(len(raw) - 1, 0))
    chars = np.where(mask, raw[safe], 0).astype(np.uint8)
    return chars, lens


# -- the one buffer and the one copy ------------------------------------- #


def layout(comps: Sequence[np.ndarray]) -> tuple[int, tuple]:
    """(total bytes, ((offset, shape, dtype), ...)): each component at
    an offset aligned to its dtype's size."""
    total = 0
    out = []
    for a in comps:
        align = a.dtype.itemsize
        total = -(-total // align) * align
        out.append((total, a.shape, a.dtype.str))
        total += a.nbytes
    return total, tuple(out)


def fill(buf: torch.Tensor, comps: Sequence[np.ndarray],
         lay: tuple) -> None:
    """Copy each component into the staged host buffer at its offset."""
    flat = buf.numpy()
    for a, (off, _shape, _dt) in zip(comps, lay):
        flat[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)


def upload_staged(buf: torch.Tensor, device: torch.device, n_comps: int,
                  stream=None) -> torch.Tensor:
    """THE copy of a staged buffer to ``device`` (``non_blocking`` on
    ``stream``, a ``torch.cuda.Stream``; None: the current stream),
    behind the ``transfer.upload`` fault seam: a retryable failure
    spills what the store can (on the caller's stream, not the copy's)
    and re-issues the copy from the same staged buffer once; a second
    failure propagates."""
    from spark_rapids_tpu_torch.execs.retry import absorb_once
    from spark_rapids_tpu_torch.robustness import faults as _faults

    def attempt():
        _faults.fault_point("transfer.upload", n_comps=n_comps)
        if device.type != "cuda":
            return buf.to(device)
        with torch.cuda.device(device), (
                torch.cuda.stream(stream) if stream is not None
                else contextlib.nullcontext()):
            return buf.to(device, non_blocking=True)

    out = absorb_once(attempt, action="upload_retry")
    with _upload_lock:
        _UPLOAD_STATS["batches"] += 1
        _UPLOAD_STATS["wire_bytes"] += int(buf.numel())
        _UPLOAD_STATS["copies"] += 1
    return out


# -- the device decode (K3) ---------------------------------------------- #


def _views(buf: torch.Tensor, lay: tuple) -> list[torch.Tensor]:
    """Typed views of the uploaded buffer, one a component."""
    out = []
    for off, shape, dt in lay:
        dt = np.dtype(dt)
        count = int(np.prod(shape, dtype=np.int64))
        t = buf[off:off + count * dt.itemsize].view(storage_dtype(dt))
        out.append(t.reshape(shape))
    return out


def _make_decode(plan: tuple):
    """The decode of one plan: component views -> per column its
    tensors, as the JAX program returns them (a dict column with its
    codes and padded dictionary, an sdict column with its codes and
    dictionary chars and lengths)."""
    _cap, n, _n_ref, entries = plan

    def decode(xs: list[torch.Tensor], dts: list[np.dtype]) -> list:
        dev = xs[0].device if xs else torch.device("cpu")

        def read(ref) -> tuple[torch.Tensor, np.dtype]:
            if ref[0] == "arr":
                return xs[ref[1]], dts[ref[1]]
            _, name, refs, meta, dt, shape = ref
            out = WC.get_codec(name).decode_array(
                [xs[r[1]] for r in refs], meta, np.dtype(dt))
            return (out.reshape(shape) if len(shape) > 1 else out,
                    np.dtype(dt))

        def validity_of(vref) -> torch.Tensor:
            if vref is None:
                return torch.ones(n, dtype=torch.bool, device=dev)
            return read(vref)[0]

        def scalar(ref) -> torch.Tensor:
            # a (1,) device tensor: never a CPU scalar, so an op with
            # it stays elementwise (CUDA multiplies by the reciprocal
            # of a CPU scalar divisor)
            return read(ref)[0].reshape(1)

        out = []
        for e in entries:
            if e[0] == "fixed":
                _, kind, dref, physdt, extra, vref, _dict_n = e
                phys = storage_dtype(np.dtype(physdt))
                if kind == "null":
                    out.append((torch.zeros(n, dtype=phys, device=dev),
                                torch.zeros(n, dtype=torch.bool,
                                            device=dev)))
                    continue
                vals, vdt = read(dref)
                if kind == "bias":
                    vals = (widen(vals, vdt) + scalar(extra[0])).to(phys)
                elif kind == "dict":
                    codes = widen(vals, vdt)
                    dvals = read(extra[0])[0]
                    v = validity_of(vref)
                    vals = dvals[codes]
                    if vref is not None:
                        # NULL slots hold 0, as on the plain path (JAX
                        # leaves the first entry there)
                        vals = torch.where(v, vals, torch.zeros_like(vals))
                    out.append((vals, v, codes.to(torch.int32), dvals))
                    continue
                elif kind == "scaled":
                    vals = vals.to(phys) / scalar(extra[0])
                out.append((vals, validity_of(vref)))
            elif e[0] == "sraw":
                _, cref, lref, vref = e
                v = validity_of(vref)
                lens, ldt = read(lref)
                out.append((read(cref)[0],
                            widen(lens, ldt).to(torch.int32)
                            * v.to(torch.int32), v))
            else:  # sdict
                _, cref, dcref, dlref, vref, _dict_n = e
                c, cdt = read(cref)
                codes = widen(c, cdt)
                v = validity_of(vref)
                dchars = read(dcref)[0]
                dl, dldt = read(dlref)
                dlens = widen(dl, dldt).to(torch.int32)
                # chars are zero on NULL rows, as every string kernel
                # expects (a gathered dict[0] would break comparators)
                chars = dchars[codes] * v[:, None].to(torch.uint8)
                lens = dlens[codes] * v.to(torch.int32)
                out.append((chars, lens, v, codes.to(torch.int32), dchars,
                            dlens))
        return out

    return decode


def _wrap_cols(parts: list, schema: T.Schema) -> list[AnyColumn]:
    """Decoded tensors -> the port's columns, dictionary sidecars
    kept (the coded group-by reads them)."""
    cols: list[AnyColumn] = []
    for f, p in zip(schema.fields, parts):
        if isinstance(f.dtype, T.StringType):
            if len(p) == 6:
                chars, lens, valid, codes, dchars, dlens = p
                cols.append(StringColumn(chars, lens, valid, f.dtype, codes,
                                         dchars, dlens))
            else:
                cols.append(StringColumn(*p))
        elif len(p) == 4:
            data, valid, codes, dvals = p
            cols.append(Column(data, valid, f.dtype, codes, dvals))
        else:
            cols.append(Column(p[0], p[1], f.dtype))
    return cols


def plan_codecs(plan: tuple) -> tuple:
    """The codec names of a plan's compressed refs (empty when it is
    uncompressed)."""
    names = []
    for e in plan[3]:
        for ref in e:
            if isinstance(ref, tuple) and ref and ref[0] == "comp":
                names.append(ref[1])
            elif isinstance(ref, tuple) and ref and \
                    isinstance(ref[0], tuple):  # an extra refs tuple
                names.extend(r[1] for r in ref if r[0] == "comp")
    return tuple(names)


def _record_decompress(names: tuple) -> None:
    for name in set(names):
        WC.record_decompress(name, names.count(name))


def decode_on_device(buf: torch.Tensor, lay: tuple, plan: tuple,
                     schema: T.Schema) -> list[AnyColumn]:
    """K3: the uploaded buffer's components -> the batch's columns, on
    the current stream.  With the device ledger on, the decode
    dispatches under the program key ``("wire.decode", ...)`` (op
    ``WireDecode``), which leaves out each dictionary's entry bound, so
    row groups that differ only there share it."""
    from spark_rapids_tpu_torch.trace import ledger as _ledger

    dts = [np.dtype(dt) for _off, _shape, dt in lay]
    decode = _make_decode(plan)

    def fn(b: torch.Tensor) -> list:
        return decode(_views(b, lay), dts)

    if _ledger.LEDGER.enabled:
        from spark_rapids_tpu_torch.execs.jit_cache import cached_program

        key = ("wire.decode",) + (tuple(
            e[:-1] if e[0] in ("fixed", "sdict") else e for e in plan[3]),)
        fn = cached_program(key, fn, op="WireDecode")
    codecs = plan_codecs(plan)
    if codecs:
        _record_decompress(codecs)
        with _trace.span("wire.decompress", components=len(codecs),
                         codecs=",".join(sorted(set(codecs)))):
            parts = fn(buf)
    else:
        parts = fn(buf)
    return _wrap_cols(parts, schema)
