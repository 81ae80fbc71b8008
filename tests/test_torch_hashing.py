"""Murmur3 parity: the PyTorch port's hashing against the JAX package's.

The same numpy-seeded inputs go through both; every comparison is
exact (the hash is integer arithmetic).  The port's K1 runs here as its
plain version, because the tensors lie on the CPU; the JAX side runs
its jnp path, and once its Pallas kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.columnar.column import StringColumn as JStringColumn
from spark_rapids_tpu.columnar.column import column_to_numpy
from spark_rapids_tpu.exprs import hashing as JH
from spark_rapids_tpu.ops.pallas_kernels import pallas_hash_string

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import from_numpy_columns
from spark_rapids_tpu_torch.columnar.column import Column, StringColumn
from spark_rapids_tpu_torch.exprs import hashing as H
from spark_rapids_tpu_torch.exprs.base import BoundReference, EvalContext
from spark_rapids_tpu_torch.ops import kernels as K


def _strings(rng, n, width):
    """Random bytes (>= 0x80 included), lengths 0..W, zeroed padding,
    random uint32 seeds."""
    chars = rng.integers(0, 256, (n, width)).astype(np.uint8)
    lengths = rng.integers(0, width + 1, n).astype(np.int32)
    chars[np.arange(width)[None, :] >= lengths[:, None]] = 0
    seeds = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return chars, lengths, seeds


def _port_ref(chars, lengths, seeds_u32):
    out = K.hash_string_bytes_reference(
        torch.from_numpy(chars), torch.from_numpy(lengths),
        torch.from_numpy(seeds_u32.view(np.int32)))
    return out.numpy().view(np.uint32)


@pytest.mark.parametrize("width", [1, 3, 4, 5, 8, 12, 20, 33, 130])
def test_hash_string_reference_matches_jax(width):
    rng = np.random.default_rng(width)
    chars, lengths, seeds = _strings(rng, 300, width)
    want = np.asarray(JH.hash_string_bytes(
        jnp.asarray(chars), jnp.asarray(lengths), jnp.asarray(seeds)))
    got = _port_ref(chars, lengths, seeds)
    np.testing.assert_array_equal(got, want)
    # chained: the first hash seeds the second column, as hash(a, b)
    chars2, lengths2, _ = _strings(rng, 300, width)
    want2 = np.asarray(JH.hash_string_bytes(
        jnp.asarray(chars2), jnp.asarray(lengths2), jnp.asarray(want)))
    np.testing.assert_array_equal(_port_ref(chars2, lengths2, got), want2)


def test_hash_string_bytes_routes_cpu_tensors_to_plain_version():
    rng = np.random.default_rng(7)
    chars, lengths, seeds = _strings(rng, 64, 9)
    before = K.hash_string.launches
    got = H.hash_string_bytes(torch.from_numpy(chars),
                              torch.from_numpy(lengths),
                              torch.from_numpy(seeds.astype(np.int64)))
    want = np.asarray(JH.hash_string_bytes(
        jnp.asarray(chars), jnp.asarray(lengths), jnp.asarray(seeds)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert K.hash_string.launches == before  # no kernel on the CPU


def test_hash_string_reference_matches_pallas_interpret():
    rng = np.random.default_rng(1024)
    chars, lengths, seeds = _strings(rng, 1024, 12)
    want = np.asarray(pallas_hash_string(
        jnp.asarray(chars), jnp.asarray(lengths), jnp.asarray(seeds),
        interpret=True))
    np.testing.assert_array_equal(_port_ref(chars, lengths, seeds), want)


def test_hash_string_wrapper_checks_arguments():
    chars = torch.zeros((4, 3), dtype=torch.uint8)
    lengths = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        K.hash_string(chars, lengths, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(TypeError):
        K.hash_string(chars, lengths[:3], torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        K.hash_string(chars.t(), torch.zeros(3, dtype=torch.int32),
                      torch.zeros(3, dtype=torch.int32))


_WORDS = ["", "a", "ab", "abc", "abcd", "abcde", "ünïcode", "\x80\xff",
          "日本語テキスト", "x" * 40]
#: kind letter -> (JAX type, port type)
_KINDS = {"i": (JT.INT, T.INT), "l": (JT.LONG, T.LONG),
          "d": (JT.DOUBLE, T.DOUBLE), "t": (JT.DATE, T.DATE),
          "b": (JT.BOOLEAN, T.BOOLEAN), "s": (JT.STRING, T.STRING)}


def _values(rng, kind, n):
    if kind == "i":
        return rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    if kind == "l":
        return rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)
    if kind == "d":
        dbl = rng.normal(0, 1e6, n)
        dbl[::7] = -0.0
        dbl[1::11] = 0.0
        dbl[2::13] = np.nan
        dbl[3::13] = np.array([0x7FF0000000000001],
                              np.uint64).view(np.float64)
        return dbl
    if kind == "t":
        return rng.integers(0, 20000, n).astype(np.int32)
    if kind == "b":
        return rng.random(n) > 0.5
    return [_WORDS[i] for i in rng.integers(0, len(_WORDS), n)]


def _columns(n=200, seed=3, kinds="ildts"):
    """One column per letter of ``kinds`` (INT, LONG, DOUBLE with -0.0
    and two NaN payloads, DATE, BOOLEAN, STRING), each with its own
    random values and NULLs, in both engines."""
    rng = np.random.default_rng(seed)
    jcols, host, fields = [], {}, []
    for i, kind in enumerate(kinds):
        jdt, dt = _KINDS[kind]
        vals = _values(rng, kind, n)
        valid = rng.random(n) > 0.2
        if kind == "s":
            jc = JStringColumn.from_list(
                [s if ok else None for s, ok in zip(vals, valid)])
        else:
            jc = JColumn.from_numpy(vals, jdt, valid)
        jcols.append(jc)
        host[f"c{i}"] = column_to_numpy(jc, n)
        fields.append(T.Field(f"c{i}", dt))
    batch = from_numpy_columns(host, T.Schema(fields), "cpu")
    return jcols, batch, n


@pytest.mark.parametrize("subset", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4],
                                    [4, 2, 0]])
def test_hash_columns_and_partition_ids_match_jax(subset):
    jcols, batch, n = _columns()
    jc = [jcols[i] for i in subset]
    pc = [batch.columns[i] for i in subset]
    want = np.asarray(JH.hash_columns(jc, jc[0].capacity))[:n]
    got = H.hash_columns(pc, n, batch.device).numpy()
    np.testing.assert_array_equal(got, want)
    for parts in (1, 8, 200):
        want_p = np.asarray(JH.partition_ids(jc, jc[0].capacity, parts))[:n]
        got_p = H.partition_ids(pc, n, batch.device, parts).numpy()
        np.testing.assert_array_equal(got_p, want_p)


@pytest.mark.parametrize("n_cols", [17, 20])
def test_hash_columns_chain_past_sixteen_columns_like_jax(n_cols):
    # srt_hash_columns takes 16 columns a launch; longer tuples chain
    # through the seeds, and the plain version chains the same chunks
    kinds = ("sildtb" * 4)[:n_cols]
    jcols, batch, n = _columns(n=300, seed=n_cols, kinds=kinds)
    before = K.hash_columns.launches
    want = np.asarray(JH.hash_columns(jcols, jcols[0].capacity))[:n]
    got = H.hash_columns(batch.columns, n, batch.device)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    for parts in (1, 8, 200):
        want_p = np.asarray(
            JH.partition_ids(jcols, jcols[0].capacity, parts))[:n]
        got_p = H.partition_ids(batch.columns, n, batch.device, parts)
        assert got_p.dtype == torch.int64
        np.testing.assert_array_equal(got_p.numpy(), want_p)
    seeds = torch.full((n,), 42, dtype=torch.int32)
    assert torch.equal(K.hash_columns_reference(batch.columns, seeds), got)
    assert K.hash_columns.launches == before  # no kernel on the CPU


def test_hash_columns_seed_matches_jax():
    jcols, batch, n = _columns(seed=9, kinds="sld")
    for seed in (0, 7, -1, 0x9747B28C):
        want = np.asarray(JH.hash_columns(jcols, jcols[0].capacity,
                                          seed & 0xFFFFFFFF))[:n]
        got = K.hash_columns(batch.columns, n, "cpu", seed)
        np.testing.assert_array_equal(got.numpy(), want)


def _check_geometry(tags, geo):
    assert geo.threads % K.WARP == 0 and K.WARP <= geo.threads
    assert geo.threads <= K.MAX_THREADS
    assert 4 * geo.smem_words <= K.SMEM_PER_BLOCK
    off = 0
    for (tag, width), pitch, start in zip(tags, geo.pitches, geo.offsets):
        assert start == off
        off += geo.threads * pitch
        if pitch == 0:
            # read from global memory: fixed-width, narrow, or a string
            # whose rows would not fit beside the staged ones in a tile
            # of one warp
            assert (tag != K.STRING_TAG or width <= K.NARROW_WIDTH
                    or 4 * K.WARP * (sum(geo.pitches) + K.pitch_words(width))
                    > K.SMEM_PER_BLOCK)
            continue
        assert tag == K.STRING_TAG and width > K.NARROW_WIDTH
        assert pitch % 2 == 1  # a warp's 32 rows in 32 banks
        assert 4 * pitch >= width + 3  # a row after a shift of up to 3
        assert geo.threads * width * width < 1 << 32
    assert off == geo.smem_words


def test_tile_geometry_fits_for_every_width():
    staged = direct = 0
    for width in list(range(1, 4201)) + [7000, 7257, 7258, 8000, 70000]:
        tags = [(K.STRING_TAG, width)]
        geo = K.tile_geometry(tags, 1 << 23)
        _check_geometry(tags, geo)
        staged += geo.pitches[0] > 0
        direct += geo.pitches[0] == 0 and width > K.NARROW_WIDTH
        # a batch smaller than one tile gets a tile cut to whole warps
        small = K.tile_geometry(tags, 40)
        _check_geometry(tags, small)
        assert small.threads == min(64, geo.threads)
    assert staged == 4200 - K.NARROW_WIDTH + 2 and direct == 3


@pytest.mark.parametrize("widths", [[0, 0, 16], [17, 0, 1], [4000, 4000],
                                    [200] * 16, [7000, 64, 7000, 3]])
def test_tile_geometry_of_a_tuple_fits(widths):
    tags = [(K.STRING_TAG, w) if w else (K.INT64_TAG, 0) for w in widths]
    geo = K.tile_geometry(tags, 1 << 20)
    _check_geometry(tags, geo)
    # the widest strings leave shared memory first
    kept = [w for (tag, w), p in zip(tags, geo.pitches) if p]
    dropped = [w for (tag, w), p in zip(tags, geo.pitches)
               if not p and w > K.NARROW_WIDTH]
    assert not kept or not dropped or max(kept) <= min(dropped)


def test_hash_columns_wrapper_checks_arguments():
    _, batch, n = _columns(n=64, kinds="si")
    s, i = batch.columns
    before = K.hash_columns.launches
    with pytest.raises(TypeError):  # a type the kernel lacks
        K.hash_columns([Column(torch.zeros(n), s.validity, T.NULL)], n,
                       "cpu")
    with pytest.raises(TypeError):  # data of the wrong dtype
        K.hash_columns([Column(i.data.long(), i.validity, T.INT)], n, "cpu")
    with pytest.raises(TypeError):  # a column of another length
        K.hash_columns([i], n + 1, "cpu")
    wide = torch.zeros((n, 2 * s.width), dtype=torch.uint8)
    with pytest.raises(ValueError):  # non-contiguous chars
        K.hash_columns([StringColumn(wide[:, ::2], s.lengths, s.validity)],
                       n, "cpu")
    with pytest.raises(ValueError):  # non-contiguous values
        K.hash_columns([Column(torch.zeros(2 * n, dtype=torch.int32)[::2],
                               i.validity, T.INT)], n, "cpu")
    with pytest.raises(ValueError):  # columns on another device
        K.hash_columns([i], n, "meta")
    with pytest.raises(ValueError):
        K.hash_columns([i], n, "cpu", num_partitions=-1)
    assert K.hash_columns.launches == before


def test_murmur3_hash_expression_matches_hash_columns():
    _, batch, n = _columns(seed=5)
    refs = [BoundReference(i, f.dtype, True, f.name)
            for i, f in enumerate(batch.schema.fields)]
    out = H.Murmur3Hash(*refs).eval(EvalContext.for_batch(batch))
    want = H.hash_columns(batch.columns, n, batch.device)
    assert torch.equal(out.data, want)
    assert bool(out.validity.all())


def test_mul32_is_exact_for_all_32_bit_operands():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    for c in (H.C1, H.C2, 5, 0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF):
        got = H.mul32(torch.from_numpy(x.astype(np.int64)), c).numpy()
        want = (x.astype(np.uint32) * np.uint32(c)).astype(np.int64)
        np.testing.assert_array_equal(got, want)


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
