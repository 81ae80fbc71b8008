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


def _columns(n=200, seed=3):
    """INT, LONG, DOUBLE (with -0.0 and two NaN payloads), DATE and
    STRING columns with NULLs, in both engines."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    longs = rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)
    dbl = rng.normal(0, 1e6, n)
    dbl[::7] = -0.0
    dbl[1::11] = 0.0
    dbl[2::13] = np.nan
    dbl[3::13] = np.array([0x7FF0000000000001], np.uint64).view(np.float64)
    dates = rng.integers(0, 20000, n).astype(np.int32)
    words = ["", "a", "ab", "abc", "abcd", "abcde", "ünïcode", "\x80\xff",
             "日本語テキスト", "x" * 40]
    strs = [words[i] for i in rng.integers(0, len(words), n)]
    specs = [("i", JT.INT, T.INT, ints), ("l", JT.LONG, T.LONG, longs),
             ("d", JT.DOUBLE, T.DOUBLE, dbl), ("dt", JT.DATE, T.DATE, dates)]
    jcols, host = [], {}
    for name, jdt, _, vals in specs:
        valid = rng.random(n) > 0.2
        jcols.append(JColumn.from_numpy(vals, jdt, valid))
    svalid = rng.random(n) > 0.2
    jcols.append(JStringColumn.from_list(
        [s if ok else None for s, ok in zip(strs, svalid)]))
    names = [s[0] for s in specs] + ["s"]
    for name, jc in zip(names, jcols):
        host[name] = column_to_numpy(jc, n)
    schema = T.Schema([T.Field(s[0], s[2]) for s in specs]
                      + [T.Field("s", T.STRING)])
    batch = from_numpy_columns(host, schema, "cpu")
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
