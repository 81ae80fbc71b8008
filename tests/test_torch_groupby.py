"""Group-by parity: the port's ``ops/groupby.py`` against the JAX
package's, on the same numpy-seeded batches.

Values are multiples of 1/4 well inside float64's exact range, so every
sum is exact in any order and results compare exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import column_to_numpy
from spark_rapids_tpu.ops import groupby as JG

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import from_numpy_columns, to_arrow
from spark_rapids_tpu_torch.columnar.column import Column, StringColumn
from spark_rapids_tpu_torch.ops import groupby as G

#: (name, JAX type, port type)
FIELDS = [("ks", JT.STRING, T.STRING), ("ki", JT.LONG, T.LONG),
          ("kd", JT.DOUBLE, T.DOUBLE), ("vd", JT.DOUBLE, T.DOUBLE),
          ("vi", JT.INT, T.INT)]


def _data(n, seed):
    rng = np.random.default_rng(seed)
    words = np.array(["", "A", "N", "R", "ab", "abcdefgh", "abcdefghi",
                      "ünï", "a\x00"], dtype=object)
    kd = rng.integers(-2, 3, n).astype(np.float64)
    # float keys arrive normalized, as both engines' aggregate execs
    # leave them (-0.0 -> 0.0, one canonical NaN): the group-by itself
    # only has to put every NaN in one group
    kd[rng.random(n) < 0.1] = np.nan
    data = {"ks": words[rng.integers(0, len(words), n)],
            "ki": rng.integers(0, 5, n).astype(np.int64),
            "kd": kd,
            "vd": rng.integers(-4000, 4000, n) / 4.0,
            "vi": rng.integers(-1000, 1000, n).astype(np.int32)}
    validity = {k: rng.random(n) > 0.15 for k in data}
    return data, validity


def _batches(n=500, seed=0):
    data, validity = _data(n, seed)
    jschema = JT.Schema([JT.Field(f, jt) for f, jt, _ in FIELDS])
    jb = JBatch.from_numpy(data, jschema, validity)
    host = {f: column_to_numpy(c, n) for (f, _, _), c in
            zip(FIELDS, jb.columns)}
    pschema = T.Schema([T.Field(f, pt) for f, _, pt in FIELDS])
    return jb, from_numpy_columns(host, pschema, "cpu")


def _specs(mod, ords):
    return [mod.AggSpec("sum", ords["vd"]), mod.AggSpec("sum", ords["vi"]),
            mod.AggSpec("count", ords["vd"]), mod.AggSpec("count_star", 0)]


def _out_schemas(keys):
    jt = {f: j for f, j, _ in FIELDS}
    pt = {f: p for f, _, p in FIELDS}
    jf = [JT.Field(k, jt[k]) for k in keys] + [
        JT.Field("s_vd", JT.DOUBLE), JT.Field("s_vi", JT.LONG),
        JT.Field("c_vd", JT.LONG), JT.Field("c_star", JT.LONG)]
    pf = [T.Field(k, pt[k]) for k in keys] + [
        T.Field("s_vd", T.DOUBLE), T.Field("s_vi", T.LONG),
        T.Field("c_vd", T.LONG), T.Field("c_star", T.LONG)]
    return JT.Schema(jf), T.Schema(pf)


def _canon(v):
    if isinstance(v, float) and np.isnan(v):
        return ("nan",)
    return (type(v).__name__, v)


def _rows_jax(batch):
    d = batch.to_pydict()
    return sorted(tuple(_canon(v) for v in r) for r in zip(*d.values()))


def _rows_port(batch):
    d = to_arrow(batch).to_pydict()
    return sorted(tuple(_canon(v) for v in r) for r in zip(*d.values()))


ORDS = {f: i for i, (f, _, _) in enumerate(FIELDS)}


@pytest.mark.parametrize("keys", [["ks"], ["ki"], ["kd"], ["ks", "ki"],
                                  ["kd", "ks", "ki"]])
@pytest.mark.parametrize("seed", [0, 1])
def test_sort_groupby_matches_jax(keys, seed):
    jb, pb = _batches(seed=seed)
    jschema, pschema = _out_schemas(keys)
    kords = [ORDS[k] for k in keys]
    want = JG.groupby_aggregate(jb, kords, _specs(JG, ORDS), jschema)
    got = G.groupby_aggregate(pb, kords, _specs(G, ORDS), pschema)
    assert _rows_port(got) == _rows_jax(want)


def test_groupby_live_mask_matches_jax():
    jb, pb = _batches(seed=4)
    jschema, pschema = _out_schemas(["ks"])
    mask = np.random.default_rng(4).random(pb.num_rows) > 0.5
    jmask = jnp.asarray(np.concatenate(
        [mask, np.zeros(jb.capacity - len(mask), bool)]))
    want = JG.groupby_aggregate(jb, [0], _specs(JG, ORDS), jschema, jmask)
    got = G.groupby_aggregate(pb, [0], _specs(G, ORDS), pschema,
                              torch.from_numpy(mask))
    assert _rows_port(got) == _rows_jax(want)


def _with_string_dictionary(jb, pb, ordinal):
    """Attach the same dictionary sidecar to a string key in both
    engines: dictionary = the distinct non-null strings, codes 0 on
    NULL rows."""
    n = pb.num_rows
    vals, valid = column_to_numpy(jb.columns[ordinal], n)
    entries = sorted({v for v, ok in zip(vals, valid) if ok})
    code_of = {v: i for i, v in enumerate(entries)}
    codes = np.array([code_of[v] if ok else 0 for v, ok in zip(vals, valid)],
                     np.int32)
    from spark_rapids_tpu.columnar.column import StringColumn as JS

    jdict = JS.from_list(entries)
    jcol = jb.columns[ordinal]
    jcodes = np.zeros(jb.capacity, np.int32)
    jcodes[:n] = codes
    jb.columns[ordinal] = dataclasses.replace(
        jcol, codes=jnp.asarray(jcodes), dict_chars=jdict.chars,
        dict_lens=jdict.lengths, dict_len=len(entries))
    pdict = from_numpy_columns(
        {"d": (np.array(entries, object), np.ones(len(entries), bool))},
        T.Schema([T.Field("d", T.STRING)]), "cpu").columns[0]
    pcol = pb.columns[ordinal]
    pb.columns[ordinal] = dataclasses.replace(
        pcol, codes=torch.from_numpy(codes), dict_chars=pdict.chars,
        dict_lens=pdict.lengths)


@pytest.mark.parametrize("seed", [0, 2])
def test_coded_groupby_matches_jax(seed):
    jb, pb = _batches(seed=seed)
    _with_string_dictionary(jb, pb, ORDS["ks"])
    key_cols = [pb.columns[ORDS["ks"]]]
    assert G._coded_key_domains(key_cols) is not None  # the coded path
    assert JG._coded_key_domains([jb.columns[ORDS["ks"]]]) is not None
    jschema, pschema = _out_schemas(["ks"])
    want = JG.groupby_aggregate(jb, [0], _specs(JG, ORDS), jschema)
    got = G.groupby_aggregate(pb, [0], _specs(G, ORDS), pschema)
    assert _rows_port(got) == _rows_jax(want)
    # and the coded answer equals the sort path's
    plain = dataclasses.replace(pb.columns[0], codes=None)
    pb2 = pb.with_columns([plain] + pb.columns[1:], pb.schema)
    assert _rows_port(G.groupby_aggregate(pb2, [0], _specs(G, ORDS),
                                          pschema)) == _rows_port(got)


def test_float_dictionary_keys_take_the_sort_path():
    vals = torch.tensor([0.0, -0.0, float("nan"), 1.0], dtype=torch.float64)
    col = Column(vals, torch.ones(4, dtype=torch.bool), T.DOUBLE,
                 codes=torch.tensor([0, 1, 2, 3], dtype=torch.int32),
                 dict_values=vals.clone())
    assert G._coded_key_domains([col]) is None
    long_col = dataclasses.replace(col, data=vals.long(), dtype=T.LONG,
                                   dict_values=vals.long())
    assert G._coded_key_domains([long_col]) == [4]
    s = StringColumn(torch.zeros((4, 1), dtype=torch.uint8),
                     torch.zeros(4, dtype=torch.int32),
                     torch.ones(4, dtype=torch.bool))
    assert G._coded_key_domains([s]) is None  # no sidecar


@pytest.mark.parametrize("seed", [0, 3])
def test_reduce_aggregate_matches_jax(seed):
    jb, pb = _batches(seed=seed)
    _, pschema = _out_schemas([])
    jschema, _ = _out_schemas([])
    want = JG.reduce_aggregate(jb, _specs(JG, ORDS), jschema)
    got = G.reduce_aggregate(pb, _specs(G, ORDS), pschema)
    assert _rows_port(got) == _rows_jax(want)


def test_reduce_aggregate_of_empty_input_is_one_null_row():
    _, pb = _batches(n=8)
    empty = pb.gather(torch.zeros(0, dtype=torch.int64))
    _, pschema = _out_schemas([])
    got = to_arrow(G.reduce_aggregate(empty, _specs(G, ORDS), pschema))
    assert got.to_pylist() == [{"s_vd": None, "s_vi": None, "c_vd": 0,
                                "c_star": 0}]


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
