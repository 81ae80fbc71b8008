"""min / max / first / last and COUNT(DISTINCT): the port against the
JAX package.

- ``ops/groupby.py``: every new op on the sort path, the coded path and
  the grand reduction, against the JAX functions on the same
  numpy-seeded batch: doubles with NaN, -0.0 and 0.0, a group whose
  values are all NULL and one whose values are all NaN, INT and DATE
  values with NULLs, and empty input.  One batch, so first / last see
  one row order in both engines.
- The DataFrame: the same aggregates through ``TorchSession`` on the
  CPU against both JAX engines, over Parquet files: first / last over
  one scan task (the JAX engine's exchange commits its map tasks in
  thread order, so across tasks its first row is not fixed), min / max
  and COUNT(DISTINCT) over three tasks and an exchange, grouped and
  grand, and over input a filter empties.
- What the port does not run: min / max / first / last over strings
  (the JAX planner sends them to its CPU engine) and COUNT(DISTINCT)
  beside other aggregates or over two expressions (the JAX session
  refuses them too).
"""

import dataclasses
import datetime

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import StringColumn as JStringColumn
from spark_rapids_tpu.columnar.column import column_to_numpy
from spark_rapids_tpu.config import get_conf, set_conf
from spark_rapids_tpu.ops import groupby as JG
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import count_distinct as jcount_distinct
from spark_rapids_tpu.session import first as jfirst
from spark_rapids_tpu.session import last as jlast
from spark_rapids_tpu.session import lit as jlit
from spark_rapids_tpu.session import max_ as jmax
from spark_rapids_tpu.session import min_ as jmin

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import session as P
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import from_numpy_columns, to_arrow
from spark_rapids_tpu_torch.ops import groupby as G

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
#: (name, JAX type, port type)
FIELDS = [("k", JT.STRING, T.STRING), ("g", JT.LONG, T.LONG),
          ("vd", JT.DOUBLE, T.DOUBLE), ("vi", JT.INT, T.INT),
          ("vt", JT.DATE, T.DATE)]
ORDS = {f: i for i, (f, _, _) in enumerate(FIELDS)}
#: keys of the groups built to be all NULL and all NaN in ``vd``
ALL_NULL, ALL_NAN = "allnull", "allnan"
OPS = ["min", "max", "first", "last", "first_any", "last_any"]
EPOCH = datetime.date(1970, 1, 1)


def _data(n: int, seed: int):
    """Columns and validity of ``n`` rows: ``vd`` holds NaN, -0.0 and
    0.0; the keys ALL_NULL and ALL_NAN hold only NULL / only NaN."""
    rng = np.random.default_rng(seed)
    words = np.array(["a", "b", "c", "dd", ALL_NULL, ALL_NAN], dtype=object)
    k = words[rng.integers(0, len(words), n)]
    vd = rng.integers(-40, 40, n) / 4.0
    vd[rng.random(n) < 0.1] = np.nan
    vd[rng.random(n) < 0.1] = -0.0
    vd[k == ALL_NAN] = np.nan
    data = {"k": k, "g": rng.integers(0, 6, n).astype(np.int64), "vd": vd,
            "vi": rng.integers(-1000, 1000, n).astype(np.int32),
            "vt": rng.integers(0, 20000, n).astype(np.int32)}
    validity = {f: rng.random(n) > 0.2 for f in data}
    validity["k"] |= (k == ALL_NULL) | (k == ALL_NAN)
    validity["vd"] &= k != ALL_NULL
    validity["vd"] |= k == ALL_NAN
    return data, validity


def _batches(n: int = 600, seed: int = 0):
    data, validity = _data(n, seed)
    jschema = JT.Schema([JT.Field(f, jt) for f, jt, _ in FIELDS])
    jb = JBatch.from_numpy(data, jschema, validity)
    host = {f: column_to_numpy(c, n) for (f, _, _), c in
            zip(FIELDS, jb.columns)}
    pschema = T.Schema([T.Field(f, pt) for f, _, pt in FIELDS])
    return jb, from_numpy_columns(host, pschema, "cpu")


def _with_string_dictionary(jb, pb):
    """The same dictionary sidecar on ``k`` in both engines, so both
    take the coded path."""
    n = pb.num_rows
    vals, valid = column_to_numpy(jb.columns[0], n)
    entries = sorted({v for v, ok in zip(vals, valid) if ok})
    code_of = {v: i for i, v in enumerate(entries)}
    codes = np.array([code_of[v] if ok else 0 for v, ok in zip(vals, valid)],
                     np.int32)
    jdict = JStringColumn.from_list(entries)
    jcodes = np.zeros(jb.capacity, np.int32)
    jcodes[:n] = codes
    jb.columns[0] = dataclasses.replace(
        jb.columns[0], codes=jnp.asarray(jcodes), dict_chars=jdict.chars,
        dict_lens=jdict.lengths, dict_len=len(entries))
    pdict = from_numpy_columns(
        {"d": (np.array(entries, object), np.ones(len(entries), bool))},
        T.Schema([T.Field("d", T.STRING)]), "cpu").columns[0]
    pb.columns[0] = dataclasses.replace(
        pb.columns[0], codes=torch.from_numpy(codes),
        dict_chars=pdict.chars, dict_lens=pdict.lengths)
    assert G._coded_key_domains([pb.columns[0]]) is not None
    assert JG._coded_key_domains([jb.columns[0]]) is not None


def _specs(mod, ops):
    return [mod.AggSpec(op, ORDS[v]) for op in ops
            for v in ("vd", "vi", "vt")]


def _schemas(keys, ops):
    jt = {f: j for f, j, _ in FIELDS}
    pt = {f: p for f, _, p in FIELDS}
    names = [f"{op}_{v}" for op in ops for v in ("vd", "vi", "vt")]
    return (JT.Schema([JT.Field(k, jt[k]) for k in keys]
                      + [JT.Field(nm, jt[nm.rsplit("_", 1)[1]])
                         for nm in names]),
            T.Schema([T.Field(k, pt[k]) for k in keys]
                     + [T.Field(nm, pt[nm.rsplit("_", 1)[1]])
                        for nm in names]))


def _canon(v):
    if isinstance(v, datetime.date):
        return ("int", (v - EPOCH).days)  # the JAX batch gives days
    if isinstance(v, float):
        if np.isnan(v):
            return ("nan",)
        return ("f", v, np.signbit(v))  # -0.0 apart from 0.0
    return (type(v).__name__, v)


def _rows(d: dict):
    return sorted(tuple(_canon(v) for v in r) for r in zip(*d.values()))


@pytest.mark.parametrize("path", ["sort_string", "sort_long", "coded",
                                  "grand"])
@pytest.mark.parametrize("seed", [0, 1])
def test_value_ops_match_jax_on_every_path(path, seed):
    jb, pb = _batches(seed=seed)
    keys = {"sort_string": ["k"], "sort_long": ["g"], "coded": ["k"],
            "grand": []}[path]
    if path == "coded":
        _with_string_dictionary(jb, pb)
    jschema, pschema = _schemas(keys, OPS)
    kords = [ORDS[k] for k in keys]
    if keys:
        want = JG.groupby_aggregate(jb, kords, _specs(JG, OPS), jschema)
        got = G.groupby_aggregate(pb, kords, _specs(G, OPS), pschema)
    else:
        want = JG.reduce_aggregate(jb, _specs(JG, OPS), jschema)
        got = G.reduce_aggregate(pb, _specs(G, OPS), pschema)
    assert _rows(to_arrow(got).to_pydict()) == _rows(want.to_pydict())


def test_spark_float_order_in_the_special_groups():
    _, pb = _batches(seed=0)
    _, pschema = _schemas(["k"], ["min", "max"])
    got = to_arrow(G.groupby_aggregate(pb, [0], _specs(G, ["min", "max"]),
                                       pschema)).to_pydict()
    row = {k: i for i, k in enumerate(got["k"])}
    # every valid value NaN: min is NaN too, not NULL
    assert np.isnan(got["min_vd"][row[ALL_NAN]])
    assert np.isnan(got["max_vd"][row[ALL_NAN]])
    assert got["min_vd"][row[ALL_NULL]] is None
    # NaN is the greatest value: max is NaN, min is a number
    for k in ("a", "b"):
        assert np.isnan(got["max_vd"][row[k]])
        assert not np.isnan(got["min_vd"][row[k]])


def test_empty_input_gives_no_group_and_one_null_row():
    _, pb = _batches(n=8)
    empty = pb.gather(torch.zeros(0, dtype=torch.int64))
    _, grouped = _schemas(["k"], OPS)
    assert G.groupby_aggregate(empty, [0], _specs(G, OPS),
                               grouped).num_rows == 0
    _, grand = _schemas([], OPS)
    row = to_arrow(G.reduce_aggregate(empty, _specs(G, OPS),
                                      grand)).to_pylist()
    assert row == [dict.fromkeys(grand.names)]


# --------------------------------------------------------------------- #
# Through the DataFrame, against both JAX engines
# --------------------------------------------------------------------- #


def _table(n: int, seed: int) -> pa.Table:
    data, validity = _data(n, seed)
    cols = {}
    for f, _, _ in FIELDS:
        arr = pa.array(list(data[f]) if f == "k" else data[f],
                       mask=~validity[f])
        cols[f] = arr.cast(pa.date32()) if f == "vt" else arr
    return pa.table(cols)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("aggregates")
    paths = []
    for i in range(3):
        p = str(d / f"part-{i}.parquet")
        pq.write_table(_table(400, 10 + i), p)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def jax_conf():
    conf = get_conf()
    saved = dict(conf._values)
    yield conf
    conf._values.clear()
    conf._values.update(saved)
    set_conf(conf)


def _aggs(a, ops):
    """Named aggregates over API ``a`` (the port's session module or the
    JAX one)."""
    fn = {"min": a.min_, "max": a.max_,
          "first": lambda c: a.first(c, True),
          "last": lambda c: a.last(c, True),
          "first_any": a.first, "last_any": a.last}
    return [(fn[op](a.col(v)), f"{op}_{v}") for op in ops
            for v in ("vd", "vi", "vt")]


class _Api:
    """One aggregate query written once for either engine's DSL."""

    def __init__(self, **fns):
        self.__dict__.update(fns)


JAPI = _Api(min_=jmin, max_=jmax, first=jfirst, last=jlast, col=jcol,
            lit=jlit, count_distinct=jcount_distinct)
PAPI = _Api(min_=P.min_, max_=P.max_, first=P.first, last=P.last,
            col=P.col, lit=P.lit, count_distinct=P.count_distinct)


def _frames(paths, ttb, jax_conf, make):
    """``make(api, df)`` over the files in both engines: the port's
    result, and the JAX engines'."""
    jax_conf.set(TTB, ttb)
    set_conf(jax_conf)
    port = make(PAPI, TorchSession({TTB: ttb}, device="cpu")
                .read_parquet(*paths)).collect()
    jdf = make(JAPI, TpuSession(jax_conf).read_parquet(*paths))
    return port, {e: jdf.collect(engine=e) for e in ("tpu", "cpu")}


def _assert_same(port, jax):
    for want in jax.values():
        assert_tables_equal(port, want)


@pytest.mark.parametrize("keys", [["k"], ["g"], []])
def test_first_last_in_one_task_match_both_engines(keys, files, jax_conf):
    def make(a, df):
        aggs = _aggs(a, OPS)
        return (df.group_by(*[a.col(k) for k in keys]).agg(*aggs) if keys
                else df.agg(*aggs))

    port, jax = _frames(files[:1], 512 << 20, jax_conf, make)
    assert port.num_rows == {"k": 7, "g": 7, None: 1}[
        keys[0] if keys else None]  # six values and NULL
    _assert_same(port, jax)


@pytest.mark.parametrize("keys", [["k"], ["g"], ["k", "g"], []])
def test_min_max_across_tasks_match_both_engines(keys, files, jax_conf):
    def make(a, df):
        aggs = _aggs(a, ["min", "max"])
        return (df.group_by(*[a.col(k) for k in keys]).agg(*aggs) if keys
                else df.agg(*aggs))

    port, jax = _frames(files, 1, jax_conf, make)
    _assert_same(port, jax)


@pytest.mark.parametrize("value", ["g", "vi", "k", "vt", "vd"])
@pytest.mark.parametrize("keys", [["k"], []])
def test_count_distinct_matches_both_engines(value, keys, files, jax_conf):
    def make(a, df):
        agg = (a.count_distinct(a.col(value)), "n")
        return (df.group_by(*[a.col(k) for k in keys]).agg(agg) if keys
                else df.agg(agg))

    port, jax = _frames(files, 1, jax_conf, make)
    assert port.schema.names == keys + ["n"]
    _assert_same(port, jax)


@pytest.mark.parametrize("keys", [["k"], []])
def test_aggregates_of_filtered_out_input(keys, files, jax_conf):
    def make(a, df):
        df = df.where(a.col("vi") > a.lit(5000))
        aggs = _aggs(a, OPS)
        return (df.group_by(*[a.col(k) for k in keys]).agg(*aggs) if keys
                else df.agg(*aggs))

    port, jax = _frames(files, 1, jax_conf, make)
    assert port.num_rows == (0 if keys else 1)
    _assert_same(port, jax)


def test_first_last_keep_map_task_order(files):
    """Across tasks and an exchange the port picks the first / last row
    of the first / last task holding the group: the files' order."""
    s = TorchSession({TTB: 1}, device="cpu")
    got = (s.read_parquet(*files).group_by(P.col("k"))
           .agg((P.first(P.col("vi")), "f"), (P.last(P.col("vi")), "l"),
                (P.first(P.col("vi"), True), "fn"),
                (P.last(P.col("vi"), True), "ln"))
           .collect().to_pylist())
    t = pa.concat_tables([pq.read_table(p) for p in files]).to_pydict()
    for r in got:
        vals = [v for k, v in zip(t["k"], t["vi"]) if k == r["k"]]
        valid = [v for v in vals if v is not None]
        assert (r["f"], r["l"]) == (vals[0], vals[-1])
        assert (r["fn"], r["ln"]) == (valid[0], valid[-1])


@pytest.mark.parametrize("fn", ["min_", "max_", "first", "last"])
def test_value_aggregates_over_strings_raise(fn, files):
    s = TorchSession(device="cpu")
    df = s.read_parquet(*files).group_by(P.col("g")).agg(
        (getattr(P, fn)(P.col("k")), "x"))
    with pytest.raises(NotImplementedError, match="string"):
        df.physical_plan()


def test_count_distinct_refuses_what_the_jax_session_refuses(files):
    df = TorchSession(device="cpu").read_parquet(*files)
    with pytest.raises(ValueError):
        df.agg((P.count_distinct(P.col("g")), "n"), (P.min_("vi"), "m"))
    with pytest.raises(ValueError):
        df.agg((P.count_distinct(P.col("g")), "n"),
               (P.count_distinct(P.col("vi")), "m"))
    with pytest.raises(ValueError):
        df.rollup("k").agg((P.count_distinct(P.col("g")), "n"))
