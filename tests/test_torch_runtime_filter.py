"""Runtime join filters: the port's ``plan/runtime_filter.py`` and its
scan-side probes against the JAX package's, and the filter through the
port's session.

The same numpy-seeded keys fold into a filter on both engines (K6: the
JAX ``device_update`` + ``device_pack_bits``, the port's over K1's
plain version here); the Bloom words, min, max and count must agree
bit for bit.  The host probes (``probe_host``,
``runtime_filter_column_mask``, ``runtime_range_may_match``) must give
the JAX masks on the same published filter.  Then the planner pass and
the scan, through ``TorchSession(device="cpu")``: which joins get a
filter, what it prunes, and that it never changes a result.
"""

import datetime

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.io import pa_filter as JPA
from spark_rapids_tpu.io import pushdown as JPD
from spark_rapids_tpu.plan import runtime_filter as JRF

from spark_rapids_tpu_torch import TorchSession, col, lit, sum_
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.execs.join import (
    TpuBroadcastHashJoinExec,
    TpuRuntimeFilterBuildExec,
    TpuShuffledHashJoinExec,
)
from spark_rapids_tpu_torch.io import pa_filter as PA
from spark_rapids_tpu_torch.io import pushdown as PD
from spark_rapids_tpu_torch.io.scan import ParquetScanExec
from spark_rapids_tpu_torch.plan import runtime_filter as RF

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
BCAST = "spark.rapids.tpu.sql.autoBroadcastJoinThresholdBytes"
RF_ON = "spark.rapids.tpu.sql.runtimeFilter.enabled"
RF_MAX_BUILD_ROWS = "spark.rapids.tpu.sql.runtimeFilter.maxBuildRows"
RF_FPP = "spark.rapids.tpu.sql.runtimeFilter.fpp"
ADAPTIVE = "spark.rapids.tpu.sql.adaptive.enabled"
#: kind -> (JAX type, port type, numpy dtype, value range)
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1
KINDS = {"int": (JT.INT, T.INT, np.int32, 1 << 31),
         "date": (JT.DATE, T.DATE, np.int32, 1 << 20),
         "long": (JT.LONG, T.LONG, np.int64, 1 << 62)}


def _keys(kind, n, seed, null_share=0.2):
    _, _, dtype, span = KINDS[kind]
    rng = np.random.default_rng(seed)
    vals = rng.integers(-span, span, n).astype(dtype)
    valid = rng.random(n) >= null_share
    return vals, valid


def _both_filters(kind, vals, valid, m, k):
    """The JAX and the port filter folded from the same keys (the port
    in two batches, merged), finalized, and their raw states."""
    jt, pt, _, _ = KINDS[kind]
    jcol = JColumn(jnp.asarray(vals), jnp.asarray(valid), jt)
    jstate = JRF.device_update(JRF.device_init_state(m, True), jcol,
                               jnp.asarray(valid), m, k,
                               isinstance(jt, JT.LongType), True)
    jrf = JRF.RuntimeFilter("k", jt, "inner", m, k, True, True)
    JRF.finalize(jrf, jstate)

    half = len(vals) // 2
    states = []
    for lo, hi in ((0, half), (half, len(vals))):
        c = Column(torch.from_numpy(vals[lo:hi].copy()),
                   torch.from_numpy(valid[lo:hi].copy()), pt)
        states.append(RF.device_update(RF.device_init_state(m, "cpu"),
                                       c, m, k))
    pstate = RF.device_merge_states(*states)
    prf = RF.RuntimeFilter("k", pt, "inner", m, k)
    RF.finalize(prf, pstate)
    return jrf, jstate, prf, pstate


@pytest.mark.parametrize("n", [0, 1, 1000])
@pytest.mark.parametrize("kind", list(KINDS))
def test_bloom_words_min_max_and_count_match_jax(kind, n):
    vals, valid = _keys(kind, n, seed=n + len(kind))
    m, k = RF.bloom_params(max(n, 1), 0.01)
    jrf, jstate, prf, pstate = _both_filters(kind, vals, valid, m, k)
    jwords = np.asarray(JRF.device_pack_bits(jstate[0]))
    pwords = RF.device_pack_bits(pstate[0]).numpy()
    np.testing.assert_array_equal(pwords.astype(np.uint32), jwords)
    assert pwords.min() >= 0 and pwords.max() < 1 << 32
    assert [int(x) for x in pstate[1:]] == [int(x) for x in jstate[1:]]
    assert (prf.min_val, prf.max_val, prf.n_keys) == \
        (jrf.min_val, jrf.max_val, jrf.n_keys)
    np.testing.assert_array_equal(prf.bloom_words, jrf.bloom_words)
    assert prf.n_keys == int(valid.sum())
    if n:
        # every inserted key probes positive; NULL slots never do
        mask = prf.probe_host(vals.astype(np.int64), valid)
        assert mask[valid].all() and not mask[~valid].any()
        # and fresh keys probe as the JAX filter does
        fresh = np.random.default_rng(n).integers(
            int(vals.min()), int(vals.max()) + 1, 4096)
        np.testing.assert_array_equal(prf.probe_host(fresh),
                                      jrf.probe_host(fresh))


@pytest.mark.parametrize("kind", list(KINDS))
def test_range_table_answers_as_the_bloom_does(kind):
    """A narrow [min, max] is published with a table of the Bloom's
    answers over the range, made by the device fold's K1 lanes; probing
    through it must give what hashing each row in numpy gives."""
    jrf, prf = _published_pair(kind)
    assert prf.max_val - prf.min_val < RF.LUT_MAX_SPAN
    probe = np.random.default_rng(2).integers(-1000, 6000, 20000)
    valid = np.random.default_rng(3).random(20000) > 0.1
    via_table = prf.probe_host(probe, valid)
    assert prf.range_table is not None and len(prf.range_table) == \
        prf.max_val - prf.min_val + 3
    direct = RF.RuntimeFilter("k", prf.dtype, "inner", prf.n_bits,
                              prf.n_hashes)
    direct.publish(prf.min_val, prf.max_val, prf.n_keys, prf.bloom_words,
                   0.0)
    hashed = direct.probe_host(probe, valid)
    assert direct.range_table is None
    np.testing.assert_array_equal(via_table, hashed)
    np.testing.assert_array_equal(hashed, jrf.probe_host(probe, valid))
    assert 0 < via_table.sum() < valid.sum()


@pytest.mark.parametrize("lo,hi", [(-5, 10), (_I64_MAX - 40, _I64_MAX),
                                   (_I64_MIN + 1, _I64_MIN + 40),
                                   (_I64_MIN, _I64_MIN + 40)])
def test_range_table_at_the_int64_ends(lo, hi):
    """Keys far outside [min, max] wrap when offset from min - 1; they
    must still land on the table's False ends, as the hashing path and
    the JAX probe say."""
    keys = np.array([lo, hi, (lo + hi) // 2], np.int64)
    m, k = RF.bloom_params(3, 0.01)
    _, _, prf, _ = _both_filters("long", keys, np.ones(3, bool), m, k)
    jrf = JRF.RuntimeFilter("k", JT.LONG, "inner", m, k, True, True)
    jrf.publish(prf.min_val, prf.max_val, prf.n_keys, prf.bloom_words, 0.0)
    around = [v + d for v in (lo, hi) for d in range(-3, 4)
              if _I64_MIN <= v + d <= _I64_MAX]
    probe = np.unique(np.array(
        around + [_I64_MIN, _I64_MIN + 1, -1, 0, 1, _I64_MAX - 1, _I64_MAX],
        np.int64))
    got = prf.probe_host(probe)
    assert (prf.range_table is None) == (lo == _I64_MIN)
    direct = RF.RuntimeFilter("k", T.LONG, "inner", m, k)
    direct.publish(prf.min_val, prf.max_val, prf.n_keys, prf.bloom_words,
                   0.0)
    np.testing.assert_array_equal(got, direct.probe_host(probe))
    np.testing.assert_array_equal(got, jrf.probe_host(probe))
    assert got[np.isin(probe, keys)].all()
    assert not got[(probe < lo) | (probe > hi)].any()


@pytest.mark.parametrize("kind", list(KINDS))
def test_host_lanes_match_jax(kind):
    from spark_rapids_tpu.exprs import hashing as JH

    from spark_rapids_tpu_torch.exprs import hashing as H

    vals, _ = _keys(kind, 4096, seed=3)
    for seed in (RF.BLOOM_SEED1, RF.BLOOM_SEED2):
        if kind == "long":
            got = H.np_hash_int64_blocks(vals, seed)
            want = JH.np_hash_int64_blocks(vals, seed)
        else:
            got = H.np_hash_int32_block(vals, seed)
            want = JH.np_hash_int32_block(vals, seed)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_est,fpp", [(1, 0.01), (100, 0.01),
                                       (6000, 0.01), (73049, 0.01),
                                       (1 << 22, 0.01), (500, 0.5),
                                       (500, 1e-4)])
def test_bloom_params_match_jax(n_est, fpp):
    assert RF.bloom_params(n_est, fpp) == JRF.bloom_params(n_est, fpp)


def _published_pair(kind, seed=11, n=300):
    vals, valid = _keys(kind, n, seed)
    # a narrow key range, so the probe columns fall on both sides of it
    vals = (vals % 5000).astype(vals.dtype)
    m, k = RF.bloom_params(n, 0.05)
    jrf, _, prf, _ = _both_filters(kind, vals, valid, m, k)
    return jrf, prf


def _probe_column(kind, n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-1000, 6000, n)
    mask = rng.random(n) < 0.1
    if kind == "long":
        return pa.array(vals, pa.int64(), mask=mask)
    arr = pa.array(vals.astype(np.int32), pa.int32(), mask=mask)
    return arr.cast(pa.date32()) if kind == "date" else arr


@pytest.mark.parametrize("encoding", ["plain", "dictionary", "chunked"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_column_mask_matches_jax(kind, encoding):
    jrf, prf = _published_pair(kind)
    base = _probe_column(kind, 5000, seed=len(kind))
    arr = base
    if encoding == "dictionary":
        arr = base.dictionary_encode()
    elif encoding == "chunked":
        arr = pa.chunked_array([base.slice(0, 1234), base.slice(1234)])
    want = JPA.runtime_filter_column_mask(arr, jrf)
    got = PA.runtime_filter_column_mask(arr, prf)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)
    ints = base.cast(pa.int32()) if kind == "date" else base
    values = np.asarray(ints.fill_null(0).cast(pa.int64()))
    np.testing.assert_array_equal(prf.probe_host(values),
                                  jrf.probe_host(values))


def test_column_mask_skips_other_types_and_unready_filters():
    jrf, prf = _published_pair("long")
    doubles = pa.array([1.0, 2.0])
    assert PA.runtime_filter_column_mask(doubles, prf) is None
    pending = RF.RuntimeFilter("k", T.LONG, "inner", 64, 2)
    assert PA.runtime_filter_column_mask(pa.array([1, 2]), pending).all()
    # an empty build side keeps nothing
    empty = RF.RuntimeFilter("k", T.LONG, "inner", 64, 2)
    empty.publish(0, 0, 0, np.zeros(2, np.uint32), 0.0)
    assert not PA.runtime_filter_column_mask(pa.array([1, None]),
                                             empty).any()


def test_row_group_range_matches_jax_on_a_date_sorted_file(tmp_path):
    days = np.arange(8192, dtype=np.int32)
    t = pa.table({"d": pa.array(days).cast(pa.date32()),
                  "v": np.arange(8192, dtype=np.int64)})
    path = str(tmp_path / "sorted.parquet")
    pq.write_table(t, path, row_group_size=2048)
    meta = pq.ParquetFile(path).metadata
    jrf = JRF.RuntimeFilter("d", JT.DATE, "inner", 64, 2, True, True)
    prf = RF.RuntimeFilter("d", T.DATE, "inner", 64, 2)
    for lo, hi, want_kept in ((100, 300, [0]), (2000, 2100, [0, 1]),
                              (9000, 9100, []), (0, 8191, [0, 1, 2, 3])):
        for rf in (jrf, prf):
            rf.publish(lo, hi, 5, np.zeros(2, np.uint32), 0.0)
        got = [g for g in range(4) if PD.runtime_range_may_match(
            "d", prf, meta.row_group(g))]
        want = [g for g in range(4) if JPD.runtime_range_may_match(
            "d", jrf, meta.row_group(g))]
        assert got == want == want_kept
    assert PD._stat_to_int(datetime.date(1970, 1, 11)) == 10
    assert PD._stat_to_int(True) is None


# --------------------------------------------------------------------- #
# Through the session
# --------------------------------------------------------------------- #


def _write(path, table, row_group_size=None):
    pq.write_table(table, str(path), row_group_size=row_group_size)
    return str(path)


def _typed(arr, key_type):
    """An int64 Arrow array as ``key_type`` (a date through int32)."""
    if key_type == pa.date32():
        arr = arr.cast(pa.int32())
    return arr.cast(key_type)


def _fact_and_dim(tmp_path, key_type=pa.int64(), n=8192, n_dim=512,
                  dim_lt=20, files=2):
    """A fact table of ``files`` files (keys 0..n_dim-1 and NULLs) and a
    dimension whose filter keeps keys with ``o_date < dim_lt``."""
    rng = np.random.default_rng(0)
    facts = []
    for i in range(files):
        keys = rng.integers(0, n_dim, n // files)
        keys = pa.array(keys, mask=rng.random(len(keys)) < 0.05)
        t = pa.table({"l_key": _typed(keys, key_type),
                      "l_price": rng.random(len(keys))})
        facts.append(_write(tmp_path / f"fact{i}.parquet", t, 1024))
    dim = pa.table({"o_key": _typed(pa.array(np.arange(n_dim)), key_type),
                    "o_date": rng.integers(0, 100, n_dim).astype(np.int32)})
    return facts, _write(tmp_path / "dim.parquet", dim), dim_lt


def _star(s, facts, dim, dim_lt, how="inner"):
    fact = s.read_parquet(*facts)
    d = s.read_parquet(dim).where(col("o_date") < lit(dim_lt))
    return fact.join(d, how=how, left_on=[col("l_key")],
                     right_on=[col("o_key")])


def _rows(table):
    return sorted(table.to_pylist(), key=repr)


def _scans_with_filters(plan):
    return [n for n in plan.walk()
            if isinstance(n, ParquetScanExec) and n.runtime_filters]


@pytest.mark.parametrize("bcast", [10 << 20, -1])
@pytest.mark.parametrize("key_type", [pa.int32(), pa.date32(), pa.int64()],
                         ids=["int", "date", "long"])
def test_filter_prunes_the_probe_scan_and_keeps_the_result(
        tmp_path, key_type, bcast):
    # the static plans: the adaptive join's case is the test below
    facts, dim, lt = _fact_and_dim(tmp_path, key_type)
    on = TorchSession({TTB: 1, BCAST: bcast, ADAPTIVE: False}, device="cpu")
    off = TorchSession({TTB: 1, BCAST: bcast, RF_ON: False, ADAPTIVE: False},
                       device="cpu")
    plan = _star(on, facts, dim, lt).physical_plan()
    join = plan
    assert isinstance(join, TpuBroadcastHashJoinExec if bcast > 0
                      else TpuShuffledHashJoinExec)
    build = [n for n in plan.walk()
             if isinstance(n, TpuRuntimeFilterBuildExec)]
    assert len(build) == 1 and build[0].entries[0][1].dtype == \
        {"int32": T.INT, "date32[day]": T.DATE, "int64": T.LONG}[
            str(key_type)]
    [scan] = _scans_with_filters(plan)
    assert [n for n, _ in scan.runtime_filters] == ["l_key"]
    got = list(plan.execute())
    rf = build[0].entries[0][1]
    assert rf.ready and 0 < rf.n_keys < 512
    assert RF.plan_runtime_filters(plan) == [rf]
    pruned = scan.metrics["rfPrunedRows"]
    assert pruned > 4000
    assert scan.metrics["numOutputRows"] == 8192 - pruned
    assert sum(b.num_rows for b in got) > 0
    want = _star(off, facts, dim, lt).collect()
    assert _rows(_star(on, facts, dim, lt).collect()) == _rows(want)
    assert not _scans_with_filters(_star(off, facts, dim, lt)
                                   .physical_plan())


@pytest.mark.parametrize("key_type", [pa.int32(), pa.date32(), pa.int64()],
                         ids=["int", "date", "long"])
def test_filter_prunes_the_probe_scan_under_the_adaptive_join(
        tmp_path, key_type):
    """Broadcast off, adaptive on (the default): the join is a
    TpuAdaptiveJoinExec over two exchanges, the filter's build sits
    under the right exchange, whose map stage runs first, and the probe
    scan is pruned as under the static partition-wise join."""
    from spark_rapids_tpu_torch.execs.adaptive import TpuAdaptiveJoinExec
    from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
    from spark_rapids_tpu_torch.plan.planner import collect_exec

    facts, dim, lt = _fact_and_dim(tmp_path, key_type)
    on = TorchSession({TTB: 1, BCAST: -1}, device="cpu")
    off = TorchSession({TTB: 1, BCAST: -1, RF_ON: False}, device="cpu")
    plan = _star(on, facts, dim, lt).physical_plan()
    assert isinstance(plan, TpuAdaptiveJoinExec)
    assert plan.rf_build_first == "right"
    assert all(isinstance(c, TpuShuffleExchangeExec) for c in plan.children)
    [build] = [n for n in plan.walk()
               if isinstance(n, TpuRuntimeFilterBuildExec)]
    assert plan.children[1].children[0] is build
    [scan] = _scans_with_filters(plan)
    got = collect_exec(plan, on.conf)
    # the measured build side (a few dozen keys) broadcasts at runtime
    # only under a threshold; -1 keeps the join shuffled
    assert plan.decision.startswith("shuffled"), plan.decision
    assert scan.metrics["rfPrunedRows"] > 4000
    assert _rows(got) == _rows(_star(off, facts, dim, lt).collect())


def test_empty_build_side_prunes_every_row_group(tmp_path):
    facts, dim, _ = _fact_and_dim(tmp_path)
    s = TorchSession({TTB: 1}, device="cpu")
    plan = _star(s, facts, dim, dim_lt=-1).physical_plan()
    # an empty build side joins to nothing: the probe side is not read
    assert list(plan.execute()) == []
    [rf] = RF.plan_runtime_filters(plan)
    assert rf.ready and rf.n_keys == 0
    [scan] = _scans_with_filters(plan)
    assert scan.metrics["rfRowGroupsPruned"] == 0
    # the published filter (n_keys = 0) prunes every row group of it
    assert list(scan.execute()) == []
    assert scan.metrics["rfRowGroupsPruned"] == 8  # 4 a file
    # a grouped aggregate over the join makes no rows either
    agg = _star(s, facts, dim, -1).group_by(col("o_date")).agg(
        (sum_(col("l_price")), "p"))
    assert agg.collect().num_rows == 0


def test_row_groups_outside_the_build_range_are_not_decoded(tmp_path):
    t = pa.table({"l_key": np.arange(8192, dtype=np.int64),
                  "l_price": np.ones(8192)})
    fact = _write(tmp_path / "sorted.parquet", t, 2048)
    dim = _write(tmp_path / "dim.parquet", pa.table({
        "o_key": np.arange(100, 200, dtype=np.int64),
        "o_date": np.zeros(100, np.int32)}))
    s = TorchSession(device="cpu")
    df = _star(s, [fact], dim, 1)
    plan = df.physical_plan()
    out = list(plan.execute())
    [scan] = _scans_with_filters(plan)
    assert scan.metrics["rfRowGroupsPruned"] == 3
    assert scan.metrics["numOutputRows"] == 100  # the Bloom does the rest
    assert sum(b.num_rows for b in out) == 100


def test_batch_pruned_to_nothing_flows_through_join_and_aggregate(tmp_path):
    # the second file's keys all miss the build side, within its range
    files = [
        _write(tmp_path / "a.parquet", pa.table({
            "l_key": np.array([0, 2, 4, 6], np.int64),
            "l_price": np.ones(4)})),
        _write(tmp_path / "b.parquet", pa.table({
            "l_key": np.array([1, 3, 5, 7], np.int64),
            "l_price": np.ones(4)})),
    ]
    dim = _write(tmp_path / "dim.parquet", pa.table({
        "o_key": np.array([0, 2, 4, 6, 8], np.int64),
        "o_date": np.zeros(5, np.int32)}))
    s = TorchSession({TTB: 1}, device="cpu")
    df = (_star(s, files, dim, 1)
          .group_by(col("o_date")).agg((sum_(col("l_price")), "p")))
    plan = df.physical_plan()
    [scan] = _scans_with_filters(plan)
    scan.execute_partition(1)  # nothing published yet: a lazy generator
    assert df.collect().to_pylist() == [{"o_date": 0, "p": 4.0}]
    list(plan.execute())
    # the second file lies within the filter's range: its row group is
    # decoded, and the Bloom drops every row of it
    assert scan.metrics["rfRowGroupsPruned"] == 0
    assert scan.metrics["rfPrunedRows"] >= 4


def test_null_probe_keys_are_dropped(tmp_path):
    fact = _write(tmp_path / "f.parquet", pa.table({
        "l_key": pa.array([1, 2, None, 3, None, 2], pa.int64()),
        "l_price": np.arange(6, dtype=np.float64)}))
    dim = _write(tmp_path / "dim.parquet", pa.table({
        "o_key": np.arange(3, dtype=np.int64),
        "o_date": np.zeros(3, np.int32)}))
    s = TorchSession(device="cpu")
    out = _star(s, [fact], dim, 1).collect()
    assert sorted(out.column("l_key").to_pylist()) == [1, 2, 2]
    plan = _star(s, [fact], dim, 1).physical_plan()
    list(plan.execute())
    [scan] = _scans_with_filters(plan)
    assert scan.metrics["rfPrunedRows"] == 3  # the NULLs and key 3


@pytest.mark.parametrize("bcast", [10 << 20, -1])
@pytest.mark.parametrize("how", ["left_outer", "right_outer", "full_outer",
                                 "left_anti"])
def test_ineligible_join_types_never_get_a_filter(tmp_path, how, bcast):
    facts, dim, lt = _fact_and_dim(tmp_path, n=1024)
    s = TorchSession({TTB: 1, BCAST: bcast}, device="cpu")
    plan = _star(s, facts, dim, lt, how).physical_plan()
    assert not any(isinstance(n, TpuRuntimeFilterBuildExec)
                   for n in plan.walk())
    assert not _scans_with_filters(plan)
    off = TorchSession({TTB: 1, BCAST: bcast, RF_ON: False}, device="cpu")
    assert _rows(_star(s, facts, dim, lt, how).collect()) == \
        _rows(_star(off, facts, dim, lt, how).collect())


def test_left_semi_gets_a_filter(tmp_path):
    facts, dim, lt = _fact_and_dim(tmp_path, n=2048)
    s = TorchSession({TTB: 1}, device="cpu")
    off = TorchSession({TTB: 1, RF_ON: False}, device="cpu")
    df = _star(s, facts, dim, lt, "left_semi")
    assert _scans_with_filters(df.physical_plan())
    assert _rows(df.collect()) == _rows(
        _star(off, facts, dim, lt, "left_semi").collect())


def _unwrap(node):
    """The plan with every filter build exec replaced by its child."""
    node.children = [_unwrap(c.children[0] if isinstance(
        c, TpuRuntimeFilterBuildExec) else c) for c in node.children]
    return node


@pytest.mark.parametrize("bcast", [10 << 20, -1])
def test_disabled_reproduces_the_unfiltered_plan(tmp_path, bcast):
    facts, dim, lt = _fact_and_dim(tmp_path)
    on = TorchSession({TTB: 1, BCAST: bcast}, device="cpu")
    off = TorchSession({TTB: 1, BCAST: bcast, RF_ON: False}, device="cpu")

    def df(s):
        return (_star(s, facts, dim, lt).group_by(col("o_date"))
                .agg((sum_(col("l_price")), "p")))

    on_plan = df(on).physical_plan()
    off_plan = df(off).physical_plan()
    assert any(isinstance(n, TpuRuntimeFilterBuildExec)
               for n in on_plan.walk())
    assert not any(isinstance(n, TpuRuntimeFilterBuildExec)
                   for n in off_plan.walk())
    assert _unwrap(on_plan).tree_string() == off_plan.tree_string()
    got, want = df(on).collect(), df(off).collect()
    assert [r["o_date"] for r in _rows(got)] == \
        [r["o_date"] for r in _rows(want)]
    for g, w in zip(_rows(got), _rows(want)):
        assert g["p"] == pytest.approx(w["p"], rel=1e-12)
    plan = df(on).physical_plan()
    list(plan.execute())
    assert [rf.ready for rf in RF.plan_runtime_filters(plan)] == [True]


def test_unselective_build_side_gets_no_filter(tmp_path):
    facts, dim, lt = _fact_and_dim(tmp_path, n=1024)
    s = TorchSession(device="cpu")
    assert _scans_with_filters(_star(s, facts, dim, lt).physical_plan())
    capped = TorchSession({RF_MAX_BUILD_ROWS: 10}, device="cpu")
    assert not _scans_with_filters(
        _star(capped, facts, dim, lt).physical_plan())


def test_a_tiny_bloom_still_joins_exactly(tmp_path):
    facts, dim, lt = _fact_and_dim(tmp_path, n=2048)
    s = TorchSession({RF_FPP: 0.5}, device="cpu")
    off = TorchSession({RF_ON: False}, device="cpu")
    assert _rows(_star(s, facts, dim, lt).collect()) == \
        _rows(_star(off, facts, dim, lt).collect())
    plan = _star(s, facts, dim, lt).physical_plan()
    list(plan.execute())
    [rf] = RF.plan_runtime_filters(plan)
    assert rf.ready and rf.n_bits == RF.bloom_params(512, 0.5)[0]


def test_explain_lists_build_and_apply_lines(tmp_path):
    facts, dim, lt = _fact_and_dim(tmp_path, n=1024)
    out = _star(TorchSession(device="cpu"), facts, dim, lt).explain()
    assert "TpuRuntimeFilterBuildExec" in out
    assert "build rf#" in out and "apply rf#" in out
    assert "ParquetScanExec.l_key" in out


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
