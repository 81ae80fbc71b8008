"""Speculative output sizing (``parallel/speculation.py``) on the CPU,
held against the JAX package's ``spark_rapids_tpu.parallel.speculation``
on the same numpy-seeded inputs.

- ``pad_capacity`` and the ``SizePredictor``'s bucket sequences equal
  the JAX ones under its ``pow2`` policy (the port's only one), at
  warm-up 1 and 3 and a forced capacity;
- the join, every type: speculation on = off = the JAX exec with
  speculation on (rows as multisets, exact), at forced under- and
  overshoots and over an empty build side; warm-up pays the blocking
  read, the steady state pays none, off pays one a stream batch;
- the group-by at capacity equals the exact group-by and the JAX one;
  the aggregate and the exchange with speculation on = off = the JAX
  package (integer sums exact, floats through ``approx_float``);
- an injected ``exec.batch`` fault in a speculated loop re-dispatches
  with the same rows, and no count is observed twice;
- the kill switch convicts a cold tag and is off by default; the
  ledger's ``live_capacity_ratio`` is below 1 for a speculated program
  and 1.0 off;
- q3, q1 and q93 through ``TorchSession(device="cpu")`` with
  speculation engaged equal the JAX package's results.
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import bench
from spark_rapids_tpu.columnar import column as JC
from spark_rapids_tpu.columnar.arrow import to_arrow as jto_arrow
from spark_rapids_tpu.config import get_conf, set_conf
from spark_rapids_tpu.execs.join import TpuShuffledHashJoinExec as JJoin
from spark_rapids_tpu.io.scan import ArrowSourceExec as JSource
from spark_rapids_tpu.parallel import pipeline as JP
from spark_rapids_tpu.parallel import speculation as JS
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import sum_ as jsum
from spark_rapids_tpu.tools import tpcds_schema

from differential import assert_tables_equal
from spark_rapids_tpu_torch import TorchSession, col, sum_, tpcds, tpch
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import trace as PT
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import (
    from_arrow,
    from_numpy_columns,
    schema_from_arrow,
    to_arrow,
)
from spark_rapids_tpu_torch.columnar.column import MIN_CAPACITY, pad_capacity
from spark_rapids_tpu_torch.execs import retry as R
from spark_rapids_tpu_torch.execs.base import TaskRuntime
from spark_rapids_tpu_torch.execs.basic import TpuBatchSourceExec
from spark_rapids_tpu_torch.execs.join import TpuShuffledHashJoinExec
from spark_rapids_tpu_torch.io.scan import ArrowSourceExec
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.ops.groupby import (
    AggSpec,
    groupby_aggregate,
    groupby_aggregate_at_capacity,
)
from spark_rapids_tpu_torch.parallel import pipeline as P
from spark_rapids_tpu_torch.parallel import speculation as SP
from spark_rapids_tpu_torch.parallel.speculation import SpeculationPolicy
from spark_rapids_tpu_torch.robustness import faults
from spark_rapids_tpu_torch.trace import ledger as PL
from test_torch_q93 import JAX as Q93_JAX
from test_torch_q93 import SCALE as Q93_SCALE
from test_torch_q93 import SEED as Q93_SEED
from test_torch_q93 import THRESHOLD as Q93_THRESHOLD
from test_torch_q93 import _q93

ENABLED = "spark.rapids.tpu.sql.speculation.enabled"
WARMUP = "spark.rapids.tpu.sql.speculation.warmupBatches"
FORCE = "spark.rapids.tpu.sql.speculation.testForceCapacity"
POLICY = "spark.rapids.tpu.sql.capacity.policy"
CHUNK = 1 << 22
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_speculation_state():
    """Predictors and counters are process-wide and keyed structurally,
    in both packages: a join warmed by one test must not pre-warm the
    same join in the next."""
    for m in (SP, JS):
        m.reset_predictors()
        m.reset_stats()
    yield
    for m in (SP, JS):
        m.reset_predictors()
        m.reset_stats()


def _jax_set(**keys) -> None:
    conf = get_conf()
    for k, v in keys.items():
        conf.set(k, v)
    set_conf(conf)


# --------------------------------------------------------------------- #
# pad_capacity and the predictor
# --------------------------------------------------------------------- #


def _boundaries() -> list[int]:
    out = {0, 1, MIN_CAPACITY - 1, MIN_CAPACITY, MIN_CAPACITY + 1}
    c = MIN_CAPACITY
    while c <= 1 << 21:
        mid = 3 * (c >> 2)
        out |= {c - 1, c, c + 1, mid - 1, mid, mid + 1}
        c <<= 1
    return sorted(n for n in out if n >= 0)


def test_pad_capacity_equals_jax():
    rng = np.random.default_rng(20)
    ns = _boundaries() + rng.integers(0, (1 << 20) + 1, 2000).tolist()
    _jax_set(**{POLICY: "pow2"})
    got = [pad_capacity(int(n)) for n in ns]
    want = [JC.pad_capacity(int(n)) for n in ns]
    assert got == want
    assert all(c >= max(n, MIN_CAPACITY) for c, n in zip(got, ns))


@pytest.mark.parametrize("force", [0, 20])
@pytest.mark.parametrize("warmup", [1, 3])
def test_size_predictor_buckets_equal_jax(warmup, force):
    rng = np.random.default_rng(100 * warmup + force)
    counts = np.concatenate([rng.lognormal(8, 1.5, 40),
                             rng.integers(0, 5, 5)]).astype(np.int64)
    _jax_set(**{POLICY: "pow2", WARMUP: warmup, FORCE: force})
    policy_ = SpeculationPolicy(warmup_batches=warmup, force_capacity=force)
    port, jax_ = SP.predictor(("t", warmup, force)), \
        JS.predictor(("t", warmup, force))
    got, want = [], []
    for n in counts.tolist():
        got.append((port.predict(policy_), port.predict(policy_, 64)))
        want.append((jax_.predict(), jax_.predict(cap_ceiling=64)))
        port.observe(n)
        jax_.observe(n)
    assert got == want
    assert got[:warmup] == [(None, None)] * warmup
    assert all(g[0] is not None for g in got[warmup:])


def test_predictor_shared_by_key_and_reset():
    assert SP.predictor(("a", 1)) is SP.predictor(("a", 1))
    assert SP.predictor(("a", 1)) is not SP.predictor(("a", 2))
    p = SP.predictor(("a", 1))
    p.observe(5)
    SP.reset_predictors()
    assert SP.predictor(("a", 1)).observations == 0


def test_stats_hit_rate_and_trace_instants():
    PT.enable()
    PT.clear()
    try:
        with P.trace_events() as events:
            SP.record_hit("join.probe", 16, 10)
            SP.record_hit("join.probe", 16, 12)
            SP.record_overflow("join.probe", 16, 40)
            SP.record_sync("agg.size")
        names = [e.name for e in PT.snapshot()]
    finally:
        PT.disable()
        PT.clear()
    assert SP.stats() == {
        "join.probe": {"hits": 2, "overflows": 1, "synced": 0,
                       "declined": 0},
        "agg.size": {"hits": 0, "overflows": 0, "synced": 1,
                     "declined": 0}}
    assert SP.hit_rate() == SP.hit_rate(("join.probe",)) == 0.667
    assert events == [("spec_hit", "join.probe")] * 2 + [
        ("spec_overflow", "join.probe")]
    assert names == ["speculation.hit"] * 2 + ["speculation.overflow"]


# --------------------------------------------------------------------- #
# The join
# --------------------------------------------------------------------- #


def _join_tables(n_stream=200, dup=2, with_nulls=True):
    """The JAX test's tables: some stream keys match nothing, some
    build rows match nothing, NULL keys never match."""
    rng = np.random.default_rng(11)
    k = rng.integers(0, 50, n_stream).astype(np.int64).tolist()
    if with_nulls:
        for i in range(0, n_stream, 17):
            k[i] = None
    left = pa.table({"k": pa.array(k, pa.int64()),
                     "v": pa.array(rng.integers(0, 1000, n_stream),
                                   pa.int64())})
    right = pa.table({"k": np.repeat(np.arange(10, 60, dtype=np.int64), dup),
                      "w": np.arange(50 * dup, dtype=np.int64)})
    return left, right


def _runtime(policy: SpeculationPolicy, depth: int = 2,
             retry: R.RetryPolicy = R.DEFAULT_POLICY) -> TaskRuntime:
    """A serial runtime with the default stage depth (lookahead 1, the
    JAX default)."""
    return TaskRuntime(TpuSemaphore(1), stage_depth=depth, retry=retry,
                       speculation=policy)


def _port_join(join_type, left, right, policy, batch_rows=32,
               retry=R.DEFAULT_POLICY, depth=2):
    rt = _runtime(policy, depth, retry)
    lsrc = ArrowSourceExec(left, schema_from_arrow(left.schema), CPU,
                           batch_rows, runtime=rt)
    rsrc = ArrowSourceExec(right, schema_from_arrow(right.schema), CPU,
                           1 << 20, runtime=rt)
    return TpuShuffledHashJoinExec([col("k")], [col("k")], join_type, lsrc,
                                   rsrc, CHUNK, runtime=rt)


def _jax_join(join_type, left, right, batch_rows=32):
    return JJoin([jcol("k")], [jcol("k")], join_type,
                 JSource(left, batch_rows=batch_rows), JSource(right))


def _rows(batches, convert) -> Counter:
    out = Counter()
    for b in batches:
        t = convert(b)
        out.update(zip(*[c.to_pylist() for c in t.columns]))
    return out


def _port_rows(exec_) -> Counter:
    return _rows(exec_.execute(), to_arrow)


def _jax_rows(exec_) -> Counter:
    return _rows(exec_.execute(), jto_arrow)


ALL_JOIN_TYPES = ("inner", "left_outer", "right_outer", "full_outer",
                  "left_semi", "left_anti", "cross")
ON, OFF = SpeculationPolicy(), SpeculationPolicy(enabled=False)


@pytest.mark.parametrize("join_type", ALL_JOIN_TYPES)
def test_join_on_equals_off_equals_jax(join_type):
    n = 60 if join_type == "cross" else 200
    left, right = _join_tables(n_stream=n)
    _jax_set(**{ENABLED: True})
    want = _jax_rows(_jax_join(join_type, left, right))
    ex = _port_join(join_type, left, right, ON)
    on = _port_rows(ex)
    off = _port_rows(_port_join(join_type, left, right, OFF))
    assert on == off == want
    assert sum(want.values()) > 0 or join_type == "left_anti"
    if join_type in ("inner", "left_outer", "full_outer"):
        # the left side streams 7 batches: those past the warm-up
        # prefix (2) speculated (cross streams 2, right_outer's right
        # side 1: warm-up only)
        assert ex.metrics["specHits"] + ex.metrics["specOverflows"] == 5


@pytest.mark.parametrize("join_type", ("inner", "left_outer", "full_outer"))
def test_join_forced_undershoot_continues(join_type):
    left, right = _join_tables(n_stream=128, dup=8)
    _jax_set(**{ENABLED: True, FORCE: 8})
    want = _jax_rows(_jax_join(join_type, left, right))
    ex = _port_join(join_type, left, right,
                    SpeculationPolicy(force_capacity=8))
    on = _port_rows(ex)
    assert ex.metrics["specOverflows"] > 0
    assert ex.metrics["specContinuationChunks"] >= ex.metrics["specOverflows"]
    assert on == _port_rows(_port_join(join_type, left, right, OFF)) == want


@pytest.mark.parametrize("force", [8, 64, 1 << 10])
def test_join_chunks_are_the_blocking_paths(force):
    """Hit, undershoot or not speculated, a stream batch's output comes
    in the blocking path's chunks (outputChunkRows 100 here), row for
    row: what runs above the join sees the same batches."""
    left, right = _join_tables(n_stream=320, dup=8)

    def chunks(policy):
        ex = _port_join("inner", left, right, policy)
        ex.chunk_rows = 100
        return ex, [to_arrow(b) for b in ex.execute()]

    ex, on = chunks(SpeculationPolicy(force_capacity=force))
    _, off = chunks(OFF)
    assert [t.num_rows for t in on] == [t.num_rows for t in off]
    assert all(a.equals(b) for a, b in zip(on, off))
    assert max(t.num_rows for t in on) == 100
    m = ex.metrics
    assert m["specHits"] + m["specOverflows"] == 8
    if force == 8:
        assert m["specOverflows"] == 8


def test_join_past_the_inflight_budget_reads_blocking(monkeypatch):
    """A speculated chunk that would pass MAX_INFLIGHT_BYTES is not
    made: the batch reads its count blocking (``declined``).  With room
    for one chunk of 7 joined rows, one is in flight at a time."""
    left, right = _join_tables(n_stream=320)
    want = _port_rows(_port_join("inner", left, right, OFF))
    # 36 bytes a joined row: two LONG columns a side with validity
    monkeypatch.setattr(SP, "MAX_INFLIGHT_BYTES", 0)
    ex = _port_join("inner", left, right, ON)
    with P.trace_events() as events:
        assert _port_rows(ex) == want
    ev, dispatches = _probe_events(events)
    st = SP.stats()["join.probe"]
    assert ev.count("readback") == dispatches == 10
    assert (st["synced"], st["declined"], st["hits"]) == (2, 8, 0)
    monkeypatch.setattr(SP, "MAX_INFLIGHT_BYTES", 8 * 36)
    ex = _port_join("inner", left, right,
                    SpeculationPolicy(force_capacity=8))
    assert _port_rows(ex) == want
    # lookahead 1: batch k+1 dispatches while k's chunk is in flight
    assert ex.metrics["specOverflows"] == 5
    assert SP.inflight_bytes() == 0


def test_a_closed_join_gives_its_inflight_bytes_back():
    left, right = _join_tables(n_stream=320)
    _port_rows(_port_join("inner", left, right, ON))  # warm
    it = _port_join("inner", left, right, ON).execute()
    next(it)
    assert SP.inflight_bytes() > 0  # the next batch's chunk
    it.close()
    assert SP.inflight_bytes() == 0


def test_join_forced_overshoot_has_no_dead_rows():
    left, right = _join_tables(n_stream=128)
    _jax_set(**{ENABLED: True, FORCE: 1 << 14})
    want = _jax_rows(_jax_join("inner", left, right))
    ex = _port_join("inner", left, right,
                    SpeculationPolicy(force_capacity=1 << 14))
    batches = list(ex.execute())
    assert ex.metrics["specHits"] > 0 and ex.metrics["specOverflows"] == 0
    # every row came cut to its count: no NULL-keyed (dead) row
    assert all(bool(b.columns[0].validity.all()) for b in batches)
    on = _rows(batches, to_arrow)
    assert on == _port_rows(_port_join("inner", left, right, OFF)) == want


@pytest.mark.parametrize("join_type", ("inner", "left_outer", "left_anti"))
def test_join_empty_build_side(join_type):
    left, _ = _join_tables(n_stream=96)
    empty = pa.table({"k": pa.array([], pa.int64()),
                      "w": pa.array([], pa.int64())})
    _jax_set(**{ENABLED: True})
    want = _jax_rows(_jax_join(join_type, left, empty))
    on = _port_rows(_port_join(join_type, left, empty, ON))
    assert on == _port_rows(_port_join(join_type, left, empty, OFF)) == want
    assert sum(on.values()) == (0 if join_type == "inner" else 96)


def _probe_events(events) -> tuple[list, int]:
    """(the join.probe events, the join's stream dispatches)."""
    return ([k for k, t in events if t == "join.probe"],
            sum(1 for k, t in events
                if k == "dispatch" and t == "join.stream"))


def test_join_warmup_batches_pay_the_sync():
    """warmupBatches 3, lookahead 1: the first 4 dispatches come before
    the predictor has 3 observations, so exactly 4 blocking reads."""
    left, right = _join_tables(n_stream=320)
    with P.trace_events() as events:
        on = _port_rows(_port_join("inner", left, right,
                                   SpeculationPolicy(warmup_batches=3)))
    ev, dispatches = _probe_events(events)
    assert ev.count("readback") == 4
    assert ev.count("spec_hit") + ev.count("spec_overflow") \
        == dispatches - 4
    assert on == _port_rows(_port_join("inner", left, right, OFF))


def test_join_steady_state_has_no_blocking_sizing_read():
    left, right = _join_tables(n_stream=480)
    assert C.DEFAULTS[C.SPECULATION_ENABLED] is True
    ex = _port_join("inner", left, right, SpeculationPolicy())
    with P.trace_events() as events:
        got = _port_rows(ex)
    ev, dispatches = _probe_events(events)
    assert dispatches >= 10
    # the warm-up prefix: warmupBatches (1) + the lookahead (1)
    assert ev.count("readback") == 2
    first = next(i for i, k in enumerate(ev)
                 if k in ("spec_hit", "spec_overflow"))
    assert "readback" not in ev[first:]
    assert ev.count("spec_hit") + ev.count("spec_overflow") \
        == dispatches - 2
    assert ex.metrics["specHits"] + ex.metrics["specOverflows"] \
        == dispatches - 2
    assert ev.count("readback_async") == dispatches - 2
    assert sum(got.values()) > 0


def test_join_speculation_off_reads_once_a_batch():
    left, right = _join_tables(n_stream=160)
    with P.trace_events() as events:
        _port_rows(_port_join("inner", left, right, OFF))
    ev, dispatches = _probe_events(events)
    assert set(ev) == {"readback"}
    assert ev.count("readback") == dispatches > 0
    assert SP.stats() == {}


def test_join_over_a_batch_source():
    """TpuBatchSourceExec feeds the join exactly the batches given."""
    left, right = _join_tables(n_stream=200)
    lschema = schema_from_arrow(left.schema)
    batches = [from_arrow(left.slice(i, 40), CPU) for i in range(0, 200, 40)]
    src = TpuBatchSourceExec(batches, lschema)
    assert src.num_partitions == 1 and src.leaf_device() == CPU
    rt = _runtime(ON)
    rsrc = ArrowSourceExec(right, schema_from_arrow(right.schema), CPU,
                           1 << 20, runtime=rt)
    ex = TpuShuffledHashJoinExec([col("k")], [col("k")], "inner", src,
                                 rsrc, CHUNK, runtime=rt)
    got = _port_rows(ex)
    assert got == _port_rows(_port_join("inner", left, right, OFF, 40))
    assert ex.metrics["specHits"] + ex.metrics["specOverflows"] == 3


# --------------------------------------------------------------------- #
# The group-by at capacity, the aggregate and the exchange
# --------------------------------------------------------------------- #


def _groupby_batch(n: int, coded: bool):
    rng = np.random.default_rng(7 + coded)
    k = rng.integers(0, 30, n).astype(np.int64)
    data = {"k": (k, rng.random(n) > 0.1),
            "s": (np.array(["x", "yy", "zzz"])[rng.integers(0, 3, n)],
                  rng.random(n) > 0.2),
            "v": (rng.normal(size=n), rng.random(n) > 0.1),
            "w": (rng.integers(-9, 9, n).astype(np.int64),
                  np.ones(n, bool))}
    schema = T.Schema([T.Field("k", T.LONG), T.Field("s", T.STRING),
                       T.Field("v", T.DOUBLE), T.Field("w", T.LONG)])
    b = from_numpy_columns(data, schema, CPU)
    if coded:
        t = to_arrow(b)
        t = t.set_column(1, "s", t["s"].dictionary_encode())
        b = from_arrow(t, CPU)
    return b


@pytest.mark.parametrize("coded", [False, True], ids=["sort", "coded"])
def test_groupby_at_capacity_equals_the_exact_group_by(coded):
    b = _groupby_batch(700, coded)
    keys = [1] if coded else [0, 1]
    specs = [AggSpec("sum", 2), AggSpec("count", 2), AggSpec("min", 2),
             AggSpec("max", 3), AggSpec("first", 3), AggSpec("last_any", 2),
             AggSpec("count_star", 0), AggSpec("sum", 3)]
    fields = [b.schema.fields[i] for i in keys] + [
        T.Field(f"a{i}", T.LONG if s.op.startswith("count") or s.ordinal == 3
                else T.DOUBLE) for i, s in enumerate(specs)]
    schema = T.Schema(fields)
    exact = groupby_aggregate(b, keys, specs, schema)
    part, count = groupby_aggregate_at_capacity(b, keys, specs, schema)
    assert int(count) == exact.num_rows
    assert part.num_rows == (min(4 * 1, 700) if coded else 700)
    assert to_arrow(part.slice_prefix(int(count))).equals(to_arrow(exact))
    # the dead groups have no rows
    n = int(count)
    assert part.columns[len(keys) + 6].data[n:].eq(0).all()
    empty = b.slice(0, 0)
    part0, count0 = groupby_aggregate_at_capacity(empty, keys, specs, schema)
    assert part0.num_rows == 0 and int(count0) == 0


def _agg_table(n=4096, keys=64, floats=False):
    rng = np.random.default_rng(5)
    v = rng.normal(0, 100, n) if floats \
        else rng.integers(0, 1000, n).astype(np.int64)
    return pa.table({"k": rng.integers(0, keys, n).astype(np.int64),
                     "v": v})


def _agg_run(table, keys, engine):
    if engine == "jax":
        conf = get_conf()
        for k, v in keys.items():
            conf.set(k, v)
        set_conf(conf)
        df = TpuSession(conf).create_dataframe(table)
        return df.group_by(jcol("k")).agg((jsum(jcol("v")), "sv")) \
            .collect(engine="tpu")
    s = TorchSession(keys, device="cpu")
    return s.create_dataframe(table).group_by(col("k")).agg(
        (sum_(col("v")), "sv")).collect()


def _sorted(t):
    return t.sort_by([("k", "ascending")])


def _significant(table: pa.Table, digits: int = 12) -> pa.Table:
    """Float columns to ``digits`` significant digits: the engines sum
    in different orders (``tests/test_torch_q1.py``'s rule)."""
    cols = []
    for c in table.columns:
        if pa.types.is_floating(c.type):
            c = pa.array([None if v is None else float(f"{v:.{digits - 1}e}")
                          for v in c.to_pylist()], c.type)
        cols.append(c)
    return pa.Table.from_arrays(cols, names=table.schema.names)


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("floats", [False, True], ids=["long", "double"])
def test_aggregate_on_equals_off_equals_jax(parts, floats):
    table = _agg_table(floats=floats)
    keys = {C.BATCH_ROWS: 256, C.SHUFFLE_PARTITIONS: parts}
    want = _agg_run(table, {**keys, ENABLED: True}, "jax")
    P.reset_stage_counters()
    with P.trace_events() as events:
        on = _agg_run(table, keys, "port")
    stages = P.stage_snapshot()
    off = _agg_run(table, {**keys, C.SPECULATION_ENABLED: False}, "port")
    assert _sorted(on).equals(_sorted(off))
    if floats:
        assert_tables_equal(_significant(on), _significant(want),
                            approx_float=True)
    else:
        assert _sorted(on).equals(_sorted(want))
    agg = [k for k, t in events if t == "agg.size"]
    st = SP.stats()["agg.size"]
    # past the warm-up, the partials' counts ride async reads
    assert agg.count("readback_async") == st["hits"] + st["overflows"] > 0
    assert agg.count("readback") == st["synced"] \
        == stages["agg.size"]["readbacks"]
    if parts > 1:
        assert stages["exchange.split"]["readbacks"] == 0
        assert stages["exchange.split"]["async_readbacks"] > 0


def _one_task_agg(tmp_path, table, keys):
    """``table`` as one Parquet file of 256-row row groups, read as one
    scan task (16 batches into one complete aggregate), summed by k."""
    path = str(tmp_path / "agg.parquet")
    if not os.path.exists(path):
        pq.write_table(table, path, row_group_size=256)
    s = TorchSession({C.BATCH_ROWS: 256, C.TASK_TARGET_BYTES: 1 << 40,
                      **keys}, device="cpu")
    return _sorted(s.read_parquet(path).group_by(col("k")).agg(
        (sum_(col("v")), "sv")).collect())


@pytest.mark.parametrize("floats", [False, True], ids=["long", "double"])
def test_aggregate_merges_where_the_off_path_does(tmp_path, monkeypatch,
                                                   floats):
    """One task of 16 batches of 256 rows over 32 keys: each partial
    holds at most 32 groups, so the waiting partials reach ``goal_rows``
    (256) only every several batches.  A speculated partial is parked
    with its groups, not its capacity, so the merges happen where they
    do with speculation off, and a floating sum adds in the same order:
    on = off bit for bit."""
    from spark_rapids_tpu_torch.execs.aggregate import TpuHashAggregateExec

    merges = []
    merge = TpuHashAggregateExec._merge

    def counted(self, partial):
        merges.append((self.mode, partial.num_rows))
        return merge(self, partial)

    monkeypatch.setattr(TpuHashAggregateExec, "_merge", counted)
    table = _agg_table(n=4096, keys=32, floats=floats)
    on = _one_task_agg(tmp_path, table, {})
    merged_on = list(merges)
    st = SP.stats()["agg.size"]
    merges.clear()
    off = _one_task_agg(tmp_path, table, {C.SPECULATION_ENABLED: False})
    # warm-up 1 and lookahead 1: two blocking reads, then 14 speculated
    assert st["hits"] + st["overflows"] == 14 and st["synced"] == 2
    assert merged_on == merges
    # merges inside the loop, each of goal_rows rows or a partial more,
    # and the end's
    assert len(merges) >= 2 and {m for m, _ in merges} == {"complete"}
    assert all(256 <= n < 256 + 32 for _, n in merges[:-1])
    assert on.equals(off)


def test_aggregate_and_exchange_off_read_no_count_apart():
    table = _agg_table(n=2048, keys=32)
    keys = {C.BATCH_ROWS: 256, C.SHUFFLE_PARTITIONS: 4,
            C.SPECULATION_ENABLED: False}
    P.reset_stage_counters()
    with P.trace_events() as events:
        _agg_run(table, keys, "port")
    assert not [k for k, t in events if t == "agg.size"]
    ex = [k for k, t in events if t == "exchange.split"]
    assert set(ex) == {"readback"}
    assert SP.stats() == {}


def test_exchange_on_equals_off_equals_jax_with_async_counts():
    table = _agg_table(n=2048, keys=32)
    keys = {C.BATCH_ROWS: 256, C.SHUFFLE_PARTITIONS: 4}
    want = _agg_run(table, {**keys, ENABLED: True}, "jax")
    with P.trace_events() as events:
        on = _agg_run(table, keys, "port")
    ex = [k for k, t in events if t == "exchange.split"]
    assert ex.count("readback_async") > 0 and ex.count("readback") == 0
    off = _agg_run(table, {**keys, C.SPECULATION_ENABLED: False}, "port")
    assert _sorted(on).equals(_sorted(off)) and _sorted(on).equals(
        _sorted(want))


# --------------------------------------------------------------------- #
# The ladder, the kill switch, the ledger, the batch size
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("times,depth", [(1, 2), (2, 1)],
                         ids=["rerun", "bisect"])
def test_a_fault_in_a_speculated_dispatch_redispatches(times, depth):
    """exec.batch fails the 6th stream batch's dispatch (past the
    warm-up): once, the batch re-runs; twice (with no lookahead, so the
    second failure is the same batch's re-run), it is bisected.  Rows as
    without the fault; every count observed once, so the predictor's
    observations are the retires that succeeded."""
    left, right = _join_tables(n_stream=480)
    retry = R.RetryPolicy(backoff_s=0.0, min_split_rows=2)
    want = _port_rows(_port_join("inner", left, right, OFF))
    SP.reset_predictors()
    R.reset_retry_stats()
    faults.install(f"exec.batch:nth=6,times={times}", forced=True)
    try:
        ex = _port_join("inner", left, right, ON, retry=retry,
                        depth=depth)
        with P.trace_events() as events:
            got = _port_rows(ex)
        injected = faults.fault_stats()["exec.batch"]["injected"]
    finally:
        faults.disarm()
    st = R.retry_stats()
    R.reset_retry_stats()  # this test's own: the quiet-ladder check
    assert injected == times
    assert got == want
    _ev, dispatches = _probe_events(events)
    batches = 480 // 32
    (pred,) = [p for k, p in SP._PREDICTORS.items() if k[0] == "join.probe"]
    assert pred.observations == batches + (times - 1)
    assert st["splits"] == times - 1 and st["spill_retries"] == 1
    s = SP.stats()["join.probe"]
    assert s["hits"] + s["overflows"] + s["synced"] == pred.observations


def test_kill_switch_convicts_a_cold_tag():
    left, right = _join_tables(n_stream=480)
    total0 = SP.disabled_total()
    policy = SpeculationPolicy(force_capacity=8, min_hit_rate=0.99,
                               window=2)
    with P.trace_events() as events:
        got = _port_rows(_port_join("inner", left, right, policy))
    assert "join.probe" in SP.disabled_tags()
    assert SP.disabled_total() - total0 >= 1
    assert ("spec_disabled", "join.probe") in events
    assert not SP.tag_enabled("join.probe")
    # convicted: the next run pays the blocking read on every batch
    with P.trace_events() as events:
        again = _port_rows(_port_join("inner", left, right, policy))
    ev, dispatches = _probe_events(events)
    assert ev.count("readback") == dispatches and "readback_async" not in ev
    assert got == again == _port_rows(_port_join("inner", left, right, OFF))
    # reset_stats re-arms it; the total stays
    total = SP.disabled_total()
    SP.reset_stats()
    assert SP.tag_enabled("join.probe") and SP.disabled_total() == total


def test_kill_switch_is_off_by_default():
    assert C.DEFAULTS[C.SPECULATION_MIN_HIT_RATE] == 0.0
    left, right = _join_tables(n_stream=480, dup=8)
    _port_rows(_port_join("inner", left, right,
                          SpeculationPolicy(force_capacity=8)))
    assert SP.stats()["join.probe"]["overflows"] > 2
    assert SP.disabled_tags() == []


@pytest.fixture(scope="module")
def q3_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec_q3")
    li = tpch.make_lineitem(str(d), n_files=3, with_orderkey=True,
                            n_orders=1024, rows_per_file=2048)
    return li, tpch.make_orders(str(d), n_orders=1024)


@pytest.mark.parametrize("speculation", [True, False], ids=["on", "off"])
def test_ledger_live_capacity_ratio(q3_paths, speculation):
    s = TorchSession({C.TASK_TARGET_BYTES: 1, C.BROADCAST_THRESHOLD: -1,
                      C.SPECULATION_ENABLED: speculation}, device="cpu")
    df = tpch.q3_dataframe(s, *q3_paths)
    df.collect()  # warm the predictors
    PL.enable()
    try:
        before = PL.snapshot()
        df.collect()
        PL.LEDGER.flush(10)
        progs = PL.delta(before, PL.snapshot())
    finally:
        PL.disable()
    spec = [p for p in progs.values()
            if p["tag"] in ("join.expand", "agg.update")]
    live = sum(p["live_rows"] for p in spec)
    cap = sum(p["capacity_rows"] for p in spec)
    assert {p["tag"] for p in spec} == {"join.expand", "agg.update"}
    ratio = PL.summarize(progs)["totals"]["live_capacity_ratio"]
    if speculation:
        assert 0 < live < cap and ratio < 1.0
    else:
        assert live == cap > 0 and ratio == 1.0


# --------------------------------------------------------------------- #
# q3, q1 and q93 with speculation engaged, against the JAX package
# --------------------------------------------------------------------- #


def test_traced_speculated_run_records_the_speculation_instants(q3_paths):
    """A warm q3 with speculation on: each speculated batch records a
    speculation.hit or .overflow instant under its tag, in the query's
    trace (tests/test_torch_trace.py holds the off run's names)."""
    s = TorchSession({C.TASK_TARGET_BYTES: 1, C.BROADCAST_THRESHOLD: -1},
                     device="cpu")
    df = tpch.q3_dataframe(s, *q3_paths)
    want = df.collect()
    SP.reset_stats()
    PT.enable()
    PT.clear()
    try:
        got = df.collect()
        events = PT.snapshot()
    finally:
        PT.disable()
        PT.clear()
    assert got.equals(want)
    spec = [e for e in events if e.name.startswith("speculation.")]
    st = SP.stats()
    assert len(spec) == sum(v["hits"] + v["overflows"]
                            for v in st.values()) > 0
    assert {e.attrs["tag"] for e in spec} == {"join.probe", "agg.size"}
    assert all(e.attrs["actual"] <= e.attrs["cap"] for e in spec
               if e.name == "speculation.hit")


@pytest.fixture(scope="module")
def q93_data(tmp_path_factory):
    # test_torch_q93's catalog: its reason filter keeps a row
    cat = tpcds_schema.generate(Q93_SCALE, seed=Q93_SEED)
    d = tmp_path_factory.mktemp("spec_q93")
    sr, reason = str(d / "store_returns.parquet"), str(d / "reason.parquet")
    pq.write_table(cat["store_returns"], sr)
    pq.write_table(cat["reason"], reason)
    ss = cat["store_sales"]
    per = -(-ss.num_rows // 3)
    paths = []
    for i in range(3):
        p = str(d / f"store_sales-{i}.parquet")
        pq.write_table(ss.slice(i * per, per), p)
        paths.append(p)
    return paths, sr, reason


def _engaged(tags) -> None:
    st = SP.stats()
    assert sum(st[t]["hits"] + st[t]["overflows"] for t in tags) > 0, st


def _jax_collect(keys, make):
    conf = get_conf()
    for k, v in keys.items():
        conf.set(k, v)
    set_conf(conf)
    return make(TpuSession(conf)).collect(engine="tpu")


def test_q3_with_speculation_equals_jax(q3_paths):
    keys = {C.TASK_TARGET_BYTES: 1, C.BROADCAST_THRESHOLD: -1}
    s = TorchSession(keys, device="cpu")
    got = [tpch.q3_dataframe(s, *q3_paths).collect() for _ in range(2)]
    _engaged(("join.probe", "agg.size"))
    want = _jax_collect({**keys, ENABLED: True},
                        lambda js: bench.q3_dataframe(js, *q3_paths))
    off = tpch.q3_dataframe(TorchSession(
        {**keys, C.SPECULATION_ENABLED: False}, device="cpu"),
        *q3_paths).collect()
    assert got[0].equals(got[1]) and got[0].equals(off)
    assert_tables_equal(_significant(got[0]), _significant(want),
                        approx_float=True)


def test_q1_with_speculation_equals_jax(tmp_path):
    paths = tpch.make_lineitem(str(tmp_path), n_files=3, with_q1_cols=True,
                               rows_per_file=4096)
    keys = {C.TASK_TARGET_BYTES: 1}
    s = TorchSession(keys, device="cpu")
    got = [tpch.q1_dataframe(s, paths).collect() for _ in range(2)]
    _engaged(("agg.size",))
    want = _jax_collect({**keys, ENABLED: True},
                        lambda js: bench.q1_dataframe(js, paths))
    assert got[0].equals(got[1])
    assert_tables_equal(_significant(got[0]), _significant(want),
                        ignore_order=True, approx_float=True)


def test_q93_with_speculation_equals_jax(q93_data):
    keys = {C.TASK_TARGET_BYTES: 1, C.BROADCAST_THRESHOLD: Q93_THRESHOLD}
    s = TorchSession(keys, device="cpu")
    got = [tpcds.q93_dataframe(s, *q93_data).collect() for _ in range(2)]
    _engaged(("join.probe",))
    want = _jax_collect({**keys, ENABLED: True},
                        lambda js: _q93(Q93_JAX, js, *q93_data))
    off = tpcds.q93_dataframe(TorchSession(
        {**keys, C.SPECULATION_ENABLED: False}, device="cpu"),
        *q93_data).collect()
    assert got[0].equals(got[1]) and got[0].equals(off)
    assert_tables_equal(got[0], want, ignore_order=False, approx_float=True)


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
