"""Broadcast hash joins, residual join conditions, cross and keyless
joins: the port through ``TorchSession(device="cpu")`` against the JAX
package's ``TpuSession`` on the same Parquet files.

The stream side has three files, one scan task each
(``scan.taskTargetBytes`` = 1), so a broadcast join's build side is
shared by three stream partitions.  The planner broadcasts the smaller
legal side under ``autoBroadcastJoinThresholdBytes``; -1 turns that off
and the same join runs partition-wise (keyed) or wide (keyless).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol

from spark_rapids_tpu_torch import TorchSession, col
from spark_rapids_tpu_torch.execs.join import (
    TpuBroadcastHashJoinExec,
    TpuShuffledHashJoinExec,
)

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
BCAST = "spark.rapids.tpu.sql.autoBroadcastJoinThresholdBytes"
ADAPTIVE = "spark.rapids.tpu.sql.adaptive.enabled"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """big: 3 files of 120 rows (l_k in 0..29 with NULLs, l_v); small:
    one file of 40 rows (r_k, r_v)."""
    d = tmp_path_factory.mktemp("bcast")
    rng = np.random.default_rng(21)

    def write(name, prefix, n):
        keys = rng.integers(0, 30, n)
        t = pa.table({f"{prefix}_k": pa.array(keys, pa.int64(),
                                              mask=rng.random(n) < 0.1),
                      f"{prefix}_v": rng.integers(-50, 50, n)})
        p = str(d / f"{name}.parquet")
        pq.write_table(t, p)
        return p

    return {"big": [write(f"big{i}", "l", 120) for i in range(3)],
            "small": [write("small", "r", 40)]}


def _frames(session, files, small_left):
    big = session.read_parquet(*files["big"])
    small = session.read_parquet(*files["small"])
    return (small, big) if small_left else (big, small)


def _keys(c, small_left):
    lk, rk = ("r_k", "l_k") if small_left else ("l_k", "r_k")
    return dict(left_on=[c(lk)], right_on=[c(rk)])


def _rows(table):
    return sorted((tuple(r.values()) for r in table.to_pylist()), key=repr)


def _jax(files, how, small_left=False, keyed=True, condition=None):
    left, right = _frames(TpuSession(), files, small_left)
    kw = _keys(jcol, small_left) if keyed else {}
    return _rows(left.join(right, how=how, condition=condition, **kw)
                 .collect())


def _port(files, how, conf=None, small_left=False, keyed=True,
          condition=None):
    s = TorchSession({TTB: 1, **(conf or {})}, device="cpu")
    left, right = _frames(s, files, small_left)
    kw = _keys(col, small_left) if keyed else {}
    df = left.join(right, how=how, condition=condition, **kw)
    return df.physical_plan(), _rows(df.collect())


def _port_run(files, how, conf=None, condition=None):
    """The plan after its run (its adaptive decision taken), and the
    rows."""
    from spark_rapids_tpu_torch.plan.planner import collect_exec

    s = TorchSession({TTB: 1, **(conf or {})}, device="cpu")
    left, right = _frames(s, files, False)
    plan = left.join(right, how=how, condition=condition,
                     **_keys(col, False)).physical_plan()
    return plan, _rows(collect_exec(plan, s.conf))


@pytest.mark.parametrize("how,side", [
    ("inner", "right"), ("inner", "left"), ("left_outer", "right"),
    ("left_semi", "right"), ("left_anti", "right"), ("right_outer", "left")])
def test_broadcast_join_matches_jax(files, how, side):
    small_left = side == "left"
    plan, got = _port(files, how, small_left=small_left)
    assert isinstance(plan, TpuBroadcastHashJoinExec)
    assert plan.build_is_right == (side == "right")
    assert plan.num_partitions == 3  # the stream side's scan tasks
    want = _jax(files, how, small_left=small_left)
    assert len(want) > 0 and got == want


def test_broadcast_build_side_is_collected_once(files):
    s = TorchSession({TTB: 1}, device="cpu")
    big, small = _frames(s, files, False)
    plan = big.join(small, **_keys(col, False)).physical_plan()
    build = plan.children[1]
    calls = []
    real = build.execute

    def counting():
        calls.append(1)
        return real()

    build.execute = counting
    out = [b for p in range(plan.num_partitions)
           for b in plan.execute_partition(p)]
    assert len(calls) == 1 and sum(b.num_rows for b in out) > 0
    plan.close()
    assert plan._build is None


def test_full_outer_never_broadcasts(files):
    # the static plan; the adaptive join's case is the test below
    plan, got = _port(files, "full_outer", {ADAPTIVE: False})
    assert isinstance(plan, TpuShuffledHashJoinExec) and plan.partition_wise
    assert got == _jax(files, "full_outer")
    with pytest.raises(ValueError):
        TpuBroadcastHashJoinExec([col("l_k")], [col("r_k")], "full_outer",
                                 plan.children[0], plan.children[1], 100)


def test_full_outer_never_broadcasts_at_runtime(files):
    """Under the adaptive join (the default) a full outer join stays
    shuffled whatever its measured bytes: no side may build."""
    from spark_rapids_tpu_torch.execs.adaptive import TpuAdaptiveJoinExec

    plan, got = _port_run(files, "full_outer", {BCAST: 1 << 30})
    assert isinstance(plan, TpuAdaptiveJoinExec)
    assert plan.decision.startswith("shuffled"), plan.decision
    assert plan.metrics["adaptiveBroadcasts"] == 0
    assert got == _jax(files, "full_outer")


@pytest.mark.parametrize("bcast", [10 << 20, -1],
                         ids=["broadcast", "partition_wise"])
def test_residual_condition_on_an_inner_join(files, bcast):
    # the static plans; the adaptive join's case is the test below
    plan, got = _port(files, "inner", {BCAST: bcast, ADAPTIVE: False},
                      condition=col("l_v") > col("r_v"))
    assert isinstance(plan, TpuBroadcastHashJoinExec if bcast > 0
                      else TpuShuffledHashJoinExec)
    assert plan.condition is not None
    if bcast < 0:
        assert plan.partition_wise
    want = _jax(files, "inner", condition=jcol("l_v") > jcol("r_v"))
    unconditioned = _jax(files, "inner")
    assert 0 < len(want) < len(unconditioned) and got == want


def test_residual_condition_under_the_adaptive_join(files):
    """Broadcast off: an adaptive join carrying the condition into the
    partition-wise join it decides on."""
    from spark_rapids_tpu_torch.execs.adaptive import TpuAdaptiveJoinExec

    plan, got = _port_run(files, "inner", {BCAST: -1},
                          condition=col("l_v") > col("r_v"))
    assert isinstance(plan, TpuAdaptiveJoinExec)
    assert plan.condition is not None
    assert plan.decision.startswith("shuffled"), plan.decision
    want = _jax(files, "inner", condition=jcol("l_v") > jcol("r_v"))
    assert 0 < len(want) < len(_jax(files, "inner")) and got == want


@pytest.mark.parametrize("bcast", [10 << 20, -1], ids=["broadcast", "wide"])
def test_cross_join(files, bcast):
    plan, got = _port(files, "cross", {BCAST: bcast}, keyed=False)
    assert isinstance(plan, TpuBroadcastHashJoinExec if bcast > 0
                      else TpuShuffledHashJoinExec)
    if bcast < 0:
        assert not plan.partition_wise
    assert len(got) == 360 * 40
    assert got == _jax(files, "cross", keyed=False)


@pytest.mark.parametrize("bcast", [10 << 20, -1], ids=["broadcast", "wide"])
def test_keyless_conditional_inner_join(files, bcast):
    plan, got = _port(files, "inner", {BCAST: bcast}, keyed=False,
                      condition=(col("l_v") < col("r_v"))
                      & (col("r_v") < col("l_v") + col("l_k")))
    assert isinstance(plan, TpuBroadcastHashJoinExec if bcast > 0
                      else TpuShuffledHashJoinExec)
    want = _jax(files, "inner", keyed=False,
                condition=(jcol("l_v") < jcol("r_v"))
                & (jcol("r_v") < jcol("l_v") + jcol("l_k")))
    assert 0 < len(want) < 360 * 40 and got == want


def test_cross_join_with_an_empty_side_is_empty(files):
    s = TorchSession(device="cpu")
    big, small = _frames(s, files, False)
    small = small.where(col("r_v") > col("r_v"))
    assert big.join(small, how="cross").collect().num_rows == 0
    assert small.join(big, how="cross").collect().num_rows == 0


def test_condition_columns_survive_scan_pruning(files):
    """The residual condition reads a column neither the keys nor the
    output use: the planner must still read it."""
    s = TorchSession({TTB: 1}, device="cpu")
    big, small = _frames(s, files, False)
    df = (big.join(small, condition=col("l_v") > col("r_v"),
                   **_keys(col, False))
          .select(col("l_k")))
    got = sorted(df.collect().column("l_k").to_pylist())
    tb = TpuSession()
    jbig, jsmall = _frames(tb, files, False)
    want = sorted(jbig.join(jsmall, condition=jcol("l_v") > jcol("r_v"),
                            **_keys(jcol, False))
                  .select(jcol("l_k")).collect().column("l_k").to_pylist())
    assert got == want and len(got) > 0


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
