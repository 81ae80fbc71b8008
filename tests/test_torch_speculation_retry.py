"""The grouped aggregate's speculated update loop under the OOM ladder,
on the CPU (``execs/aggregate.py``, ``execs/retry.guarded_pipeline``).

A fault injected at the ``exec.batch`` seam of a speculated dispatch
re-dispatches the batch (once) or bisects it (twice, with no lookahead,
so the second failure is the same batch's re-run).  The ladder's first
answer is a spill retry, which spills the partials parked so far: that
is why these cases live apart from ``test_torch_speculation.py``, whose
module asserts that nothing spills.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu_torch import TorchSession, col, sum_
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.execs import retry as R
from spark_rapids_tpu_torch.parallel import speculation as SP
from spark_rapids_tpu_torch.robustness import faults
from torch_plugin import fresh_plugin  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh_speculation_state():
    SP.reset_predictors()
    SP.reset_stats()
    R.reset_retry_stats()
    yield
    SP.reset_predictors()
    SP.reset_stats()
    R.reset_retry_stats()


def _one_task_agg(path, keys):
    """sum(v) by k over one Parquet file of 16 row groups of 256 rows,
    read as one scan task: 16 batches into one complete aggregate."""
    s = TorchSession({C.BATCH_ROWS: 256, C.TASK_TARGET_BYTES: 1 << 40,
                      C.SPLIT_MIN_ROWS: 2, **keys}, device="cpu")
    t = s.read_parquet(path).group_by(col("k")).agg(
        (sum_(col("v")), "sv")).collect()
    return t.sort_by([("k", "ascending")])


@pytest.mark.parametrize("times,depth", [(1, 2), (2, 1)],
                         ids=["rerun", "bisect"])
def test_a_fault_in_a_speculated_aggregate_redispatches(tmp_path, times,
                                                         depth):
    """The rows are those of the run without the fault; the predictor
    observed each retire that succeeded once (a bisected batch's two
    halves are two), and the failed attempts not at all."""
    rng = np.random.default_rng(5)
    path = str(tmp_path / "agg.parquet")
    pq.write_table(pa.table({
        "k": rng.integers(0, 32, 4096).astype(np.int64),
        "v": rng.integers(0, 1000, 4096).astype(np.int64)}), path,
        row_group_size=256)
    keys = {C.PIPELINE_DEPTH: depth}
    want = _one_task_agg(path, {**keys, C.SPECULATION_ENABLED: False})
    R.reset_retry_stats()
    faults.install(f"exec.batch:nth=6,times={times}", forced=True)
    try:
        got = _one_task_agg(path, keys)
        injected = faults.fault_stats()["exec.batch"]["injected"]
    finally:
        faults.disarm()
    st = R.retry_stats()
    assert injected == times
    assert got.equals(want)
    (pred,) = [p for k, p in SP._PREDICTORS.items() if k[0] == "agg.update"]
    assert pred.observations == 16 + (times - 1)
    assert st["splits"] == times - 1 and st["spill_retries"] == 1
    s = SP.stats()["agg.size"]
    assert s["hits"] + s["overflows"] > 0
    assert s["hits"] + s["overflows"] + s["synced"] == pred.observations
