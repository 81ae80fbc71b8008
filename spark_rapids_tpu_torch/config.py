"""Session configuration.

The keys and defaults are the JAX package's, so one conf dict plans the
same physical shape on both engines.  A ``TorchConf`` belongs to the
session that owns it; nothing here is process-global.
"""

from __future__ import annotations

from typing import Any, Optional

#: reduce partitions of a hash exchange (spark.sql.shuffle.partitions)
SHUFFLE_PARTITIONS = "spark.rapids.tpu.sql.shuffle.partitions"
#: target total file bytes per scan task: small files coalesce into one
#: task up to this size, a file above it is a task of its own
TASK_TARGET_BYTES = "spark.rapids.tpu.sql.scan.taskTargetBytes"
#: rows per scanned batch
BATCH_ROWS = "spark.rapids.tpu.sql.batchSizeRows"
#: most rows in one join output batch (a stream batch's pairs come in
#: chunks of at most this many)
JOIN_OUTPUT_CHUNK_ROWS = "spark.rapids.tpu.sql.join.outputChunkRows"
#: plan a multi-partition ORDER BY as a range exchange plus a sort of
#: each partition; off, the partitions coalesce into one sort
SORT_RANGE_EXCHANGE = "spark.rapids.tpu.sql.sort.rangeExchange"
#: rows sampled from each map batch for a range exchange's bounds
SORT_SAMPLES_PER_BATCH = "spark.rapids.tpu.sql.sort.samplesPerBatch"
#: largest estimated build side (bytes) a join broadcasts; -1 disables
BROADCAST_THRESHOLD = "spark.rapids.tpu.sql.autoBroadcastJoinThresholdBytes"
#: runtime join filters (plan/runtime_filter.py): a Bloom filter and the
#: min/max of an eligible join's build keys, applied in the probe scan
RF_ENABLED = "spark.rapids.tpu.sql.runtimeFilter.enabled"

DEFAULTS: dict[str, Any] = {
    SHUFFLE_PARTITIONS: 8,
    TASK_TARGET_BYTES: 512 << 20,
    BATCH_ROWS: 1 << 20,
    JOIN_OUTPUT_CHUNK_ROWS: 1 << 22,
    SORT_RANGE_EXCHANGE: True,
    SORT_SAMPLES_PER_BATCH: 128,
    BROADCAST_THRESHOLD: 10 << 20,
    RF_ENABLED: True,
}


class TorchConf:
    """Key/value settings with the defaults above; unknown keys raise."""

    def __init__(self, values: Optional[dict[str, Any]] = None):
        self._values: dict[str, Any] = {}
        for k, v in (values or {}).items():
            self.set(k, v)

    def set(self, key: str, value: Any) -> "TorchConf":
        if key not in DEFAULTS:
            raise KeyError(f"unknown conf key {key!r}")
        self._values[key] = type(DEFAULTS[key])(value)
        return self

    def get(self, key: str) -> Any:
        if key not in DEFAULTS:
            raise KeyError(f"unknown conf key {key!r}")
        return self._values.get(key, DEFAULTS[key])
