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
#: host threads running an exchange's map tasks, and a coalesce's
#: partitions, at once (1: one after another on the caller's thread)
TASK_THREADS = "spark.rapids.tpu.sql.taskThreads"
#: host threads decoding the files of one scan task at once
DECODE_THREADS = "spark.rapids.tpu.sql.scan.decodeThreads"
#: tasks that may hold device batches at once (the task semaphore's
#: permits, ``memory/semaphore.py``)
CONCURRENT_TASKS = "spark.rapids.tpu.sql.concurrentTpuTasks"
#: run a scan's decode and upload, and the result fetch, as bounded
#: background stages (``parallel/pipeline.py``); off, they run inline
PIPELINE_ENABLED = "spark.rapids.tpu.sql.pipeline.enabled"
#: items each such stage may hold ahead of its consumer
PIPELINE_DEPTH = "spark.rapids.tpu.sql.pipeline.depth"

DEFAULTS: dict[str, Any] = {
    SHUFFLE_PARTITIONS: 8,
    TASK_TARGET_BYTES: 512 << 20,
    BATCH_ROWS: 1 << 20,
    JOIN_OUTPUT_CHUNK_ROWS: 1 << 22,
    SORT_RANGE_EXCHANGE: True,
    SORT_SAMPLES_PER_BATCH: 128,
    BROADCAST_THRESHOLD: 10 << 20,
    RF_ENABLED: True,
    TASK_THREADS: 4,
    DECODE_THREADS: 4,
    CONCURRENT_TASKS: 2,
    PIPELINE_ENABLED: True,
    PIPELINE_DEPTH: 2,
}

#: the keys that run a query serially: every task, file and stage one
#: after another on the caller's thread
SERIAL: dict[str, Any] = {TASK_THREADS: 1, DECODE_THREADS: 1,
                          PIPELINE_ENABLED: False}


_AT_LEAST_ONE = (TASK_THREADS, DECODE_THREADS, CONCURRENT_TASKS,
                 PIPELINE_DEPTH)


class TorchConf:
    """Key/value settings with the defaults above; unknown keys raise."""

    def __init__(self, values: Optional[dict[str, Any]] = None):
        self._values: dict[str, Any] = {}
        for k, v in (values or {}).items():
            self.set(k, v)

    def set(self, key: str, value: Any) -> "TorchConf":
        if key not in DEFAULTS:
            raise KeyError(f"unknown conf key {key!r}")
        value = type(DEFAULTS[key])(value)
        if key in _AT_LEAST_ONE and value < 1:
            raise ValueError(f"{key} must be >= 1, got {value}")
        self._values[key] = value
        return self

    def get(self, key: str) -> Any:
        if key not in DEFAULTS:
            raise KeyError(f"unknown conf key {key!r}")
        return self._values.get(key, DEFAULTS[key])
