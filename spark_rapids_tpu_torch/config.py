"""Session configuration.

The keys and defaults are the JAX package's, so one conf dict plans the
same physical shape on both engines.  A ``TorchConf`` belongs to the
session that owns it; only the table of keys and defaults is shared,
and the planner adds its exec and expression switches to it
(``register``).
"""

from __future__ import annotations

from typing import Any, Optional

#: the master switch (the spark.rapids.sql.enabled analog): off, every
#: query of the session plans whole on the CPU engine
#: (``cpu/engine.py``) and nothing runs on the device
SQL_ENABLED = "spark.rapids.tpu.sql.enabled"
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
#: decide a partition-wise join's strategy, and group its reduce
#: partitions, from the bytes its two map stages measured
#: (``execs/adaptive.py``; the spark.sql.adaptive.enabled analog)
ADAPTIVE_ENABLED = "spark.rapids.tpu.sql.adaptive.enabled"
#: bytes a reduce task aims at once adjacent partitions are coalesced
ADVISORY_PARTITION_BYTES = \
    "spark.rapids.tpu.sql.adaptive.advisoryPartitionSizeBytes"
#: a reduce partition is skewed when its bytes pass this multiple of the
#: median partition's ...
SKEW_FACTOR = "spark.rapids.tpu.sql.adaptive.skewJoin.skewedPartitionFactor"
#: ... and these bytes
SKEW_THRESHOLD_BYTES = \
    "spark.rapids.tpu.sql.adaptive.skewJoin.skewedPartitionThresholdBytes"
#: runtime join filters (plan/runtime_filter.py): a Bloom filter and the
#: min/max of an eligible join's build keys, applied in the probe scan
RF_ENABLED = "spark.rapids.tpu.sql.runtimeFilter.enabled"
#: host threads running an exchange's map tasks, and a coalesce's
#: partitions, at once (1: one after another on the caller's thread)
TASK_THREADS = "spark.rapids.tpu.sql.taskThreads"
#: host threads decoding the files of one scan task at once
DECODE_THREADS = "spark.rapids.tpu.sql.scan.decodeThreads"
#: decode Parquet with the native decoder (``io/fastpar.py``), which
#: filters on the dictionaries; a file outside its scope goes to pyarrow.
#: Off by default, unlike the JAX package's key: pyarrow's reader
#: decoded faster on an H100 host (PERF.md)
FAST_DECODE = "spark.rapids.tpu.sql.scan.fastDecode"
#: upload each scanned batch in the wire form (``columnar/transfer.py``):
#: integers bias-packed, low-cardinality floats and strings as
#: dictionaries, two-decimal doubles as int32 cents, every component in
#: one pinned buffer and one copy, decoded on the device.  Off (one
#: copy per decoded column tensor) by default, unlike the JAX package's
#: key: on an H100 host the encode cost more wall than the copies it
#: saved (PERF.md)
PACKED_UPLOAD = "spark.rapids.tpu.sql.scan.packedUpload"
#: route the wire components through the codec chooser
#: (``columnar/compression/``) and decompress them on the device
WIRE_COMPRESSION = "spark.rapids.tpu.sql.wireCompression.enabled"
#: the array codecs the chooser may pick from, comma-separated
WIRE_CODECS = "spark.rapids.tpu.sql.wireCompression.codecs"
#: evaluate the Filter pushed into a scan on the host before upload
HOST_PREFILTER = "spark.rapids.tpu.sql.scan.hostPrefilter"
#: drop the device Filter over a scan when the prefilter applies all of
#: its condition (then exactly: a host evaluation failure raises)
ELIDE_DEVICE_FILTER = "spark.rapids.tpu.sql.scan.elideDeviceFilter"
#: the most bytes the native decoder decodes a row group's needed
#: columns to; past it the file goes to pyarrow
MAX_READ_BATCH_BYTES = "spark.rapids.tpu.sql.scan.maxReadBatchSizeBytes"
#: tasks that may hold device batches at once (the task semaphore's
#: permits, ``memory/semaphore.py``)
CONCURRENT_TASKS = "spark.rapids.tpu.sql.concurrentTpuTasks"
#: run a scan's decode and upload, and the result fetch, as bounded
#: background stages (``parallel/pipeline.py``); off, they run inline
PIPELINE_ENABLED = "spark.rapids.tpu.sql.pipeline.enabled"
#: items each such stage may hold ahead of its consumer
PIPELINE_DEPTH = "spark.rapids.tpu.sql.pipeline.depth"

# -- speculative output sizing (``parallel/speculation.py``) ------------- #
#: dispatch a join's expansion, and run an aggregate's update, at a
#: predicted output capacity, and read the true count back
#: asynchronously instead of blocking on it; an exchange's split counts
#: ride asynchronous readbacks too
SPECULATION_ENABLED = "spark.rapids.tpu.sql.speculation.enabled"
#: multiplier on the predicted count before it is bucketed
SPECULATION_SAFETY_FACTOR = "spark.rapids.tpu.sql.speculation.safetyFactor"
#: observed batches per program key before its predictor speculates
SPECULATION_WARMUP_BATCHES = \
    "spark.rapids.tpu.sql.speculation.warmupBatches"
#: test aid: > 0 makes a warmed predictor return this capacity's bucket
SPECULATION_TEST_FORCE_CAPACITY = \
    "spark.rapids.tpu.sql.speculation.testForceCapacity"
#: the kill switch: a tag whose hit rate over the window falls below
#: this is disabled (0.0: never)
SPECULATION_MIN_HIT_RATE = \
    "spark.rapids.tpu.sql.speculation.adaptive.minHitRate"
#: outcomes per tag the kill switch judges over
SPECULATION_WINDOW = "spark.rapids.tpu.sql.speculation.adaptive.window"

#: an ORDER BY under a LIMIT of at most this many rows plans a streaming
#: top-n (``execs/sort.py::TpuTopNExec``); a larger one a full sort
TOPN_MAX_ROWS = "spark.rapids.tpu.sql.topn.maxRows"
#: which exec metrics ``TpuExec.collect_metrics`` reports: ``ESSENTIAL``,
#: ``MODERATE`` or ``DEBUG`` (``execs/base.py::METRIC_LEVELS``)
METRICS_LEVEL = "spark.rapids.tpu.sql.metrics.level"

# -- the cost-based demotion (``plan/cost.py``) --------------------------- #
#: keep a subtree on the CPU engine when its device cost, the transfers
#: at its edges included, passes its CPU cost (off by default, as in the
#: reference)
CBO_ENABLED = "spark.rapids.tpu.sql.optimizer.enabled"
#: relative per-row cost of one operator on the CPU engine ...
CPU_ROW_COST = "spark.rapids.tpu.sql.optimizer.cpuRowCost"
#: ... on the device ...
TPU_ROW_COST = "spark.rapids.tpu.sql.optimizer.tpuRowCost"
#: ... and of moving a row across the host <-> device link
TRANSFER_ROW_COST = "spark.rapids.tpu.sql.optimizer.transferRowCost"

# -- the runtime join filters' parts (``plan/runtime_filter.py``) -------- #
#: the build keys' [min, max]: footer pruning and a host row mask
RF_MINMAX_ENABLED = "spark.rapids.tpu.sql.runtimeFilter.minMaxEnabled"
#: the build keys' Bloom filter, folded on the device, probed on the host
RF_BLOOM_ENABLED = "spark.rapids.tpu.sql.runtimeFilter.bloomEnabled"
#: no filter when the build side's estimated rows exceed this
RF_MAX_BUILD_ROWS = "spark.rapids.tpu.sql.runtimeFilter.maxBuildRows"
#: the Bloom's target false-positive rate, in (0, 1): sizes its bits
RF_FPP = "spark.rapids.tpu.sql.runtimeFilter.fpp"

#: ANSI SQL mode (the spark.sql.ansi.enabled analog): overflow in
#: Add/Subtract/Multiply and invalid/overflowing casts RAISE instead of
#: wrapping/NULLing (ref: GpuCast.scala:166 ANSI matrix; CheckOverflow)
ANSI_ENABLED = "spark.rapids.tpu.sql.ansi.enabled"

# -- the memory runtime (``memory/``, ``execs/retry.py``) ----------------- #
#: device bytes the buffer store keeps registered batches within; past
#: it a reservation spills.  On CUDA the session sizes it as
#: ``memory.fraction`` of the card's memory unless this key is set
HBM_BUDGET_BYTES = "spark.rapids.tpu.memory.hbm.budgetBytes"
#: host bytes of spilled batches before they move on to disk
HOST_SPILL_BYTES = "spark.rapids.tpu.memory.host.spillStorageSize"
#: directory of the disk tier's files ("": a temporary directory)
SPILL_DIR = "spark.rapids.tpu.memory.spill.dir"
#: share of the card's memory given to the store's device budget
MEMORY_FRACTION = "spark.rapids.tpu.memory.fraction"
#: byte codec of the spill frames (``none`` or ``zlib``)
SPILL_CODEC = "spark.rapids.tpu.memory.spill.compression.codec"
#: hold a spilled batch on the host as one frame under that codec (the
#: host budget counts the frame's bytes; a host -> disk spill writes it
#: as it is)
SPILL_COMPRESS_HOST = "spark.rapids.tpu.memory.spill.compressHostTier"
#: the card a session with no device given takes (``cuda:<ordinal>``);
#: -1, or an ordinal past the cards there are, takes card 0
DEVICE_ORDINAL = "spark.rapids.tpu.deviceOrdinal"
#: most bytes of free staging buffers the host pool keeps
#: (``memory/device_manager.py::HostBufferPool``)
HOST_POOL_BYTES = "spark.rapids.tpu.memory.hostPool.maxBytes"
#: attempts of a task, or of one batch at one size, before its failure
#: propagates
TASK_MAX_FAILURES = "spark.rapids.tpu.task.maxFailures"
#: base sleep between attempts (doubling, with +-50 % jitter)
RETRY_BACKOFF_S = "spark.rapids.tpu.task.retryBackoffSeconds"
#: on a second retryable failure of one batch, bisect it
SPLIT_RETRY_ENABLED = "spark.rapids.tpu.task.retry.splitEnabled"
#: a batch of at most this many rows is never bisected
SPLIT_MIN_ROWS = "spark.rapids.tpu.task.retry.minSplitRows"
#: rows above which a sort takes the out-of-core sample-split path
SORT_SINGLE_BATCH_ROWS = "spark.rapids.tpu.sql.sort.singleBatchRows"
#: most key-range buckets of one out-of-core sort pass
SORT_MAX_BUCKETS = "spark.rapids.tpu.sql.sort.maxBuckets"
#: plan ``TpuCoalesceBatchesExec`` under joins, aggregates, windows and
#: sorts (off: every plan is unchanged)
COALESCE_ENABLED = "spark.rapids.tpu.sql.coalesce.enabled"
#: a coalesced batch flushes once its rows reach this ...
COALESCE_TARGET_ROWS = "spark.rapids.tpu.sql.coalesce.targetRows"
#: ... or its device bytes reach this
COALESCE_TARGET_BYTES = "spark.rapids.tpu.sql.coalesce.targetBytes"
#: arm the fault-injection registry (``robustness/faults.py``) for the
#: queries of a session with this conf
FAULTS_ENABLED = "spark.rapids.tpu.robustness.faults.enabled"
#: its schedule: ``site:key=val,...;site2:...``
FAULTS_SPEC = "spark.rapids.tpu.robustness.faults.spec"
#: arm the runtime lock-order tracker (``robustness/lock_tracker.py``)
#: for the queries run with this conf
LOCK_TRACKER_ENABLED = "spark.rapids.tpu.robustness.lockTracker.enabled"

# -- the serving tier (``serving/``, ``docs/serving.md``) ---------------- #
#: queries executing at once under admission control (0: the tier is
#: off and a collect runs unscheduled); clamped to the process task
#: semaphore's permits
SERVING_MAX_CONCURRENT = "spark.rapids.tpu.serving.maxConcurrent"
#: queries that may wait for admission; one more is rejected
SERVING_QUEUE_DEPTH = "spark.rapids.tpu.serving.queueDepth"
#: weighted-fair share of a session that sets no priority
SERVING_DEFAULT_PRIORITY = "spark.rapids.tpu.serving.defaultPriority"
#: prepared exec trees a session's plan cache keeps (LRU)
PLAN_CACHE_CAPACITY = "spark.rapids.tpu.serving.planCache.capacity"
#: grant queued queries whose template is already running first
SERVING_BATCHING = "spark.rapids.tpu.serving.batching.enabled"
#: a query whose admission wait passes this (ms) is over budget: health
#: rule HC009's budget (``tools/history.py``)
SERVING_ADMIT_WAIT_BUDGET_MS = \
    "spark.rapids.tpu.serving.health.admitWaitBudgetMs"
#: cross-tenant work sharing: the result cache and shared scans
SHARING_ENABLED = "spark.rapids.tpu.serving.sharing.enabled"
#: bytes of Arrow IPC results the result cache keeps (LRU)
RESULT_CACHE_BUDGET = "spark.rapids.tpu.serving.resultCache.budgetBytes"
#: shared scans under the sharing switch
SHARING_SCANS = "spark.rapids.tpu.serving.sharing.scans"
#: bytes of decoded host tables completed shared scans keep
SCAN_CACHE_BUDGET = "spark.rapids.tpu.serving.sharing.scanCache.budgetBytes"
#: every collect carries a cancel token (``serving/cancel.py``)
CANCEL_ENABLED = "spark.rapids.tpu.serving.cancellation.enabled"
#: per-query deadline in ms from admission on (0: none)
DEADLINE_MS = "spark.rapids.tpu.serving.deadlineMs"
#: consecutive failed queries that open a tenant's breaker (0: off)
BREAKER_THRESHOLD = "spark.rapids.tpu.serving.breaker.failureThreshold"
#: how long an open breaker quarantines before its half-open probe (ms)
BREAKER_COOLDOWN_MS = "spark.rapids.tpu.serving.breaker.cooldownMs"
#: breaker trips a window of queries should stay within: health rule
#: HC013's budget
BREAKER_MAX_TRIPS = "spark.rapids.tpu.serving.breaker.health.maxTrips"

# -- observability (``trace/``, ``execs/base.py::MetricTimer``) ----------- #
#: record spans and events to per-thread rings (``trace/__init__.py``)
TRACE_ENABLED = "spark.rapids.tpu.trace.enabled"
#: events each thread's ring holds; the oldest are evicted past it
TRACE_BUFFER_SIZE = "spark.rapids.tpu.trace.bufferSize"
#: count each program's dispatches and bracket each with a pair of CUDA
#: events (``trace/ledger.py``)
LEDGER_ENABLED = "spark.rapids.tpu.trace.ledger.enabled"
#: the card's memory rate (bytes/s): the roofline's denominator
LEDGER_HBM_BYTES_PER_S = "spark.rapids.tpu.trace.ledger.hbmBytesPerSec"
#: the card's peak operation rate (ops/s)
LEDGER_PEAK_FLOPS = "spark.rapids.tpu.trace.ledger.peakFlopsPerSec"
#: the gauge sampler thread (``trace/telemetry.py``)
TELEMETRY_ENABLED = "spark.rapids.tpu.telemetry.enabled"
#: its samples a second
TELEMETRY_HZ = "spark.rapids.tpu.telemetry.hz"
#: while tracing or the ledger is on, an exec's ``totalTime`` waits for
#: the device work of its timed region (a CUDA event, waited on by the
#: metric reaper); otherwise it is host time
METRICS_DEVICE_SYNC = "spark.rapids.tpu.sql.metrics.deviceSync"
#: every ``telemetry.eventLogEvery``-th sample is appended to each
#: attached session's event log as a ``telemetry`` record
TELEMETRY_LOG_EVERY = "spark.rapids.tpu.telemetry.eventLogEvery"

# -- query history and event log (``tools/profiling.py``, ``eventlog/``) -- #
#: collected queries a session's ``history`` ring keeps
HISTORY_CAPACITY = "spark.rapids.tpu.sql.queryHistory.capacity"
#: append one JSONL record a query to a file of the session's
EVENTLOG_ENABLED = "spark.rapids.tpu.eventLog.enabled"
#: the directory of the event-log files (one a session)
EVENTLOG_DIR = "spark.rapids.tpu.eventLog.dir"
#: gzip the file, one member an append
EVENTLOG_COMPRESS = "spark.rapids.tpu.eventLog.compress"
#: with tracing on, export each query's Chrome trace beside the log
EVENTLOG_TRACE_SIDECAR = "spark.rapids.tpu.eventLog.traceSidecar"
#: the health rules' budgets (``tools/history.py``): HC011, HC012, HC014
#: and HC015 (HC009's and HC013's are the serving keys above)
LEDGER_ROOFLINE_FLOOR = "spark.rapids.tpu.trace.ledger.health.rooflineFloor"
LEDGER_OCCUPANCY_FLOOR = \
    "spark.rapids.tpu.trace.ledger.health.occupancyFloor"
RESULT_MIN_HIT_RATE = "spark.rapids.tpu.serving.resultCache.health.minHitRate"
LOCK_HOLD_BUDGET_MS = "spark.rapids.tpu.robustness.lockTracker.holdBudgetMs"

# -- the connect front door (``connect/``) ------------------------------- #
#: the largest wire frame either end accepts, checked before allocating
CONNECT_MAX_FRAME_BYTES = "spark.rapids.tpu.connect.maxFrameBytes"
#: rows a response frame holds at most (0: as the fetch stage yields)
CONNECT_BATCH_ROWS = "spark.rapids.tpu.connect.batchRows"
#: the server's SO_SNDBUF (0: the OS default)
CONNECT_SEND_BUFFER_BYTES = "spark.rapids.tpu.connect.sendBufferBytes"
#: a connection's socket timeout (s)
CONNECT_SOCKET_TIMEOUT_S = "spark.rapids.tpu.connect.socketTimeoutSeconds"

# -- the live ops plane (``obs/``) -------------------------------------- #
#: serve /metrics, /queries and /slo, keep the in-flight registry and run
#: the SLO watchdog
OBS_ENABLED = "spark.rapids.tpu.obs.enabled"
#: the endpoint's port (0: ephemeral) and bind address
OBS_PORT = "spark.rapids.tpu.obs.port"
OBS_HOST = "spark.rapids.tpu.obs.host"
#: per-tenant p99 budgets (ms) of the watchdog (0: no objective)
SLO_WALL_BUDGET_MS = "spark.rapids.tpu.obs.slo.wallBudgetMs"
SLO_ADMIT_BUDGET_MS = "spark.rapids.tpu.obs.slo.admitWaitBudgetMs"
#: the watchdog's rolling window (s) and evaluation period (ms)
SLO_WINDOW_S = "spark.rapids.tpu.obs.slo.windowSeconds"
SLO_INTERVAL_MS = "spark.rapids.tpu.obs.slo.checkIntervalMs"

# -- the warm-start store (``persist.py``) ------------------------------ #
#: keep prepared-plan metadata and result-cache frames in a validated
#: on-disk store that later processes read (off: one conf read a probe
#: site, and nothing else)
PERSIST_ENABLED = "spark.rapids.tpu.persist.enabled"
#: the store's directory ("": a per-user directory under the system's
#: temporary directory)
PERSIST_DIR = "spark.rapids.tpu.persist.dir"
#: bytes of entries the store keeps; past it the least recently used go
PERSIST_MAX_BYTES = "spark.rapids.tpu.persist.maxBytes"
#: health rule HC017's floor under the store's hit rate
PERSIST_MIN_HIT_RATE = "spark.rapids.tpu.persist.health.minHitRate"

DEFAULTS: dict[str, Any] = {
    SQL_ENABLED: True,
    SHUFFLE_PARTITIONS: 8,
    TASK_TARGET_BYTES: 512 << 20,
    BATCH_ROWS: 1 << 20,
    JOIN_OUTPUT_CHUNK_ROWS: 1 << 22,
    SORT_RANGE_EXCHANGE: True,
    SORT_SAMPLES_PER_BATCH: 128,
    BROADCAST_THRESHOLD: 10 << 20,
    ADAPTIVE_ENABLED: True,
    ADVISORY_PARTITION_BYTES: 64 << 20,
    SKEW_FACTOR: 5.0,
    SKEW_THRESHOLD_BYTES: 64 << 20,
    RF_ENABLED: True,
    TASK_THREADS: 4,
    DECODE_THREADS: 4,
    FAST_DECODE: False,
    PACKED_UPLOAD: False,
    WIRE_COMPRESSION: False,
    WIRE_CODECS: "bitpack,delta,rle",
    HOST_PREFILTER: True,
    ELIDE_DEVICE_FILTER: True,
    MAX_READ_BATCH_BYTES: 128 << 20,
    CONCURRENT_TASKS: 2,
    PIPELINE_ENABLED: True,
    PIPELINE_DEPTH: 2,
    TOPN_MAX_ROWS: 1 << 14,
    METRICS_LEVEL: "MODERATE",
    CBO_ENABLED: False,
    CPU_ROW_COST: 1.0,
    TPU_ROW_COST: 0.05,
    TRANSFER_ROW_COST: 1.5,
    RF_MINMAX_ENABLED: True,
    RF_BLOOM_ENABLED: True,
    RF_MAX_BUILD_ROWS: 1 << 22,
    RF_FPP: 0.01,
    ANSI_ENABLED: False,
    SPECULATION_ENABLED: True,
    SPECULATION_SAFETY_FACTOR: 1.5,
    SPECULATION_WARMUP_BATCHES: 1,
    SPECULATION_TEST_FORCE_CAPACITY: 0,
    SPECULATION_MIN_HIT_RATE: 0.0,
    SPECULATION_WINDOW: 16,
    HBM_BUDGET_BYTES: 12 << 30,
    HOST_SPILL_BYTES: 1 << 30,
    SPILL_DIR: "",
    MEMORY_FRACTION: 0.8,
    SPILL_CODEC: "none",
    SPILL_COMPRESS_HOST: False,
    DEVICE_ORDINAL: -1,
    HOST_POOL_BYTES: 256 << 20,
    TASK_MAX_FAILURES: 3,
    RETRY_BACKOFF_S: 0.2,
    SPLIT_RETRY_ENABLED: True,
    SPLIT_MIN_ROWS: 1024,
    SORT_SINGLE_BATCH_ROWS: 1 << 21,
    SORT_MAX_BUCKETS: 64,
    COALESCE_ENABLED: False,
    COALESCE_TARGET_ROWS: 1 << 20,
    COALESCE_TARGET_BYTES: 128 << 20,
    FAULTS_ENABLED: False,
    FAULTS_SPEC: "",
    LOCK_TRACKER_ENABLED: False,
    SERVING_MAX_CONCURRENT: 0,
    SERVING_QUEUE_DEPTH: 32,
    SERVING_DEFAULT_PRIORITY: 1,
    PLAN_CACHE_CAPACITY: 32,
    SERVING_BATCHING: True,
    SERVING_ADMIT_WAIT_BUDGET_MS: 250.0,
    SHARING_ENABLED: False,
    RESULT_CACHE_BUDGET: 256 << 20,
    SHARING_SCANS: True,
    SCAN_CACHE_BUDGET: 128 << 20,
    CANCEL_ENABLED: True,
    DEADLINE_MS: 0.0,
    BREAKER_THRESHOLD: 0,
    BREAKER_COOLDOWN_MS: 5000.0,
    BREAKER_MAX_TRIPS: 0,
    TRACE_ENABLED: False,
    TRACE_BUFFER_SIZE: 65536,
    LEDGER_ENABLED: False,
    # NVIDIA H100 80GB HBM3 (SXM) at 700 W: 3.35 TB/s of HBM3, and the
    # 67 TFLOP/s of FP32 vector work PERF.md's bound of K1 uses
    LEDGER_HBM_BYTES_PER_S: 3.35e12,
    LEDGER_PEAK_FLOPS: 67e12,
    TELEMETRY_ENABLED: False,
    TELEMETRY_HZ: 4.0,
    METRICS_DEVICE_SYNC: True,
    TELEMETRY_LOG_EVERY: 4,
    HISTORY_CAPACITY: 100,
    EVENTLOG_ENABLED: False,
    EVENTLOG_DIR: "/tmp/spark_rapids_tpu_eventlog",
    EVENTLOG_COMPRESS: False,
    EVENTLOG_TRACE_SIDECAR: False,
    LEDGER_ROOFLINE_FLOOR: 0.001,
    LEDGER_OCCUPANCY_FLOOR: 0.5,
    RESULT_MIN_HIT_RATE: 0.25,
    LOCK_HOLD_BUDGET_MS: 250.0,
    CONNECT_MAX_FRAME_BYTES: 64 << 20,
    CONNECT_BATCH_ROWS: 0,
    CONNECT_SEND_BUFFER_BYTES: 0,
    CONNECT_SOCKET_TIMEOUT_S: 120.0,
    OBS_ENABLED: False,
    OBS_PORT: 0,
    OBS_HOST: "127.0.0.1",
    SLO_WALL_BUDGET_MS: 0.0,
    SLO_ADMIT_BUDGET_MS: 0.0,
    SLO_WINDOW_S: 60.0,
    SLO_INTERVAL_MS: 1000.0,
    PERSIST_ENABLED: False,
    PERSIST_DIR: "",
    PERSIST_MAX_BYTES: 512 << 20,
    PERSIST_MIN_HIT_RATE: 0.5,
}

#: the keys that run a query serially: every task, file and stage one
#: after another on the caller's thread
SERIAL: dict[str, Any] = {TASK_THREADS: 1, DECODE_THREADS: 1,
                          PIPELINE_ENABLED: False}


def register(key: str, default: Any) -> str:
    """Add ``key`` with its default (the planner's per-exec and
    per-expression switches, ``spark.rapids.tpu.sql.exec.<Node>`` and
    ``spark.rapids.tpu.sql.expression.<Class>``, register themselves
    when it is imported, as the package's import does); the key."""
    if DEFAULTS.setdefault(key, default) != default:
        raise ValueError(f"{key} is registered with another default")
    return key


_AT_LEAST_ONE = (TASK_THREADS, DECODE_THREADS, CONCURRENT_TASKS,
                 PIPELINE_DEPTH, SPLIT_MIN_ROWS, COALESCE_TARGET_ROWS,
                 COALESCE_TARGET_BYTES, SERVING_DEFAULT_PRIORITY,
                 PLAN_CACHE_CAPACITY, SPECULATION_WARMUP_BATCHES,
                 SPECULATION_SAFETY_FACTOR, TELEMETRY_LOG_EVERY,
                 HISTORY_CAPACITY)
_AT_LEAST_ZERO = (SERVING_QUEUE_DEPTH, RESULT_CACHE_BUDGET,
                  SCAN_CACHE_BUDGET, DEADLINE_MS, BREAKER_THRESHOLD,
                  BREAKER_COOLDOWN_MS, BREAKER_MAX_TRIPS,
                  SPECULATION_TEST_FORCE_CAPACITY, CONNECT_BATCH_ROWS,
                  CONNECT_SEND_BUFFER_BYTES, SLO_WALL_BUDGET_MS,
                  SLO_ADMIT_BUDGET_MS, PERSIST_MAX_BYTES, HOST_POOL_BYTES)
#: the metric levels, least detail first (JAX ``TpuMetric``)
METRIC_LEVELS = ("ESSENTIAL", "MODERATE", "DEBUG")


class TorchConf:
    """Key/value settings with the defaults above; unknown keys raise."""

    def __init__(self, values: Optional[dict[str, Any]] = None):
        self._values: dict[str, Any] = {}
        for k, v in (values or {}).items():
            self.set(k, v)

    def set(self, key: str, value: Any) -> "TorchConf":
        if key not in DEFAULTS:
            raise KeyError(f"unknown conf key {key!r}")
        if isinstance(DEFAULTS[key], bool) and isinstance(value, str):
            if value.strip().lower() not in ("true", "false", "1", "0"):
                raise ValueError(f"{key} takes true or false, got {value!r}")
            value = value.strip().lower() in ("true", "1")
        value = type(DEFAULTS[key])(value)
        if key in _AT_LEAST_ONE and value < 1:
            raise ValueError(f"{key} must be >= 1, got {value}")
        if key in _AT_LEAST_ZERO and value < 0:
            raise ValueError(f"{key} must be >= 0, got {value}")
        if key == SPECULATION_MIN_HIT_RATE and not 0.0 <= value <= 1.0:
            raise ValueError(f"{key} must be in [0, 1], got {value}")
        if key == SPECULATION_WINDOW and value < 2:
            raise ValueError(f"{key} must be >= 2, got {value}")
        if key == TRACE_BUFFER_SIZE and value < 16:
            raise ValueError(f"{key} must be >= 16, got {value}")
        if key == TELEMETRY_HZ and not 0.1 <= value <= 1000:
            raise ValueError(f"{key} must be in [0.1, 1000], got {value}")
        if key in (LEDGER_HBM_BYTES_PER_S, LEDGER_PEAK_FLOPS) and value <= 0:
            raise ValueError(f"{key} must be > 0, got {value}")
        if key == CONNECT_MAX_FRAME_BYTES and value < 1024:
            raise ValueError(f"{key} must be >= 1024, got {value}")
        if key in (CONNECT_SOCKET_TIMEOUT_S, SLO_WINDOW_S) and value <= 0:
            raise ValueError(f"{key} must be > 0, got {value}")
        if key == OBS_PORT and not 0 <= value <= 65535:
            raise ValueError(f"{key} must be in [0, 65535], got {value}")
        if key == SLO_INTERVAL_MS and value < 10:
            raise ValueError(f"{key} must be >= 10, got {value}")
        if key == METRICS_LEVEL and value not in METRIC_LEVELS:
            raise ValueError(f"{key} is one of {METRIC_LEVELS}, got "
                             f"{value!r}")
        if key == RF_FPP and not 0.0 < value < 1.0:
            raise ValueError(f"{key} must be in (0, 1), got {value}")
        self._values[key] = value
        return self

    def get(self, key: str) -> Any:
        if key not in DEFAULTS:
            raise KeyError(f"unknown conf key {key!r}")
        return self._values.get(key, DEFAULTS[key])

    def is_set(self, key: str) -> bool:
        """Whether ``key`` was given explicitly (not its default)."""
        return key in self._values
