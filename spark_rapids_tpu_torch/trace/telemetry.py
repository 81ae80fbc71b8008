"""Live telemetry: a conf-gated thread sampling the engine's gauges
into Chrome-trace counter tracks.

Counterpart of ``spark_rapids_tpu/trace/telemetry.py``.  Per-query
signals (spans, settled metrics, ledger deltas) cannot show what the
process looks like between query boundaries: how full the store is
while sessions contend, how many semaphore permits are held, how deep
the admission queue runs, whether the pipeline stages sit full or
starved.  This module is that view:

- :func:`sample_now`: one flat snapshot of host-side gauges: the
  store's bytes by tier, the semaphore, admission (running, waiting),
  cancellations in flight, live stage threads and pipeline occupancy,
  the shared scans in flight and the result cache's bytes, and the
  card's bytes (``torch.cuda.memory_allocated`` / ``memory_reserved``,
  0 without CUDA) in place of the JAX device memory stats;
- :class:`TelemetrySampler`: a daemon thread sampling at
  ``spark.rapids.tpu.telemetry.hz``; each sample is recorded as
  Chrome-trace counter events (``ph="C"``) when the tracer is on, which
  ``trace/export.py::chrome_trace`` renders as counter tracks.

Every ``telemetry.eventLogEvery``-th sample is appended as a
``telemetry`` record to each attached session's event log (a session's
``sync_conf`` attaches its writer, held by weak reference).
``queries.in_flight`` is the ops plane's registry count (0 while it is
off); ``persist_cache.bytes`` is 0, as the port has no persisted-plan
tier.  Ownership is the tracer's: a
programmatic :func:`start` survives :func:`sync_conf`; a conf-driven
start is owned by its conf, and only that conf's "off" stops the
thread.  Off (the default) no thread exists.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Optional

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import trace as _tr

#: name of the sampler's thread
THREAD_NAME = "srt-telemetry"


def sample_now() -> dict:
    """One flat gauge snapshot (host-side reads; the card's allocator
    counters are host-side too)."""
    from spark_rapids_tpu_torch import obs as _obs
    from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
    from spark_rapids_tpu_torch.memory.store import peek_store
    from spark_rapids_tpu_torch.parallel.pipeline import (
        live_stage_threads,
        stage_snapshot,
    )
    from spark_rapids_tpu_torch.serving import cancel as _cancel
    from spark_rapids_tpu_torch.serving import work_share as _ws
    from spark_rapids_tpu_torch.serving.scheduler import queue_gauges

    store = peek_store()
    ss = store.spill_stats() if store is not None else {
        "device_used": 0, "host_used": 0, "disk_used": 0}
    sem = TpuSemaphore.usage_now()
    adm = queue_gauges()
    weighted = items = 0.0
    for s in stage_snapshot().values():
        n = s.get("items", 0)
        if n:
            weighted += s.get("occupancy_fraction", 0.0) * n
            items += n
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    return {
        "store.device_bytes": ss["device_used"],
        "store.host_bytes": ss["host_used"],
        "store.disk_bytes": ss["disk_used"],
        "semaphore.permits": sem["permits"],
        "semaphore.in_use": sem["in_use"],
        "admission.running": adm["running"],
        "admission.waiting": adm["waiting"],
        "pipeline.occupancy": round(weighted / items, 3)
        if items else 0.0,
        "pipeline.items": int(items),
        "cancel.active": _cancel.active_count(),
        "pipeline.stage_threads": live_stage_threads(),
        "scan.inflight": _ws.SCAN_REGISTRY.inflight(),
        "queries.in_flight": _obs.REGISTRY.count(),
        "result_cache.bytes": _ws.RESULT_CACHE.bytes_used(),
        "persist_cache.bytes": 0,
        "device.allocated_bytes": torch.cuda.memory_allocated()
        if cuda else 0,
        "device.reserved_bytes": torch.cuda.memory_reserved()
        if cuda else 0,
    }


#: Chrome counter tracks: one ph="C" event per track per sample, the
#: series within a track stacked (name -> sample keys)
_COUNTER_TRACKS = (
    ("telemetry.store_bytes", (("device", "store.device_bytes"),
                               ("host", "store.host_bytes"),
                               ("disk", "store.disk_bytes"))),
    ("telemetry.semaphore", (("in_use", "semaphore.in_use"),)),
    ("telemetry.admission", (("running", "admission.running"),
                             ("waiting", "admission.waiting"))),
    ("telemetry.pipeline_occupancy",
     (("occupancy", "pipeline.occupancy"),)),
    ("telemetry.queries", (("in_flight", "queries.in_flight"),)),
    ("telemetry.result_cache_bytes",
     (("bytes", "result_cache.bytes"),)),
    ("telemetry.device_bytes", (("allocated", "device.allocated_bytes"),
                                ("reserved", "device.reserved_bytes"))),
)


class TelemetrySampler:
    """The process sampler (see module doc); ``enabled`` is the
    fast-path guard."""

    def __init__(self) -> None:
        self.enabled = False
        self.forced = False
        self.hz = float(C.DEFAULTS[C.TELEMETRY_HZ])
        self.log_every = int(C.DEFAULTS[C.TELEMETRY_LOG_EVERY])
        self.samples = 0
        self._writers: list[weakref.ref] = []
        #: a failed sample stops the thread and is kept here for
        #: :meth:`stop` to raise
        self.error: Optional[BaseException] = None
        self._enabled_by: Optional[weakref.ref] = None
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self, hz: Optional[float] = None,
              log_every: Optional[int] = None,
              forced: bool = True) -> None:
        with self._lock:
            if hz is not None:
                self.hz = float(hz)
            if log_every is not None:
                self.log_every = int(log_every)
            self.forced = self.forced or forced
            if self.enabled:
                return
            self.enabled = True
            self.error = None
            self._stop_evt = threading.Event()
            self._thread = threading.Thread(
                target=self._run, args=(self._stop_evt,),
                name=THREAD_NAME, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        """Stop and JOIN the sampler thread: after stop() no telemetry
        thread exists.  A sample that failed raises here."""
        with self._lock:
            if not self.enabled:
                self.forced = False
                self._enabled_by = None
                return
            self.enabled = False
            self.forced = False
            self._enabled_by = None
            evt, t = self._stop_evt, self._thread
            self._thread = None
        evt.set()
        if t is not None:
            t.join()
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def attach_writer(self, writer) -> None:
        """Append every ``log_every``-th sample to ``writer``'s event
        log (None: nothing)."""
        if writer is None:
            return
        with self._lock:
            if not any(r() is writer for r in self._writers):
                self._writers.append(weakref.ref(writer))

    def _run(self, stop_evt: threading.Event) -> None:
        n = 0
        while not stop_evt.wait(1.0 / max(self.hz, 0.1)):
            try:
                sample = sample_now()
            except Exception as e:  # noqa: BLE001 - raised by stop()
                self.error = e
                return
            n += 1
            with self._lock:
                self.samples += 1
            self._emit_counters(sample)
            if n % max(1, self.log_every) == 0:
                self._emit_eventlog(sample)

    def _emit_eventlog(self, sample: dict) -> None:
        with self._lock:
            self._writers = [r for r in self._writers if r() is not None]
            writers = [r() for r in self._writers]
        for w in writers:
            if w is not None:
                try:
                    w.log_telemetry(sample)
                except OSError:
                    pass  # a full disk must not stop the sampler

    @staticmethod
    def _emit_counters(sample: dict) -> None:
        if not _tr.TRACER.enabled:
            return
        ts = time.perf_counter_ns()
        for track, series in _COUNTER_TRACKS:
            _tr.TRACER.record(
                track, ts, 0,
                {label: sample[key] for label, key in series},
                ph="C")


#: THE process sampler
SAMPLER = TelemetrySampler()


def is_enabled() -> bool:
    return SAMPLER.enabled


def start(hz: Optional[float] = None,
          log_every: Optional[int] = None) -> None:
    """Force the sampler on (tests, chip_smoke): survives sync_conf."""
    SAMPLER.start(hz=hz, log_every=log_every, forced=True)


def stop() -> None:
    SAMPLER.stop()


def sync_conf(conf: "C.TorchConf", writer=None) -> None:
    """Query-boundary alignment with a session's conf (the tracer's
    ownership rule): the conf that enables the sampler owns it; another
    session's defaults-only conf cannot stop it; a forced start() wins
    over confs.  ``writer``, the session's event log, is attached while
    the sampler runs."""
    if SAMPLER.forced:
        if SAMPLER.enabled:
            SAMPLER.attach_writer(writer)
        return
    want = bool(conf.get(C.TELEMETRY_ENABLED))
    if want:
        if not SAMPLER.enabled:
            SAMPLER.start(hz=float(conf.get(C.TELEMETRY_HZ)),
                          log_every=int(conf.get(C.TELEMETRY_LOG_EVERY)),
                          forced=False)
        SAMPLER._enabled_by = weakref.ref(conf)
        SAMPLER.attach_writer(writer)
    elif SAMPLER.enabled and SAMPLER._enabled_by is not None \
            and SAMPLER._enabled_by() is conf:
        SAMPLER.stop()
