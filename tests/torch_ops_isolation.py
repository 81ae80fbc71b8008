"""The process state the port's history, event-log, connect and ops-plane
tests may leave behind, and the teardown that clears it.

``ops_teardown()`` stops the ops plane (its HTTP and watchdog threads,
its socket, the registry), the telemetry sampler (zeroing its sample
count and dropping its attached logs) and the tracer, drains and stops
the warm-start store's writer (forgetting its stores), disarms
the fault registry, resets the serving tier's scheduler, cancel, sharing
and semaphore state, and drains and stops the query history's worker (no
hook pending, no thread), so that a test file sharing an xdist worker
with these sees a clean process.  ``SERVERS`` holds the connect servers a
test started; each is shut down.  The event-log writer keeps no file
open between records.
"""

from __future__ import annotations

import threading
import time

#: connect servers started by the running test
SERVERS: list = []


def ops_threads() -> list[str]:
    """The names of the threads the port's ops layer starts."""
    prefixes = ("srt-obs-", "srt-connect-server", "srt-query-history",
                "srt-telemetry", "srt-persist")
    return [t.name for t in threading.enumerate()
            if t.name.startswith(prefixes)]


def ops_teardown() -> None:
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch import obs, persist
    from spark_rapids_tpu_torch import trace as PT
    from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
    from spark_rapids_tpu_torch.obs.slo import WATCHDOG
    from spark_rapids_tpu_torch.robustness import faults
    from spark_rapids_tpu_torch.serving import cancel, clear_serving_context
    from spark_rapids_tpu_torch.serving import scheduler, work_share
    from spark_rapids_tpu_torch.tools.profiling import QueryHistory
    from spark_rapids_tpu_torch.trace import ledger, telemetry

    while SERVERS:
        SERVERS.pop().shutdown()
    obs.stop()
    WATCHDOG.reset()
    obs.REGISTRY.clear()
    telemetry.stop()
    # the sampler's tallies and attached logs outlive a stop: a later
    # test waits for its own samples from zero
    telemetry.SAMPLER.samples = 0
    telemetry.SAMPLER.log_every = int(C.DEFAULTS[C.TELEMETRY_LOG_EVERY])
    telemetry.SAMPLER._writers = []
    PT.disable()
    PT.clear()
    ledger.disable()
    faults.disarm()
    QueryHistory.shutdown_worker()
    persist.reset_for_tests()
    scheduler.reset()
    cancel.reset()
    clear_serving_context()
    TpuSemaphore.reset()
    work_share.reset()
    # a connection's handler thread ends once its client has gone
    deadline = time.monotonic() + 5.0
    while ops_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
