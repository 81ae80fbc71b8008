"""The serving tier: many sessions and tenants against one card.

Counterpart of ``spark_rapids_tpu/serving/`` (``docs/serving.md``):

- admission control (``serving/scheduler.py``): a weighted-fair,
  priority-aware scheduler over the process task semaphore's permits,
  with a bounded queue that rejects (``AdmissionRejected``);
- the prepared-plan cache (``serving/plan_cache.py``,
  ``serving/prepared.py``): ``TorchSession.prepare(df)`` and
  ``SqlSession.prepare(text)`` return a ``PreparedQuery`` whose repeats
  drain a cached lowered exec tree without planning again;
- streaming fetch (``PreparedQuery.execute_stream``): Arrow record
  batches as the result fetch stage yields them;
- cancellation, deadlines and a per-tenant circuit breaker
  (``serving/cancel.py``);
- cross-tenant work sharing (``serving/work_share.py``): a result cache
  and in-flight scan dedup.

The keys are in ``config.py`` (``spark.rapids.tpu.serving.*``).  With
``serving.maxConcurrent`` at its default of 0 admission is off: a
collect reads that one key and runs unscheduled.  The tier records the
JAX tier's trace spans and events (``serve.admit``, ``cancel.*``,
``breaker.*``, ``serve.result_cache_hit``); its event-log record, ops
plane, persisted plans and mesh serving are not ported.

This module holds the per-query serving context: the facts admission
and the plan cache learn about the query in flight (tenant, priority,
admission wait, the plan-cache verdict), thread-local, as the JAX
module keeps them.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

_TL = threading.local()


def update_serving_context(**kv: Any) -> None:
    ctx = getattr(_TL, "ctx", None)
    if ctx is None:
        ctx = _TL.ctx = {}
    ctx.update(kv)


def current_serving_context() -> Optional[dict]:
    """The calling thread's serving facts for the query in flight
    (tenant, priority, admit_wait_ms, plan_cache hit or miss), or
    None."""
    ctx = getattr(_TL, "ctx", None)
    return dict(ctx) if ctx else None


def clear_serving_context() -> None:
    _TL.ctx = None
