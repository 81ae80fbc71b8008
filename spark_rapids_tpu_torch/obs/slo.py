"""The SLO watchdog: rolling per-tenant latency objectives, evaluated
live, breaches persisted as ``slo`` event-log records.

Counterpart of ``spark_rapids_tpu/obs/slo.py``.  The circuit breaker
sees only failures; a tenant may run far over its latency target
without tripping it.  The session's query epilogue feeds every
completed query's (tenant, wall_ms, admit_wait_ms) into rolling
windows here, and ONE thread (tracer-style ownership, ``stop()``
joins) re-evaluates the per-tenant p50/p99 against the
``spark.rapids.tpu.obs.slo.*`` budgets every checkIntervalMs:

- a p99 over budget appends an ``slo`` record to every attached
  session event log (weakref writers, the telemetry-sampler idiom) —
  the input of the HC016 health rule in tools/history;
- ``/slo`` serves :func:`SloWatchdog.snapshot`: the live per-tenant
  percentiles, budgets and bounded breach history.

Budgets default to 0 (no objective): turning the plane on invents no
alarm threshold.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Optional

#: breach history bound per process (the /slo payload stays small)
_MAX_BREACHES = 256


def _pctl(sorted_vals: list, p: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            int(round(p * (len(sorted_vals) - 1))))
    return sorted_vals[i]


class SloWatchdog:
    """See module doc.  Observations arrive on query threads
    (:meth:`observe`, epilogue-driven — cheap append under the lock);
    evaluation runs on the one watchdog thread."""

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: tenant -> deque[(monotonic_ts, wall_ms, admit_wait_ms)]
        self._windows: dict[str, deque] = {}
        self._writers: list[weakref.ref] = []
        self._breaches: deque = deque(maxlen=_MAX_BREACHES)
        self.breach_count = 0
        self.ticks = 0
        # budgets synced from the owning conf at query boundaries
        self.wall_budget_ms = 0.0
        self.admit_budget_ms = 0.0
        self.window_s = 60.0
        self.interval_ms = 1000.0

    # -- lifecycle ---------------------------------------------------- #

    def start(self) -> None:
        with self._lock:
            if self.enabled:
                return
            self.enabled = True
            self._stop_evt = threading.Event()
            self._thread = threading.Thread(
                target=self._run, args=(self._stop_evt,),
                name="srt-obs-slo", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            if not self.enabled:
                return
            self.enabled = False
            evt, t = self._stop_evt, self._thread
            self._thread = None
        evt.set()
        if t is not None:
            t.join()
        with self._lock:
            self._windows.clear()

    def sync_budgets(self, conf) -> None:
        from spark_rapids_tpu_torch import config as C

        self.wall_budget_ms = float(conf.get(C.SLO_WALL_BUDGET_MS))
        self.admit_budget_ms = float(conf.get(C.SLO_ADMIT_BUDGET_MS))
        self.window_s = float(conf.get(C.SLO_WINDOW_S))
        self.interval_ms = float(conf.get(C.SLO_INTERVAL_MS))

    def attach_writer(self, writer) -> None:
        if writer is None:
            return
        with self._lock:
            for r in self._writers:
                if r() is writer:
                    return
            self._writers.append(weakref.ref(writer))

    # -- ingestion (query epilogue) ------------------------------------ #

    def observe(self, tenant: str, wall_ms: float,
                admit_wait_ms: float = 0.0,
                engine: str = "tpu") -> None:
        if not self.enabled:
            return
        now = time.monotonic()
        with self._lock:
            win = self._windows.setdefault(tenant, deque())
            win.append((now, float(wall_ms), float(admit_wait_ms)))
            # bound the window eagerly too: a tenant hammering faster
            # than the prune tick must not grow without bound
            cutoff = now - self.window_s
            while win and win[0][0] < cutoff:
                win.popleft()

    # -- evaluation (watchdog thread) ---------------------------------- #

    def _tenant_stats(self, win: deque) -> dict:
        walls = sorted(w for _, w, _ in win)
        waits = sorted(a for _, _, a in win)
        return {
            "n": len(win),
            "wall_p50_ms": round(_pctl(walls, 0.50), 3),
            "wall_p99_ms": round(_pctl(walls, 0.99), 3),
            "admit_wait_p50_ms": round(_pctl(waits, 0.50), 3),
            "admit_wait_p99_ms": round(_pctl(waits, 0.99), 3),
        }

    def evaluate_now(self) -> list[dict]:
        """One evaluation pass (also the test hook): prune windows,
        compare per-tenant p99s against the budgets, record + emit
        breaches.  Returns the breaches found THIS pass."""
        now = time.monotonic()
        found: list[dict] = []
        with self._lock:
            cutoff = now - self.window_s
            for tenant, win in list(self._windows.items()):
                while win and win[0][0] < cutoff:
                    win.popleft()
                if not win:
                    del self._windows[tenant]
                    continue
                stats = self._tenant_stats(win)
                for metric, budget in (
                        ("wall_p99_ms", self.wall_budget_ms),
                        ("admit_wait_p99_ms", self.admit_budget_ms)):
                    if budget > 0 and stats[metric] > budget:
                        found.append({
                            "tenant": tenant,
                            "metric": metric,
                            "observed_ms": stats[metric],
                            "budget_ms": budget,
                            "window": stats["n"],
                            "ts": time.time(),
                        })
            for b in found:
                self._breaches.append(b)
                self.breach_count += 1
            refs = list(self._writers)
        for b in found:
            for r in refs:
                w = r()
                if w is None:
                    continue
                try:
                    w.log_slo(b)
                except Exception:
                    pass  # a full disk must not kill the watchdog
        return found

    def _run(self, stop_evt: threading.Event) -> None:
        while not stop_evt.wait(self.interval_ms / 1e3):
            try:
                self.evaluate_now()
            except Exception:
                continue  # a torn read must not kill the thread
            self.ticks += 1

    # -- /slo ----------------------------------------------------------- #

    def snapshot(self) -> dict:
        with self._lock:
            tenants = {t: self._tenant_stats(win)
                       for t, win in self._windows.items()}
            breaches = list(self._breaches)
        return {
            "budgets": {
                "wall_p99_ms": self.wall_budget_ms,
                "admit_wait_p99_ms": self.admit_budget_ms,
                "window_s": self.window_s,
            },
            "tenants": tenants,
            "breach_count": self.breach_count,
            "breaches": breaches[-32:],
        }

    def reset(self) -> None:
        with self._lock:
            self._windows.clear()
            self._breaches.clear()
            self.breach_count = 0


#: THE process watchdog
WATCHDOG = SloWatchdog()
