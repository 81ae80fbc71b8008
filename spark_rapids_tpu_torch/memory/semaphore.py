"""Task admission semaphore.

Counterpart of ``TpuSemaphore`` in ``spark_rapids_tpu/memory/semaphore.py``
(GpuSemaphore in the reference): it caps how many concurrent tasks may
hold device batches, so a pool of host threads cannot put every task's
batches on the card at once.  A task acquires after its child has
yielded its first batch and releases at its end, in a ``finally``;
acquiring earlier would deadlock a nested exchange, whose map stage a
task's first pull runs while other tasks wait for a permit.

The permit count comes from ``spark.rapids.tpu.sql.concurrentTpuTasks``,
but the instance is one per process (``get``), shared by every session
on the card: :meth:`sync_conf` aligns the two at each query boundary
with the JAX module's ownership rule.  A conf asking for a non-default
size resizes the live semaphore and becomes its owner; a conf that
carries the default never shrinks (or grows) a semaphore another conf
resized; only the owner, or a new explicit size, moves it again.
Resizing wakes waiters.  The serving tier's admission limit
(``serving/scheduler.py``) reads :attr:`permits`, so a resize here
re-sizes query admission too.  A semaphore made directly (``TpuSemaphore(n)``)
is private to its maker, as ``TaskRuntime.serial`` uses one.
"""

from __future__ import annotations

import threading
import weakref
from typing import Hashable, Optional

from spark_rapids_tpu_torch import config as C


class TpuSemaphore:
    _instance: Optional["TpuSemaphore"] = None
    _lock = threading.Lock()
    #: weakref to the conf that last resized the live instance to a
    #: non-default permit count (None: sized at the default)
    _owner: Optional["weakref.ref"] = None

    def __init__(self, permits: int):
        if permits < 1:
            raise ValueError(f"semaphore permits must be >= 1, got {permits}")
        # read unguarded by the scheduler's limit, as a conf value
        self.permits = permits
        self._available = permits
        self._cv = threading.Condition()
        self._holders: set = set()

    @classmethod
    def get(cls, conf: Optional[C.TorchConf] = None) -> "TpuSemaphore":
        """The process semaphore, made on first use with ``conf``'s
        permit count (the default without a conf)."""
        with cls._lock:
            if cls._instance is None:
                permits = conf.get(C.CONCURRENT_TASKS) if conf is not None \
                    else C.DEFAULTS[C.CONCURRENT_TASKS]
                cls._instance = TpuSemaphore(int(permits))
            return cls._instance

    @classmethod
    def usage_now(cls) -> dict:
        """The process semaphore's permits and permits in use, without
        making one (zeros before the first)."""
        with cls._lock:
            inst = cls._instance
        if inst is None:
            return {"permits": 0, "in_use": 0}
        u = inst.usage()
        return {"permits": u["permits"], "in_use": u["in_use"]}

    @classmethod
    def reset(cls) -> None:
        """Drop the process semaphore and its owner (tests, a plugin
        restart); the next ``get`` makes a new one."""
        with cls._lock:
            cls._instance = None
            cls._owner = None

    @classmethod
    def sync_conf(cls, conf: C.TorchConf) -> None:
        """Align the process semaphore with ``conf`` at a query boundary
        under the ownership rule in the module docstring."""
        want = int(conf.get(C.CONCURRENT_TASKS))
        default = int(C.DEFAULTS[C.CONCURRENT_TASKS])
        with cls._lock:
            inst = cls._instance
            if inst is None:
                return  # the next get() reads this conf's value anyway
            if want == inst.permits:
                if want != default:
                    cls._owner = weakref.ref(conf)
                return
            if want == default:
                owner = cls._owner() if cls._owner is not None else None
                if owner is not conf:
                    return
                cls._owner = None
            else:
                cls._owner = weakref.ref(conf)
        inst.resize(want)

    def resize(self, permits: int) -> None:
        """Change the permit count of a live semaphore.  Growing wakes
        waiters; shrinking lets holders finish (``_available`` may go
        negative, and nothing is granted until enough release)."""
        if permits < 1:
            raise ValueError(f"semaphore permits must be >= 1, got {permits}")
        with self._cv:
            delta = permits - self.permits
            self.permits = permits
            self._available += delta
            if delta > 0:
                self._cv.notify_all()

    def acquire_if_necessary(self, task_id: Hashable) -> None:
        """Block until ``task_id`` holds a permit; idempotent per task.
        The membership check, the take and the registration are one
        critical section, so two threads presenting one task cannot
        both take a permit."""
        with self._cv:
            while True:
                if task_id in self._holders:
                    return
                if self._available > 0:
                    self._available -= 1
                    self._holders.add(task_id)
                    self._cv.notify_all()
                    return
                self._cv.wait()

    def release_if_necessary(self, task_id: Hashable) -> None:
        """Give back ``task_id``'s permit, if it holds one, and wake the
        waiters."""
        with self._cv:
            if task_id not in self._holders:
                return
            self._holders.discard(task_id)
            self._available += 1
            self._cv.notify_all()

    def usage(self) -> dict:
        """Permits, permits in use (above ``permits`` for a moment after
        a shrink), and the holding tasks."""
        with self._cv:
            return {"permits": self.permits,
                    "in_use": self.permits - self._available,
                    "holders": sorted(map(repr, self._holders))}
