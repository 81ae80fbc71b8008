"""Task admission semaphore.

Counterpart of ``TpuSemaphore`` in ``spark_rapids_tpu/memory/semaphore.py``
(GpuSemaphore in the reference): it caps how many concurrent tasks may
hold device batches, so a pool of host threads cannot put every task's
batches on the card at once.  A task acquires after its child has
yielded its first batch and releases at its end, in a ``finally``;
acquiring earlier would deadlock a nested exchange, whose map stage a
task's first pull runs while other tasks wait for a permit.

A session owns one instance, sized by
``spark.rapids.tpu.sql.concurrentTpuTasks``; nothing here is
process-global, so the JAX module's conf-ownership rules have no
counterpart.
"""

from __future__ import annotations

import threading
from typing import Hashable


class TpuSemaphore:
    def __init__(self, permits: int):
        if permits < 1:
            raise ValueError(f"semaphore permits must be >= 1, got {permits}")
        self.permits = permits
        self._available = permits
        self._cv = threading.Condition()
        self._holders: set = set()

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
        """Permits, permits in use, and the holding tasks."""
        with self._cv:
            return {"permits": self.permits,
                    "in_use": self.permits - self._available,
                    "holders": sorted(map(repr, self._holders))}
