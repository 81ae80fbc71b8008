"""The Python worker pool (parent side): user functions in child
interpreters.

Counterpart of ``spark_rapids_tpu/python_worker/__init__.py``: a bounded
pool of persistent child interpreters for one pickled function, at most
``spark.rapids.tpu.python.concurrentWorkers`` (2) running at once.
Batches travel to a child and back as length-prefixed Arrow IPC frames
over its pipes (``worker.py`` has the protocol).  A function that
raises comes back as ``UdfError`` and the worker serves the next batch;
a worker that dies is dropped, and the next batch starts a new one.

The child runs ``python -m spark_rapids_tpu_torch.python_worker.worker``
with the parent's ``sys.path`` (functions are pickled by reference, so
the child must import what the parent imported them from) and with
``CUDA_VISIBLE_DEVICES`` empty: it never makes a CUDA context, and it
imports no torch module of the package (``spark_rapids_tpu_torch``'s
``__init__`` is lazy, and this package and ``wrappers.py`` import only
pyarrow and pandas).  This module imports no torch either.
"""

from __future__ import annotations

import atexit
import os
import pickle
import struct
import subprocess
import sys
import threading
from typing import Callable

import pyarrow as pa

from spark_rapids_tpu_torch import config as C

PYTHON_WORKERS = C.register("spark.rapids.tpu.python.concurrentWorkers", 2)

#: the child's module
WORKER_MODULE = "spark_rapids_tpu_torch.python_worker.worker"

_ERR = 0xFFFFFFFF


class UdfError(RuntimeError):
    """The user's function raised inside the worker."""


def child_env() -> dict:
    """The child's environment: the parent's, its import roots on
    ``PYTHONPATH`` (the ``-m`` import happens before the ``sys.path``
    frame arrives) and no visible card."""
    env = dict(os.environ)
    roots = [p for p in sys.path if p]
    prior = env.get("PYTHONPATH")
    env["PYTHONPATH"] = os.pathsep.join(roots + ([prior] if prior else []))
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


class _Worker:
    def __init__(self, fn_bytes: bytes):
        self._proc = subprocess.Popen(
            [sys.executable, "-m", WORKER_MODULE],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=child_env())
        paths = pickle.dumps([p for p in sys.path if p])
        self._write(paths)
        self._write(fn_bytes)
        self._proc.stdin.flush()

    @property
    def pid(self) -> int:
        return self._proc.pid

    @property
    def alive(self) -> bool:
        return self._proc.poll() is None

    def _write(self, data: bytes) -> None:
        self._proc.stdin.write(struct.pack("<I", len(data)))
        self._proc.stdin.write(data)

    def run(self, tbl: pa.Table) -> pa.Table:
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, tbl.schema) as w:
            w.write_table(tbl)
        self._write(sink.getvalue().to_pybytes())
        self._proc.stdin.flush()
        (n,) = struct.unpack("<I", self._read(4))
        if n == _ERR:
            (m,) = struct.unpack("<I", self._read(4))
            raise UdfError(self._read(m).decode())
        return pa.ipc.open_stream(self._read(n)).read_all()

    def _read(self, n: int) -> bytes:
        chunks = []
        while n:
            b = self._proc.stdout.read(n)
            if not b:
                raise EOFError("python worker died")
            chunks.append(b)
            n -= len(b)
        return b"".join(chunks)

    def kill(self) -> None:
        """End the child now (a test's way to lose a worker)."""
        self._proc.kill()
        self._proc.wait()

    def close(self) -> None:
        try:
            if self.alive:
                self._proc.stdin.write(struct.pack("<I", 0))
                self._proc.stdin.flush()
                self._proc.wait(timeout=5)
        except (OSError, ValueError, subprocess.TimeoutExpired):
            self._proc.kill()
            self._proc.wait()
        finally:
            for f in (self._proc.stdin, self._proc.stdout):
                try:
                    f.close()
                except OSError:
                    pass


class PythonWorkerPool:
    """At most ``max_workers`` persistent workers for one pickled
    function; ``spawns`` counts the children started."""

    def __init__(self, fn: Callable[[pa.Table], pa.Table],
                 max_workers: int = C.DEFAULTS[PYTHON_WORKERS]):
        self._fn_bytes = pickle.dumps(fn)
        self._sem = threading.Semaphore(max_workers)
        self._idle: list[_Worker] = []
        self._lock = threading.Lock()
        self._closed = False
        self.spawns = 0
        atexit.register(self.close)

    def run(self, tbl: pa.Table) -> pa.Table:
        """The function over one table in a worker (waits while every
        worker is busy)."""
        with self._sem:
            w = self._take()
            try:
                out = w.run(tbl)
            except UdfError:
                self._give(w)  # the worker survived the user's error
                raise
            except BaseException:
                w.close()  # a broken pipe or a dead worker: not reused
                raise
            self._give(w)
            return out

    def kill_idle(self) -> None:
        """Kill every idle worker (a test's way to lose them)."""
        with self._lock:
            workers = list(self._idle)
        for w in workers:
            w.kill()

    def _take(self) -> _Worker:
        with self._lock:
            while self._idle:
                w = self._idle.pop()
                if w.alive:
                    return w
                w.close()
            self.spawns += 1
        return _Worker(self._fn_bytes)

    def _give(self, w: _Worker) -> None:
        with self._lock:
            if not self._closed and w.alive:
                self._idle.append(w)
                return
        w.close()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            workers, self._idle = self._idle, []
        for w in workers:
            w.close()
        atexit.unregister(self.close)
