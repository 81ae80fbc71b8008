"""Task failure detection and recovery: the OOM escalation ladder.

Counterpart of ``spark_rapids_tpu/execs/retry.py`` (the reference's
RmmRapidsRetryIterator ``withRetry`` / ``withRetryNoSplit``).  The rungs,
cheapest first, all on the device:

1. ``run_with_oom_retry(fn)``: spill every unpinned buffer and re-run a
   restartable closure (an aggregate's merge, an exchange's slices);
2. ``with_split_retry(run, batch)``: per input batch of the join,
   aggregate, sort and exchange loops.  A retryable failure spills and
   re-runs the batch; a second one bisects it (``bisect_batch``, down
   to ``task.retry.minSplitRows``) and runs the halves through the
   ladder, the waiting half parked in the store;
3. ``with_task_retries(fn)``: a whole map task re-run from its inputs,
   with jittered doubling backoff.

A failure none of them absorbs raises out of ``collect()``.  The JAX
package's fourth rung, the per-query re-run on its CPU engine after a
device error, is not ported: in this port nothing catches a run-time
error to fall back (the CPU engine runs what the planner's tags send
there, and nothing else).

``classify(exc)`` is the one gate: an out-of-memory error
(``torch.cuda.OutOfMemoryError``, ``MemoryError``, the fault seams'
``RESOURCE_EXHAUSTED`` texts) is retryable; a kernel that fails to
build or launch (``ops/kernels.KernelError``), any other CUDA error and
every logic error are fatal.  ``retry_stats()`` counts what the ladder
absorbed, process-wide: ``splits``, ``spill_retries``,
``task_retries`` as in the JAX package, and ``device_ooms``, the
allocator's own out-of-memory errors among them.

The JAX module reads its keys from a process-global conf; here each
exec carries its session's ``RetryPolicy`` (the keys and the store).
"""

from __future__ import annotations

import dataclasses
import gc
import random
import threading
import time
from typing import Callable, Iterator, Optional, TypeVar

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.ops.kernels import KernelError
from spark_rapids_tpu_torch.robustness import faults as _faults

R = TypeVar("R")

#: substrings of a retryable error's text.  Not "INTERNAL", and no
#: generic CUDA error: those are deterministic or leave the context
#: unusable, so a retry would only hide them.
_RETRYABLE_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "out of memory",
    "OutOfMemory",
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "Socket closed",
    "connection reset",
    "Connection reset",
    "ECONNRESET",
)

#: backoff jitter, unseeded on purpose (two processes sleep differently)
_JITTER = random.Random()

_STATS_LOCK = threading.Lock()
_STATS = {"splits": 0, "spill_retries": 0, "task_retries": 0,
          "device_ooms": 0}


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """A session's ladder keys, and its store (None: the process
    store)."""

    max_failures: int = C.DEFAULTS[C.TASK_MAX_FAILURES]
    backoff_s: float = C.DEFAULTS[C.RETRY_BACKOFF_S]
    split_enabled: bool = C.DEFAULTS[C.SPLIT_RETRY_ENABLED]
    min_split_rows: int = C.DEFAULTS[C.SPLIT_MIN_ROWS]
    store: Optional[object] = None

    @classmethod
    def from_conf(cls, conf: C.TorchConf,
                  store: Optional[object] = None) -> "RetryPolicy":
        return cls(conf.get(C.TASK_MAX_FAILURES),
                   conf.get(C.RETRY_BACKOFF_S),
                   conf.get(C.SPLIT_RETRY_ENABLED),
                   conf.get(C.SPLIT_MIN_ROWS), store)

    @property
    def attempts(self) -> int:
        return max(1, self.max_failures)

    def get_store(self):
        if self.store is not None:
            return self.store
        from spark_rapids_tpu_torch.memory.store import get_store

        return get_store()


DEFAULT_POLICY = RetryPolicy()


def _bump(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        _STATS[key] += n


def retry_stats() -> dict:
    """{splits, spill_retries, task_retries, device_ooms}, process-wide."""
    with _STATS_LOCK:
        return dict(_STATS)


def reset_retry_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def is_retryable(exc: BaseException) -> bool:
    """A device memory failure (a retry may succeed) or not (fail
    fast).  A cancellation is a verdict, never retried."""
    from spark_rapids_tpu_torch.serving.cancel import QueryCancelled

    if isinstance(exc, (KernelError, QueryCancelled)):
        return False
    if isinstance(exc, MemoryError):
        return True
    if isinstance(exc, RuntimeError):  # torch.cuda.OutOfMemoryError too
        text = str(exc)
        return any(m in text for m in _RETRYABLE_MARKERS)
    return False


def classify(exc: BaseException) -> str:
    """'retryable' | 'fatal': every path that absorbs an exception
    consults this first."""
    return "retryable" if is_retryable(exc) else "fatal"


def _caught(exc: BaseException) -> None:
    """Count an absorbed allocator OOM, and drop the failed attempt's
    frames: its traceback holds the tensors the retry needs freed."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        _bump("device_ooms")
    exc.__traceback__ = None


def _release_pressure(policy: RetryPolicy = DEFAULT_POLICY) -> None:
    """Before a retry: spill every unpinned buffer, collect garbage, and
    hand the allocator's cached blocks back to the driver."""
    try:
        policy.get_store().spill_all_unpinned()
    except Exception as e:  # noqa: BLE001 - a failed spill never masks
        classify(e)         # the original error
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()



def _sleep_backoff(base: float, attempt: int) -> None:
    if base > 0:
        time.sleep(base * (2 ** attempt) * (0.5 + _JITTER.random()))


def _note_recovered_all(caught: list, action: str) -> None:
    for e in caught:
        _faults.note_recovered(e, action=action)


def absorb_once(fn: Callable[[], R], action: str,
                policy: RetryPolicy = DEFAULT_POLICY) -> R:
    """Run a restartable closure; on one retryable failure release
    pressure and run it again (a second failure escalates)."""
    try:
        return fn()
    except BaseException as e:  # noqa: BLE001 - classified below
        if not is_retryable(e):
            raise
        _caught(e)
        _release_pressure(policy)
        out = fn()
        _faults.note_recovered(e, action=action)
        return out


def _retry_loop(fn: Callable[[], R], stat_key: str, action: str,
                policy: RetryPolicy, attempts: Optional[int] = None) -> R:
    attempts = attempts if attempts is not None else policy.attempts
    caught: list[BaseException] = []
    for attempt in range(attempts):
        try:
            out = fn()
        except BaseException as e:  # noqa: BLE001 - classified below
            if not is_retryable(e) or attempt == attempts - 1:
                raise
            # a cancelled query burns no backoff and no re-attempt
            from spark_rapids_tpu_torch.serving.cancel import check_point

            check_point()
            caught.append(e)
            _caught(e)
            _bump(stat_key)
            _release_pressure(policy)
            _sleep_backoff(policy.backoff_s, attempt)
            continue
        if caught:
            _note_recovered_all(caught, action)
        return out
    raise caught[-1]  # unreachable


def with_task_retries(fn: Callable[[], R], desc: str = "task",
                      policy: RetryPolicy = DEFAULT_POLICY) -> R:
    """Run a task closure that can re-run from scratch, retrying
    retryable failures (``task.maxFailures`` attempts)."""
    return _retry_loop(fn, "task_retries", f"task_retry:{desc}", policy)


def run_with_oom_retry(fn: Callable[[], R], desc: str = "op",
                       attempts: Optional[int] = None,
                       policy: RetryPolicy = DEFAULT_POLICY) -> R:
    """Spill-and-retry a restartable closure (rung 1); it must leave no
    partial effect behind when it raises."""
    return _retry_loop(fn, "spill_retries", f"spill_retry:{desc}", policy,
                       attempts)


# -- batch bisection --------------------------------------------------- #


def bisect_batch(batch: ColumnarBatch
                 ) -> tuple[ColumnarBatch, ColumnarBatch]:
    """(first half, second half) by rows.  A coalesced batch (its
    ``coalesce_seams``: the row counts it was built from) splits at the
    seam nearest the middle, and each half keeps its side's seams, so
    the ladder walks it back down the producer's own batches.  The
    halves are views of the batch's tensors: under the pressure that
    forced the split, a copy could fail again, and the batch stays
    alive in the caller's frame whatever the halves do."""
    n = batch.num_rows
    assert n >= 2, f"cannot bisect a {n}-row batch"
    seams = getattr(batch, "coalesce_seams", None)
    lo = n // 2
    first_seams = second_seams = None
    if seams and len(seams) >= 2 and sum(seams) == n:
        offs, acc = [], 0
        for s in seams[:-1]:
            acc += s
            offs.append(acc)
        cut = min(offs, key=lambda o: abs(o - lo))
        if 0 < cut < n:
            lo = cut
            k = offs.index(cut) + 1
            first_seams, second_seams = seams[:k], seams[k:]
    first, second = batch.slice(0, lo), batch.slice(lo, n)
    if first_seams and len(first_seams) >= 2:
        first.coalesce_seams = first_seams
    if second_seams and len(second_seams) >= 2:
        second.coalesce_seams = second_seams
    return first, second


def with_split_retry(run: Callable, batch: ColumnarBatch,
                     desc: str = "batch",
                     policy: RetryPolicy = DEFAULT_POLICY,
                     _depth: int = 0,
                     first_attempt: Optional[Callable] = None,
                     initial_error: Optional[BaseException] = None
                     ) -> Iterator:
    """The batch ladder (a generator).  ``run(batch)`` processes one
    input batch and returns an iterable of output chunks (empty for a
    sink); it must roll back its own partial effects when it raises.
    On a retryable failure with nothing yielded yet: spill and re-run;
    on the second, bisect and recurse on the halves, down to
    ``minSplitRows``; at the floor retry up to ``maxFailures``, then
    re-raise.  Once a chunk has been yielded a re-run would duplicate
    it, so the ladder re-raises.

    ``first_attempt`` lets a pipelined caller hand in attempt zero over
    the state it already dispatched: if it fails, that state is dropped
    and the retries run ``run`` from the input batch (at the split size
    after a bisect); its ``exec.batch`` fault seam fired at dispatch
    (``guarded_pipeline``), so attempt zero does not fire it again.
    ``initial_error`` seeds the ladder with a failure that happened at
    dispatch time (JAX ``with_split_retry``)."""
    caught: list[BaseException] = []
    failures = 0
    action = "spill_retry"
    if initial_error is not None:
        caught.append(initial_error)
        _caught(initial_error)
        failures = 1
        _bump("spill_retries")
        _release_pressure(policy)
        _sleep_backoff(policy.backoff_s, 0)
    while True:
        emitted = False
        try:
            if first_attempt is None:
                _faults.fault_point("exec.batch", desc=desc)
            it = first_attempt() if first_attempt is not None \
                else run(batch)
            first_attempt = None
            if it is not None:
                for out in it:
                    emitted = True
                    yield out
            break
        except BaseException as e:  # noqa: BLE001 - classified below
            first_attempt = None
            if not is_retryable(e) or emitted:
                raise
            failures += 1
            rows = batch.num_rows if policy.split_enabled else None
            split = failures > 1 and rows is not None and rows >= 2 \
                and rows > policy.min_split_rows and _depth < 32
            if failures > 1 and not split and failures >= policy.attempts:
                raise
            caught.append(e)
            _caught(e)
            if failures == 1:
                _bump("spill_retries")
                _release_pressure(policy)
                _sleep_backoff(policy.backoff_s, 0)
                continue
            if split:
                _bump("splits")
                action = "split"
                _release_pressure(policy)
                for half in _split_spillable(batch, policy):
                    yield from with_split_retry(run, half, desc, policy,
                                                _depth + 1)
                break
            _release_pressure(policy)
            _sleep_backoff(policy.backoff_s, failures - 1)
    if caught:
        _note_recovered_all(caught, f"{action}:{desc}")


def guarded_pipeline(dispatch: Callable, retire: Callable, desc: str,
                     policy: RetryPolicy = DEFAULT_POLICY,
                     after: Optional[Callable[[], None]] = None):
    """Put a ``parallel/pipeline.pipelined`` loop under the split ladder
    (JAX ``guarded_pipeline``): returns (dispatch_guarded,
    retire_guarded).  A retryable failure at dispatch is carried into
    the ladder as its first failure; a failure at retire drops the
    in-flight state and re-dispatches from the input batch (at the split
    size after a bisect).  ``retire`` must roll back its own partial
    effects when it raises.  The ``exec.batch`` fault
    seam of attempt zero fires at dispatch, before any device work, as
    it fires before each re-run.

    A speculated dispatch (``parallel/speculation.py``) is attempt
    zero like any other: if its retire fails, its chunk at the
    speculated capacity is dropped with it, and the re-run dispatches
    again from the input batch through the live predictor.  A loop's
    bookkeeping of a count (the predictor's observation, the hit or
    overflow) runs once its retire has succeeded, so a failed attempt
    observes nothing and no count is observed twice.  ``after``, when
    given, runs once per input batch after its ladder unit completes:
    the exchange's finish of split counts that have arrived, work kept
    outside the ladder because each finish is a retry transaction of
    its own."""
    def dispatch_guarded(batch):
        try:
            _faults.fault_point("exec.batch", desc=desc)
            return ("ok", dispatch(batch), batch, None)
        except BaseException as e:  # noqa: BLE001 - classified below
            if not is_retryable(e):
                raise
            return ("failed", None, batch, e)

    def rerun(b):
        return retire(dispatch(b))

    def retire_guarded(tagged):
        kind, entry, batch, err = tagged
        if kind == "ok":
            gen = with_split_retry(rerun, batch, desc, policy,
                                   first_attempt=lambda: retire(entry))
        else:
            gen = with_split_retry(rerun, batch, desc, policy,
                                   initial_error=err)
        if after is None:
            return gen

        def with_after():
            yield from gen
            after()

        return with_after()

    return dispatch_guarded, retire_guarded


def _split_spillable(batch: ColumnarBatch, policy: RetryPolicy
                     ) -> Iterator[ColumnarBatch]:
    """The two halves; the second waits in the store, spillable, while
    the first runs.  A failed registration runs the half directly."""
    from spark_rapids_tpu_torch.memory.store import SpillPriorities

    first, second = bisect_batch(batch)
    handle = None
    try:
        handle = policy.get_store().register(
            second, SpillPriorities.ACTIVE_ON_DECK)
        second = None
    except Exception as e:  # noqa: BLE001 - parking is best effort
        classify(e)
        handle = None
    try:
        yield first
        if handle is not None:
            try:
                second = handle.get()
            finally:
                handle.close()
            handle = None
        yield second
    finally:
        if handle is not None:
            handle.close()
