"""Per-program device ledger: which program holds the card's stream,
and a lower bound of how close each runs to its roofline.

Counterpart of ``spark_rapids_tpu/trace/ledger.py``, with its names,
its snapshot format and its analytics (:func:`delta`, :func:`summarize`,
:func:`per_op`), save the two names below that say what the port can
measure.  What differs is how a dispatch is timed and costed:

- every per-batch program of an exec (``execs/base.py::TpuExec.
  program``, through ``execs/jit_cache.py::cached_program``) and each
  of K1's wrappers (:meth:`DeviceLedger.wrap`) is keyed structurally.
  With the ledger on, a dispatch whose arguments live on a CUDA device
  records a start and an end ``torch.cuda.Event(enable_timing=True)``
  on the dispatching thread's current stream, around the call, and
  hands them to the settle worker (never one event pair per kernel: a
  program launches many).
- what the pair brackets is a WINDOW of the stream, not the program's
  kernels: it also holds the gaps while the host launches the
  program's kernels one by one, and the kernels other pool threads put
  on the same stream meanwhile.  So a program's ``window_ms`` is an
  UPPER bound of its device time (PERF.md §6 sets K1's beside the
  profiler's kernel time); the profiler is what gives kernel time.
- the settle worker waits on the end event off the critical path
  (``Event.synchronize`` releases the GIL, and the event is a blocking
  one, so the wait sleeps rather than spins) and places both events on
  one time base, ``elapsed_time`` from a reference event recorded when
  the ledger was enabled, so intervals from different streams of one
  device compare (the scans' side-stream uploads).  Each dispatch is
  credited the part of its window past the latest end settled before
  it: the credited pieces are disjoint, so their sum is bounded by the
  wall.  A window settled out of start order is undercounted, never
  counted twice.
- there is no XLA ``cost_analysis``.  ``bytes_accessed`` is the bytes
  of the tensors a dispatch reads (its arguments) and writes (its
  output), each counted once: a LOWER bound of what the program moves,
  since its intermediates are not seen.  Operations are not counted
  (``flops`` stays 0).  Over a window that bounds the device time from
  above, the achieved rate and the roofline share are lower bounds:
  :func:`summarize` and :func:`per_op` name it ``roofline_lower_bound``
  (the JAX ``roofline``).
- the peaks are the card's (``trace.ledger.hbmBytesPerSec`` /
  ``peakFlopsPerSec``, ``config.py``), taken from a session's conf by
  :func:`sync_conf`.
- occupancy: a port batch holds exactly its live rows outside the
  stream loops of the speculative sizing (``parallel/speculation.py``),
  and a dispatch over such batches has a live/capacity ratio of 1.0.
  Capacity exceeds live rows in the speculated programs: a join's
  expansion at its predicted bucket (``join.expand``: the pairs of the
  chunk over the bucket) and an aggregate's update at the batch's rows
  (``agg.update``: the groups over the rows).  Their counts are known
  only after the dispatch, so such a dispatch calls
  :func:`defer_occupancy` first and the exec adds ``(live, capacity)``
  by :func:`note_program_occupancy` once the count is read.
  :func:`note_occupancy` (the JAX API) states the pair before a
  dispatch.
- buffer donation has no PyTorch analog, so ``donated`` is always
  False.

On a CPU tensor (the tests) a dispatch is counted and timed on the
host (``dispatch_ms``); ``window_ms`` stays 0.  Off (the default) the
wrapper costs one attribute read.
"""

from __future__ import annotations

import dataclasses
import hashlib
import queue
import threading
import time
import weakref
from typing import Any, Optional

import torch

from spark_rapids_tpu_torch import config as C

#: the conf defaults, importable without a conf in hand
DEFAULT_HBM_BYTES_PER_S = float(C.DEFAULTS[C.LEDGER_HBM_BYTES_PER_S])
DEFAULT_PEAK_FLOPS = float(C.DEFAULTS[C.LEDGER_PEAK_FLOPS])


def roofline_fraction(bytes_per_s: float,
                      hbm_bytes_per_s: Optional[float] = None) -> float:
    """THE roofline formula: achieved bytes/s over the card's memory
    rate (the last synced conf's when none is given)."""
    if hbm_bytes_per_s is None:
        hbm_bytes_per_s = LEDGER.hbm_bytes_per_s
    return bytes_per_s / hbm_bytes_per_s


def key_tag(key: Any) -> str:
    """THE key-tag rule: the leading string of a structural program key
    (every cached_program key starts with one), "prog" otherwise."""
    return key[0] if isinstance(key, tuple) and key \
        and isinstance(key[0], str) else "prog"


def program_key_str(key: Any) -> str:
    """Stable, compact cross-run identity for a structural key: its tag
    plus a hash of the full structural serialization."""
    h = hashlib.sha256(repr(key).encode()).hexdigest()[:12]
    return f"{key_tag(key)}#{h}"


class ProgramEntry:
    """Cumulative counters for one program (one structural key)."""

    __slots__ = ("key_str", "tag", "op", "gen", "dispatches",
                 "dispatch_ns", "window_ns", "bytes_accessed",
                 "live_rows", "capacity_rows", "lock")

    def __init__(self, key: Any, op: Optional[str], gen: int):
        self.key_str = program_key_str(key)
        self.tag = key_tag(key)
        self.op = op
        self.gen = gen
        self.dispatches = 0     # guard: lock
        self.dispatch_ns = 0    # guard: lock (host-side dispatch wall)
        self.window_ns = 0      # guard: lock (exclusive window, settled)
        self.bytes_accessed = 0.0  # guard: lock (per dispatch, averaged)
        self.live_rows = 0      # guard: lock
        self.capacity_rows = 0  # guard: lock
        self.lock = threading.Lock()


# ------------------------------------------------------------------ #
# Occupancy and bytes
# ------------------------------------------------------------------ #

_OCC_TLS = threading.local()


def note_occupancy(live_rows: Any, capacity_rows: Any) -> None:
    """Record the live/capacity row counts for the NEXT dispatch on
    this thread (the JAX API); without it the dispatch scans its batch
    arguments (:func:`observe_occupancy`)."""
    if not LEDGER.enabled:
        return
    try:
        live, cap = int(live_rows), int(capacity_rows)
    except Exception:
        return
    if cap > 0:
        _OCC_TLS.occ = (live, cap)


def defer_occupancy() -> None:
    """The NEXT dispatch on this thread records no occupancy: its
    live rows are a device count, noted later by
    :func:`note_program_occupancy`."""
    if LEDGER.enabled:
        _OCC_TLS.occ = (0, 0)


def note_program_occupancy(key: Any, live_rows: int,
                           capacity_rows: int) -> None:
    """Add ``(live_rows, capacity_rows)`` to the program of structural
    ``key`` (the key its dispatch went under), once a speculated
    dispatch's count is known.  Off, nothing."""
    if not LEDGER.enabled or capacity_rows <= 0:
        return
    e, _ = LEDGER.lookup(key, None)
    with e.lock:
        e.live_rows += int(live_rows)
        e.capacity_rows += int(capacity_rows)


def _walk_tensors(obj: Any, budget: int = 256):
    """The tensors of a dispatch's arguments or output: tensors, port
    batches (their ``columns``) and columns (their dataclass fields),
    through tuples, lists and dicts, bounded."""
    stack = [obj]
    seen: set[int] = set()
    while stack and budget > 0:
        budget -= 1
        a = stack.pop()
        if a is None or isinstance(a, (int, float, bool, str, bytes)):
            continue
        if id(a) in seen:
            continue
        seen.add(id(a))
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (tuple, list)):
            stack.extend(a)
        elif isinstance(a, dict):
            stack.extend(a.values())
        elif dataclasses.is_dataclass(a) and not isinstance(a, type):
            stack.extend(getattr(a, f.name) for f in dataclasses.fields(a))
        else:
            cols = getattr(a, "columns", None)
            if isinstance(cols, (list, tuple)):
                stack.extend(cols)


def observe_occupancy(args: tuple) -> tuple[int, int]:
    """(live_rows, capacity_rows) summed over the batch arguments: a
    port batch's capacity is its row count, so the ratio is 1."""
    live = 0
    for a in args:
        n = getattr(a, "num_rows", None)
        if type(n) is int and hasattr(a, "columns"):
            live += n
    return (live, live)


def tensor_bytes(obj: Any) -> tuple[int, Optional[torch.device]]:
    """(bytes of the distinct tensor storages in ``obj``, the first CUDA
    device among them or None)."""
    total = 0
    dev = None
    storages: set = set()
    for t in _walk_tensors(obj):
        try:
            key = (t.untyped_storage().data_ptr(), t.device)
        except Exception:
            key = (id(t), t.device)
        if key in storages:
            continue
        storages.add(key)
        total += t.numel() * t.element_size()
        if dev is None and t.device.type == "cuda":
            dev = t.device
    return total, dev


# ------------------------------------------------------------------ #
# Settle worker
# ------------------------------------------------------------------ #


class _SettleWorker:
    """Off-critical-path settlement: waits on each dispatch's end event,
    then credits the entry its exclusive window on the reference
    event's time base (see the module doc).  The thread exists while
    the ledger is enabled and is joined by :meth:`stop`."""

    def __init__(self) -> None:
        self._q: "queue.Queue" = queue.Queue()
        self._unfinished = 0    # guard: _cv
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        #: device -> the reference event every interval is measured from
        self._ref: dict = {}
        self._ref_lock = threading.Lock()
        #: latest settled end (ms from the reference), per device
        self._last_done: dict = {}

    def reference(self, device: torch.device):
        """The reference event of ``device``, recorded on first use."""
        with self._ref_lock:
            ev = self._ref.get(device)
            if ev is None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(device))
                self._ref[device] = ev
            return ev

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="srt-ledger-settle", daemon=True)
            self._thread.start()

    def submit(self, entry: ProgramEntry, device, start, end) -> None:
        with self._cv:
            self._ensure_thread()
            self._unfinished += 1
        self._q.put((entry, device, start, end))

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Wait (bounded) until every submitted dispatch has settled;
        False on timeout."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._cv:
            while self._unfinished:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining)
        return True

    def stop(self) -> None:
        """Settle what is queued, then end and join the thread."""
        with self._cv:
            t = self._thread
            self._thread = None
        if t is not None and t.is_alive():
            self._q.put(None)
            t.join()
        with self._ref_lock:
            self._ref = {}
            self._last_done = {}

    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _task_done(self) -> None:
        with self._cv:
            self._unfinished -= 1
            if not self._unfinished:
                self._cv.notify_all()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            entry, device, start, end = item
            try:
                # a failed event raises here and is kept for the reader
                # (LEDGER.errors): the dispatch itself has returned
                end.synchronize()
                ref = self.reference(device)
                s_ms = ref.elapsed_time(start)
                e_ms = ref.elapsed_time(end)
                last = self._last_done.get(device, float("-inf"))
                credit = max(0.0, e_ms - max(s_ms, last))
                self._last_done[device] = max(last, e_ms)
                with entry.lock:
                    entry.window_ns += int(credit * 1e6)
            except Exception as e:  # noqa: BLE001 - kept, then raised
                LEDGER.errors.append(e)
            finally:
                self._task_done()


class DeviceLedger:
    """Process-wide program ledger.  ``enabled`` is THE fast-path guard
    (a dispatch reads this one attribute and does nothing else when the
    ledger is off); ``forced`` marks a programmatic :func:`enable` that
    :func:`sync_conf` must not override (the tracer's ownership rule).
    ``hbm_bytes_per_s`` / ``peak_flops`` are the card's peaks, from the
    last conf :func:`sync_conf` saw."""

    def __init__(self) -> None:
        self.enabled = False
        self.forced = False
        self.gen = 0  # bumped by reset(); stale wrapper cells re-key
        self.hbm_bytes_per_s = DEFAULT_HBM_BYTES_PER_S
        self.peak_flops = DEFAULT_PEAK_FLOPS
        self._entries: dict[Any, ProgramEntry] = {}  # guard: _lock
        self._lock = threading.Lock()
        self._enabled_by: Optional[weakref.ref] = None
        self._settle = _SettleWorker()
        #: exceptions the settle worker met (a failed CUDA event): the
        #: next dispatch, or :meth:`flush`, raises the first
        self.errors: list[BaseException] = []

    # -- recording ---------------------------------------------------- #

    def lookup(self, key: Any,
               op: Optional[str]) -> tuple[ProgramEntry, bool]:
        """(the entry of ``key``, whether this lookup made it)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = ProgramEntry(key, op, self.gen)
                return e, True
            if e.op is None and op is not None:
                e.op = op
            return e, False

    def entries(self) -> list[ProgramEntry]:
        with self._lock:
            return list(self._entries.values())

    def bind(self, entry: ProgramEntry, fn):
        """``fn`` dispatched under ``entry``: off, one attribute read
        and the passthrough call."""
        ledger = self

        def dispatch(*args, **kwargs):
            if not ledger.enabled:
                return fn(*args, **kwargs)
            return ledger._dispatch(entry, fn, args, kwargs)

        dispatch.__wrapped__ = fn
        return dispatch

    def wrap(self, key: Any, fn, op: Optional[str] = None):
        """``fn`` under the entry of ``key``, looked up at its first
        dispatch with the ledger on (and again after a reset): for a
        hook made when its module is imported, as K1's wrappers are.
        Off, one attribute read and the passthrough call."""
        cell: list = [None]
        ledger = self

        def dispatch(*args, **kwargs):
            if not ledger.enabled:
                return fn(*args, **kwargs)
            e = cell[0]
            if e is None or e.gen != ledger.gen:
                e = cell[0] = ledger.lookup(key, op)[0]
            return ledger._dispatch(e, fn, args, kwargs)

        dispatch.__wrapped__ = fn
        return dispatch

    def _dispatch(self, e: ProgramEntry, fn, args: tuple, kwargs: dict):
        """One accounted dispatch; the call's arguments and output are
        read for their bytes, never changed."""
        if self.errors:  # a failed event surfaces on the path
            raise self.errors.pop(0)
        occ = getattr(_OCC_TLS, "occ", None)
        if occ is not None:
            _OCC_TLS.occ = None
        in_bytes, dev = tensor_bytes((args, kwargs))
        start = end = None
        if dev is not None:
            self._settle.reference(dev)
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
        t0 = time.perf_counter_ns()
        out = fn(*args, **kwargs)
        t1 = time.perf_counter_ns()
        if dev is not None:
            # blocking: the settle worker sleeps in its wait instead of
            # spinning a core the pool threads need
            end = torch.cuda.Event(enable_timing=True, blocking=True)
            end.record(torch.cuda.current_stream(dev))
        if occ is None:
            occ = observe_occupancy(args)
        out_bytes, _ = tensor_bytes(out)
        with e.lock:
            e.dispatches += 1
            e.dispatch_ns += t1 - t0
            if occ[1] > 0:
                e.live_rows += occ[0]
                e.capacity_rows += occ[1]
            # a running mean: bytes_accessed is per dispatch, as the JAX
            # cost model's is per execution
            nb = float(in_bytes + out_bytes)
            e.bytes_accessed += (nb - e.bytes_accessed) / e.dispatches
        if end is not None:
            self._settle.submit(e, dev, start, end)
        return out

    # -- lifecycle --------------------------------------------------- #

    def enable(self, forced: bool = True) -> None:
        self.enabled = True
        self.forced = forced

    def disable(self) -> None:
        """Off; the settle worker drains what is queued and its thread
        is joined."""
        self.enabled = False
        self.forced = False
        self._enabled_by = None
        self._settle.stop()

    def reset(self) -> None:
        """Drop every entry; wrapper cells holding stale entries re-key
        on their next dispatch via the generation check."""
        with self._lock:
            self.gen += 1
            self._entries = {}

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Wait until every dispatch has settled; raise what the settle
        worker met (a failed event), else False on timeout."""
        ok = self._settle.flush(timeout)
        if self.errors:
            err = self.errors[0]
            self.errors = []
            raise err
        return ok

    def settle_thread_alive(self) -> bool:
        return self._settle.alive()

    # -- reading ----------------------------------------------------- #

    def snapshot(self) -> dict[str, dict]:
        """Point-in-time cumulative counters per program (key_str ->
        plain dict); per-query figures come from :func:`delta`."""
        out: dict[str, dict] = {}
        for e in self.entries():
            with e.lock:
                out[e.key_str] = {
                    "tag": e.tag,
                    "op": e.op,
                    "donated": False,
                    "dispatches": e.dispatches,
                    "dispatch_ms": round(e.dispatch_ns / 1e6, 3),
                    "window_ms": round(e.window_ns / 1e6, 3),
                    "flops": 0.0,
                    "bytes_accessed": e.bytes_accessed,
                    "live_rows": e.live_rows,
                    "capacity_rows": e.capacity_rows,
                    "live_capacity_ratio": round(
                        e.live_rows / e.capacity_rows, 4)
                    if e.capacity_rows else None,
                }
        return out


#: THE process-wide ledger; every dispatch guards on ``LEDGER.enabled``
LEDGER = DeviceLedger()


def is_enabled() -> bool:
    return LEDGER.enabled


def enable() -> None:
    """Force the ledger on (tests, chip_smoke): survives sync_conf."""
    LEDGER.enable(forced=True)


def disable() -> None:
    LEDGER.disable()


def reset_stats() -> None:
    LEDGER.reset()


def snapshot() -> dict[str, dict]:
    return LEDGER.snapshot()


def sync_conf(conf: "C.TorchConf") -> None:
    """Align the ledger with a session's conf at a query boundary: the
    peaks are the conf's (process-wide, last writer wins); a
    programmatic enable() wins, and only the conf that ENABLED the
    ledger may turn it off."""
    LEDGER.hbm_bytes_per_s = float(conf.get(C.LEDGER_HBM_BYTES_PER_S))
    LEDGER.peak_flops = float(conf.get(C.LEDGER_PEAK_FLOPS))
    if LEDGER.forced:
        return
    want = bool(conf.get(C.LEDGER_ENABLED))
    if want:
        if not LEDGER.enabled:
            LEDGER.enable(forced=False)
        LEDGER._enabled_by = weakref.ref(conf)
    elif LEDGER.enabled and LEDGER._enabled_by is not None \
            and LEDGER._enabled_by() is conf:
        LEDGER.disable()


# ------------------------------------------------------------------ #
# Analytics over snapshots (the JAX functions)
# ------------------------------------------------------------------ #


def delta(before: dict[str, dict],
          after: dict[str, dict]) -> dict[str, dict]:
    """Per-query attribution: after - before on the monotonic counters,
    cost fields carried from `after`.  Programs that did not dispatch
    in the window are dropped."""
    out: dict[str, dict] = {}
    for k, a in after.items():
        b = before.get(k, {})
        d = a["dispatches"] - b.get("dispatches", 0)
        if d <= 0:
            continue
        live = a.get("live_rows", 0) - b.get("live_rows", 0)
        cap = a.get("capacity_rows", 0) - b.get("capacity_rows", 0)
        rec = {
            "tag": a["tag"],
            "op": a["op"],
            "donated": a.get("donated", False),
            "dispatches": d,
            "dispatch_ms": round(
                a["dispatch_ms"] - b.get("dispatch_ms", 0.0), 3),
            "window_ms": round(
                a["window_ms"] - b.get("window_ms", 0.0), 3),
            "flops": a["flops"],
            "bytes_accessed": a["bytes_accessed"],
            "live_rows": live,
            "capacity_rows": cap,
            "live_capacity_ratio": round(live / cap, 4)
            if cap > 0 else None,
        }
        for mk in ("devices", "rounds"):
            if mk in a:
                rec[mk] = a[mk]
        out[k] = rec
    return out


def summarize(programs: dict[str, dict], top_n: int = 5,
              hbm_bytes_per_s: Optional[float] = None,
              peak_flops: Optional[float] = None) -> dict:
    """Enrich a snapshot/delta with attributed rooflines and totals:
    per program achieved bytes/s and ops/s over its settled window
    against the card's peaks (the synced conf's unless given), and the
    dispatch-overhead ratio; totals, a window-weighted roofline and the
    top-N programs.  A window bounds the device time from above and
    ``bytes_accessed`` bounds the bytes from below, so every rate and
    ``roofline_lower_bound`` is a lower bound."""
    if hbm_bytes_per_s is None:
        hbm_bytes_per_s = LEDGER.hbm_bytes_per_s
    if peak_flops is None:
        peak_flops = LEDGER.peak_flops
    enriched: dict[str, dict] = {}
    total_window_ms = 0.0
    total_dispatch_ms = 0.0
    total_dispatches = 0
    total_live = 0
    total_capacity = 0
    weighted_roofline = 0.0
    weighted_known_ms = 0.0
    for k, p in programs.items():
        window_s = p["window_ms"] / 1e3
        e = dict(p)
        total_live += p.get("live_rows", 0)
        total_capacity += p.get("capacity_rows", 0)
        if window_s > 0 and p["bytes_accessed"] > 0:
            bps = p["bytes_accessed"] * p["dispatches"] / window_s
            fps = p["flops"] * p["dispatches"] / window_s
            e["bytes_per_s"] = round(bps, 1)
            e["flops_per_s"] = round(fps, 1)
            e["roofline_lower_bound"] = round(
                roofline_fraction(bps, hbm_bytes_per_s), 6)
            e["flops_fraction"] = round(fps / peak_flops, 9)
            weighted_roofline += \
                e["roofline_lower_bound"] * p["window_ms"]
            weighted_known_ms += p["window_ms"]
        else:
            e["bytes_per_s"] = e["flops_per_s"] = None
            e["roofline_lower_bound"] = e["flops_fraction"] = None
        e["dispatch_overhead"] = round(
            p["dispatch_ms"] / p["window_ms"], 3) \
            if p["window_ms"] > 0 else None
        enriched[k] = e
        total_window_ms += p["window_ms"]
        total_dispatch_ms += p["dispatch_ms"]
        total_dispatches += p["dispatches"]
    top = sorted(enriched.items(),
                 key=lambda kv: -kv[1]["window_ms"])[:top_n]
    totals = {
        "programs": len(enriched),
        "dispatches": total_dispatches,
        "dispatch_ms": round(total_dispatch_ms, 3),
        "window_ms": round(total_window_ms, 3),
        "roofline_lower_bound": round(
            weighted_roofline / weighted_known_ms, 6)
        if weighted_known_ms else None,
        "live_rows": total_live,
        "capacity_rows": total_capacity,
        "live_capacity_ratio": round(total_live / total_capacity, 4)
        if total_capacity else None,
        "top": [{
            "key": k,
            "op": p["op"],
            "dispatches": p["dispatches"],
            "window_ms": p["window_ms"],
            "share": round(p["window_ms"] / total_window_ms, 3)
            if total_window_ms else 0.0,
            "live_capacity_ratio": p.get("live_capacity_ratio"),
        } for k, p in top],
    }
    return {"programs": enriched, "totals": totals}


def per_op(programs: dict[str, dict],
           hbm_bytes_per_s: Optional[float] = None) -> dict[str, dict]:
    """Aggregate a program delta by the operator that made it
    (cached_program's `op=`): per op, dispatches, window_ms and the
    attributed roofline over the op's own windows (a lower bound, as
    in :func:`summarize`)."""
    if hbm_bytes_per_s is None:
        hbm_bytes_per_s = LEDGER.hbm_bytes_per_s
    acc: dict[str, dict] = {}
    for p in programs.values():
        op = p.get("op")
        if not op:
            continue
        a = acc.setdefault(op, {"dispatches": 0, "window_ms": 0.0,
                                "bytes_total": 0.0, "live_rows": 0,
                                "capacity_rows": 0})
        a["dispatches"] += p["dispatches"]
        a["window_ms"] += p["window_ms"]
        a["bytes_total"] += p["bytes_accessed"] * p["dispatches"]
        a["live_rows"] += p.get("live_rows", 0)
        a["capacity_rows"] += p.get("capacity_rows", 0)
    out: dict[str, dict] = {}
    for op, a in acc.items():
        window_s = a["window_ms"] / 1e3
        roof = None
        if window_s > 0 and a["bytes_total"] > 0:
            roof = round(roofline_fraction(
                a["bytes_total"] / window_s, hbm_bytes_per_s), 6)
        out[op] = {"dispatches": a["dispatches"],
                   "window_ms": round(a["window_ms"], 3),
                   "roofline_lower_bound": roof,
                   "live_capacity_ratio": round(
                       a["live_rows"] / a["capacity_rows"], 4)
                   if a["capacity_rows"] else None}
    return out
