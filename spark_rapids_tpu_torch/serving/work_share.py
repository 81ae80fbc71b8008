"""Cross-tenant work sharing: one fleet, shared computation.

Counterpart of ``spark_rapids_tpu/serving/work_share.py``: N tenants
sending the same query should cost about one execution.  Both
mechanisms are process-wide and sleep behind one conf read while
``spark.rapids.tpu.serving.sharing.enabled`` is off (the default):

- the result cache (:class:`ResultCache`): finished results keyed by
  ``plan/share_key.plan_share_key`` (structural plan identity x conf
  fingerprint) and invalidated by the input files' stat triples.  An
  entry is the Arrow IPC frame of the first execution, registered in
  the process buffer store at HOST under ``SpillPriorities.SHARED_RESULT``,
  so under pressure it spills to disk and comes back like any parked
  batch.  A byte-budget LRU (``resultCache.budgetBytes``); a result
  over a quarter of it is not cached.  A hit is served as a new Arrow
  table read from the frame: results are Arrow, which is immutable.
- shared scans (:class:`ScanShareRegistry`): concurrent scans of one
  task with the same key (``plan/share_key.scan_share_key``) ride one
  decode.  The first is the leader and publishes each decoded host
  table as it makes it; later ones subscribe, replay the buffered
  tables, then follow live, and upload them themselves.  Only host
  Arrow tables are shared: torch tensors are mutable, so no device
  batch is ever handed to two queries (the JAX module also shares the
  leader's device batch while consumers overlap).  A completed entry's
  tables stay in a bounded LRU (``sharing.scanCache.budgetBytes``), so
  a later identical scan skips the decode too.  A leader that fails or
  is abandoned aborts the entry; its subscribers decode themselves,
  skipping the tables they already had (a task's stream is
  deterministic).
- admission-aware batching is in ``serving/scheduler.py``.

Plans that are not deterministic (partition-aware expressions, Python
functions, cached frames) and scans with runtime filters never share.
With ``spark.rapids.tpu.persist.enabled`` the result cache has a disk
tier (``persist.py``): an insert writes its frame and its stat triples
back off the query's path, and a miss in memory restores a frame whose
triples equal the inputs' current ones (a frame whose triples differ is
deleted).  Off, each of the two sites reads that one key and nothing
else.
"""

from __future__ import annotations

import collections
import threading
import weakref
from typing import Iterator, Optional

import pyarrow as pa
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.robustness.lock_tracker import tracked_lock


# ------------------------------------------------------------------ #
# Process-global counters
# ------------------------------------------------------------------ #

_STATS_LOCK = threading.Lock()
_STATS = collections.Counter()


def tick(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        _STATS[key] += n


def stats() -> dict:
    """Cumulative process-wide sharing counters.  Monotonic except the
    two gauges (``result_bytes``, ``result_entries``), which report
    the cache's current footprint."""
    with _STATS_LOCK:
        out = {k: _STATS.get(k, 0) for k in (
            "result_hits", "result_misses", "result_evictions",
            "result_invalidations", "result_inserts",
            "scan_leads", "scan_subscribes", "scan_units_shared",
            "scan_units_decoded", "scan_rows_decoded", "scan_overflows")}
    out["result_bytes"] = RESULT_CACHE.bytes_used()
    out["result_entries"] = len(RESULT_CACHE)
    total = out["result_hits"] + out["result_misses"]
    out["result_hit_rate"] = round(out["result_hits"] / total, 3) \
        if total else 0.0
    return out


def reset_stats() -> None:
    with _STATS_LOCK:
        _STATS.clear()


# ------------------------------------------------------------------ #
# Result cache
# ------------------------------------------------------------------ #


def _table_ipc(tbl: pa.Table) -> bytes:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, tbl.schema) as w:
        for b in tbl.combine_chunks().to_batches():
            w.write_batch(b)
    return sink.getvalue().to_pybytes()


def _ipc_table(buf: bytes) -> pa.Table:
    return pa.ipc.open_stream(pa.py_buffer(buf)).read_all()


class _ResultEntry:
    """One cached result: the Arrow IPC frame of the first execution,
    a HOST entry of the buffer store (spilled to disk under pressure,
    read back on a hit), and the input stat triples that invalidate
    it."""

    __slots__ = ("key", "digests", "handle", "nbytes", "rows")

    def __init__(self, key: str, digests: list, handle, nbytes: int,
                 rows: int):
        self.key = key
        self.digests = digests
        self.handle = handle
        self.nbytes = nbytes
        self.rows = rows


class ResultCache:
    """Process-wide byte-budget LRU over :class:`_ResultEntry` (module
    docstring).  An evicted or invalidated entry's store entry closes
    at once."""

    def __init__(self):
        # guard: _mu
        self._entries: "collections.OrderedDict[str, _ResultEntry]" = \
            collections.OrderedDict()
        self._mu = tracked_lock("resultCache.mu")

    def bytes_used(self) -> int:
        with self._mu:
            return sum(e.nbytes for e in self._entries.values())

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    def lookup(self, key: str, digests: list,
               conf: Optional[C.TorchConf] = None) -> Optional[pa.Table]:
        """Get-and-touch.  The entry's input digests are checked against
        the current ones first: a mismatch (an input file changed)
        invalidates the entry, counted, and reads as a miss.  A miss
        restores the frame from ``conf``'s warm-start store, if any."""
        stale = None
        with self._mu:
            e = self._entries.get(key)
            if e is not None and e.digests != digests:
                stale = self._entries.pop(key)
                e = None
            elif e is not None:
                self._entries.move_to_end(key)
        if stale is not None:
            tick("result_invalidations")
            self._close(stale)
        if e is None:
            tbl = self._restore_persisted(key, digests, conf)
            tick("result_hits" if tbl is not None else "result_misses")
            return tbl
        try:
            arrays = e.handle.get_host()  # HOST or DISK
            try:
                tbl = _ipc_table(arrays["ipc"].numpy().tobytes())
            finally:
                e.handle.unpin()
        except Exception:
            # the store entry is gone (the plugin restarted, a torn
            # spill file): drop the entry and answer with a miss,
            # never a broken hit
            with self._mu:
                if self._entries.get(key) is e:
                    del self._entries[key]
            tick("result_misses")
            return None
        tick("result_hits")
        return tbl

    def _restore_persisted(self, key: str, digests: list,
                           conf: Optional[C.TorchConf]
                           ) -> Optional[pa.Table]:
        """The frame of ``key`` from the warm-start store (one conf read
        while persistence is off).  A frame whose stat triples differ
        from ``digests`` (an input changed since it was written) is
        deleted and counted as an invalidation; one that does not parse
        is deleted and counted under ``persist.errors``.  A restored
        frame re-enters the memory tier through :meth:`insert`."""
        if conf is None or not conf.get(C.PERSIST_ENABLED):
            return None
        from spark_rapids_tpu_torch import persist

        store = persist.active(conf)
        rec = store.load_result(key) if store is not None else None
        if rec is None:
            return None
        meta, payload = rec
        if meta.get("digests") != [list(t) for t in digests]:
            store.delete_result(key)
            tick("result_invalidations")
            return None
        try:
            tbl = _ipc_table(payload)
        except Exception:
            store.delete_result(key)
            persist.tick("errors")
            return None
        persist.tick("result_hits")
        self.insert(key, digests, tbl, int(conf.get(C.RESULT_CACHE_BUDGET)),
                    conf)
        return tbl

    def insert(self, key: str, digests: list, tbl: pa.Table,
               budget: int, conf: Optional[C.TorchConf] = None) -> bool:
        """Cache one result (first writer wins); False when it is over
        a quarter of ``budget``.  The IPC frame enters the process
        store at HOST under the SHARED_RESULT priority, and with
        ``conf``'s persistence on it is written back to the warm-start
        store (a restored frame's file is there already)."""
        from spark_rapids_tpu_torch import types as T
        from spark_rapids_tpu_torch.memory.store import (
            SpillPriorities,
            get_store,
        )

        # cheap rejections before the IPC copy: tbl.nbytes bounds the
        # frame from above, and a present key never re-inserts
        if budget <= 0 or tbl.nbytes > budget:
            return False
        with self._mu:
            if key in self._entries:
                return False
        buf = _table_ipc(tbl)
        nbytes = len(buf)
        if nbytes > max(1, budget // 4):
            return False
        arrays = {"ipc": torch.frombuffer(bytearray(buf), dtype=torch.uint8)}
        handle = get_store().register_host(
            arrays, T.Schema([]), torch.device("cpu"),
            SpillPriorities.SHARED_RESULT)
        handle.unpin()
        entry = _ResultEntry(key, digests, handle, nbytes, tbl.num_rows)
        evicted: list[_ResultEntry] = []
        with self._mu:
            if key in self._entries:
                handle.close()
                return False
            self._entries[key] = entry
            used = sum(e.nbytes for e in self._entries.values())
            while used > budget and len(self._entries) > 1:
                _k, old = self._entries.popitem(last=False)
                if old is entry:  # never evict the fresh insert
                    self._entries[_k] = old
                    self._entries.move_to_end(_k, last=False)
                    break
                evicted.append(old)
                used -= old.nbytes
        for old in evicted:
            tick("result_evictions")
            self._close(old)
        if conf is not None and conf.get(C.PERSIST_ENABLED):
            from spark_rapids_tpu_torch import persist

            store = persist.active(conf)
            if store is not None:
                store.save_result_async(
                    key, {"digests": [list(t) for t in digests],
                          "rows": tbl.num_rows},
                    buf, persist.max_bytes(conf))
        tick("result_inserts")
        return True

    @staticmethod
    def _close(e: _ResultEntry) -> None:
        try:
            e.handle.close()
        except Exception:
            pass

    def reset(self) -> None:
        with self._mu:
            entries = list(self._entries.values())
            self._entries.clear()
        for e in entries:
            self._close(e)


RESULT_CACHE = ResultCache()

#: bounded (id(plan) -> (weakref, conf_fp, key)) memo so a prepared
#: template's repeat executions never re-hash in-memory table content;
#: the weakref guards against a recycled id aliasing a DEAD plan's key
#: onto different work
_KEY_MEMO: dict[int, tuple] = {}
_KEY_MEMO_LOCK = threading.Lock()


def _plan_key(plan, conf) -> Optional[str]:
    from spark_rapids_tpu_torch.eventlog import conf_fingerprint
    from spark_rapids_tpu_torch.plan.share_key import plan_share_key

    fp = conf_fingerprint(conf)
    pid = id(plan)
    with _KEY_MEMO_LOCK:
        memo = _KEY_MEMO.get(pid)
        if memo is not None and memo[0]() is plan and memo[1] == fp:
            return memo[2]
    key = plan_share_key(plan, conf)
    try:
        ref = weakref.ref(plan)
    except TypeError:
        return key
    with _KEY_MEMO_LOCK:
        if len(_KEY_MEMO) > 256:
            _KEY_MEMO.clear()
        _KEY_MEMO[pid] = (ref, fp, key)
    return key


def lookup_result(plan, conf) -> tuple[Optional[pa.Table],
                                       Optional[str]]:
    """(cached result | None, verdict): verdict is ``"hit"`` /
    ``"miss"`` for shareable plans and None for plans the determinism
    gate excludes (those never consult the cache)."""
    key = _plan_key(plan, conf)
    if key is None:
        return None, None
    from spark_rapids_tpu_torch.plan.share_key import plan_source_digests

    try:
        digests = plan_source_digests(plan)
    except OSError:
        return None, None  # a source vanished: let execution raise
    tbl = RESULT_CACHE.lookup(key, digests, conf)
    return tbl, ("hit" if tbl is not None else "miss")


def offer_result(plan, conf, tbl: pa.Table) -> None:
    """Population hook for a just-completed collect: cache the result
    when the plan is shareable (misses and unshareable plans are both
    silent — offering is always safe)."""
    key = _plan_key(plan, conf)
    if key is None:
        return
    from spark_rapids_tpu_torch.plan.share_key import plan_source_digests

    try:
        digests = plan_source_digests(plan)
    except OSError:
        return
    RESULT_CACHE.insert(key, digests, tbl,
                        int(conf.get(C.RESULT_CACHE_BUDGET)), conf)


# ------------------------------------------------------------------ #
# Shared scans: in-flight dedup + completed-entry reuse
# ------------------------------------------------------------------ #


class ScanShareAborted(RuntimeError):
    """The leader abandoned or failed the shared scan mid-stream;
    subscribers fall back to their own decode (skipping the units
    they already consumed — unit streams are deterministic)."""


def _unit_bytes(unit: pa.Table) -> int:
    return unit.nbytes


class ScanShareEntry:
    """One shared scan task's published stream of decoded host tables
    (module docstring); Arrow tables are immutable."""

    def __init__(self, key: str, cap: int = 0):
        self.key = key
        self._cv = threading.Condition()
        self._units: list = []      # guard: _cv (publish order)
        self._done = False          # guard: _cv
        self._aborted = False       # guard: _cv
        self.leader_thread = threading.get_ident()
        self._consumers = 1         # guard: _cv (starts at the leader)
        self.nbytes = 0             # guard: _cv
        #: in-flight footprint cap (scanCache.budgetBytes, 0 = none):
        #: an entry buffers its host units for the scan's LIFETIME, so
        #: without a cap one huge scan would materialize its whole
        #: decoded table set in host memory — past the cap the entry
        #: self-aborts (dropping the buffer; subscribers fall back to
        #: their own decode) rather than trade a decode for an OOM
        self._cap = int(cap)

    # -- leader side ------------------------------------------------ #

    def publish(self, unit: pa.Table) -> None:
        overflowed = False
        with self._cv:
            if self._aborted:
                return
            self._units.append(unit)
            self.nbytes += _unit_bytes(unit)
            if self._cap and self.nbytes > self._cap:
                self._abort_locked()
                overflowed = True
            self._cv.notify_all()
        if overflowed:
            tick("scan_overflows")

    def complete(self) -> None:
        with self._cv:
            self._done = True
            self._cv.notify_all()

    def _abort_locked(self) -> None:
        self._aborted = True
        self._done = True
        # free the buffered footprint NOW — subscribers mid-replay
        # observe done+aborted and fall back on their consumed count,
        # never on the dropped buffer
        self._units.clear()
        self._cv.notify_all()

    def abort(self) -> None:
        with self._cv:
            self._abort_locked()

    @property
    def done(self) -> bool:
        with self._cv:
            return self._done and not self._aborted

    # -- subscriber side -------------------------------------------- #

    def subscribe_units(self) -> Iterator[pa.Table]:
        """The published tables in order: the buffered ones first, then
        live as the leader makes them.  Raises :class:`ScanShareAborted`
        when the leader abandons mid-stream (the subscriber's fallback
        skips what it already had), or QueryCancelled when the
        subscriber's own query is cancelled while it waits (the wait is
        bounded and checks the token; a cancelled leader aborts the
        entry in its own unwind, which wakes the waiters here)."""
        from spark_rapids_tpu_torch.serving import cancel as _cancel

        i = 0
        while True:
            with self._cv:
                tok = _cancel.current_token()
                while i >= len(self._units) and not self._done:
                    self._cv.wait(_cancel.poll_timeout(tok))
                    if tok is not None:
                        tok.check()
                if i < len(self._units):
                    unit = self._units[i]
                else:
                    if self._aborted:
                        raise ScanShareAborted(self.key)
                    return
            yield unit
            i += 1


class ScanShareRegistry:
    """Process-wide registry of shared scan entries: in-flight dedup
    plus a byte-bounded LRU of completed entries."""

    def __init__(self):
        # guard: _mu
        self._entries: "collections.OrderedDict[str, ScanShareEntry]" \
            = collections.OrderedDict()
        self._mu = tracked_lock("scanShare.mu")

    def begin(self, key: str, cap: int = 0
              ) -> tuple[Optional[ScanShareEntry], bool]:
        """(entry, is_leader).  (None, False) means "do not share":
        the live entry's leader is THIS thread (a same-thread
        subscribe would deadlock — e.g. a self-join interleaving two
        scans of one table on one task thread)."""
        with self._mu:
            e = self._entries.get(key)
            if e is not None:
                with e._cv:
                    aborted = e._aborted
                if aborted:
                    e = None
                elif e.leader_thread == threading.get_ident() \
                        and not e.done:
                    return None, False
                else:
                    self._entries.move_to_end(key)
                    with e._cv:
                        e._consumers += 1
                    return e, False
            e = ScanShareEntry(key, cap=cap)
            self._entries[key] = e
            tick("scan_leads")
            return e, True

    def release(self, entry: ScanShareEntry, budget: int) -> None:
        """A consumer (leader or subscriber) finished with the entry;
        an aborted entry leaves the registry with its last consumer,
        and completed entries past ``budget`` bytes are evicted."""
        drop_key = None
        with entry._cv:
            entry._consumers -= 1
            last = entry._consumers <= 0
            aborted = entry._aborted
        if last and aborted:
            drop_key = entry.key
        if drop_key is not None:
            with self._mu:
                cur = self._entries.get(drop_key)
                if cur is entry:
                    del self._entries[drop_key]
        self._enforce_budget(budget)

    def _enforce_budget(self, budget: int) -> None:
        with self._mu:
            # snapshot size + liveness per entry under ITS lock (a
            # leader thread grows nbytes under _cv concurrently; the
            # old unlocked sum could tear against publish and evict
            # on a stale total), then evict from the locked snapshot.
            # _mu -> _cv nesting matches begin()'s acquisition order.
            sizes: dict[str, int] = {}
            busy: dict[str, bool] = {}
            used = 0
            for key in list(self._entries):
                e = self._entries[key]
                with e._cv:
                    sizes[key] = e.nbytes
                    busy[key] = e._consumers > 0 or not e._done
                used += sizes[key]
            for key in list(self._entries):
                if used <= budget:
                    break
                if busy[key]:
                    continue  # in-flight entries are never evicted
                self._entries.pop(key)
                used -= sizes[key]

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    def inflight(self) -> int:
        """Entries whose leader has not finished decoding (each read
        under its own lock, as ``complete`` / ``abort`` flip it)."""
        with self._mu:
            entries = list(self._entries.values())
        n = 0
        for e in entries:
            with e._cv:
                if not e._done:
                    n += 1
        return n

    def reset(self) -> None:
        with self._mu:
            entries = list(self._entries.values())
            self._entries.clear()
        for e in entries:
            e.abort()


SCAN_REGISTRY = ScanShareRegistry()


def record_scan_decode(rows: int) -> None:
    """The decode counter (``io/scan.py`` ticks it per decoded table):
    shared or cached executions leave it flat, unshared ones grow it
    with the sessions."""
    with _STATS_LOCK:
        _STATS["scan_units_decoded"] += 1
        _STATS["scan_rows_decoded"] += rows


def reset() -> None:
    """Tests / bench phase boundaries: drop every cache and counter."""
    RESULT_CACHE.reset()
    SCAN_REGISTRY.reset()
    with _KEY_MEMO_LOCK:
        _KEY_MEMO.clear()
    reset_stats()
