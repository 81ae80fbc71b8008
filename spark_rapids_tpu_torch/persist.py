"""The warm-start store: the on-disk tier under the serving caches.

Counterpart of ``spark_rapids_tpu/persist.py``.  Every prepared plan and
cached result dies with its process, so a restarted server starts every
dashboard cold.  This module is the one validated store later processes
read them back from:

- **prepared-plan metadata**: ``serving/plan_cache`` entries carry their
  prepare lineage (the plan fingerprint and how many processes prepared
  the template) into the next process.  A miss in memory probes the
  store; the insert that follows the re-lowering carries the restored
  metadata (``CacheEntry.rehydrated``) and writes back the next
  generation.  The lowered exec tree itself holds live state and is
  lowered again.
- **result frames**: ``serving/work_share`` result-cache entries persist
  as their exact Arrow IPC bytes with the ``plan_source_digests`` stat
  triples of their inputs.  A memory miss restores the frame lazily;
  a frame whose triples differ from the inputs' current ones is deleted
  and reads as a miss.

Every failure is an honest miss, never a wrong answer: an entry is a
magic prefix, a JSON header with the payload's length and sha256 and
the environment stamp, then the payload; a write goes to a unique temp
file and ``os.replace`` (a torn write or two writers racing leave the
old entry or a whole new one, and a truncated file fails its checksum);
an entry that fails any check is deleted and counted under ``errors``.
A byte-budget LRU sweep (``persist.maxBytes``, mtime order, entries
touched on a hit) bounds the footprint.  Writes run on one background
thread, off the query's path; :func:`flush` waits for them.

Off (``spark.rapids.tpu.persist.enabled``, the default) each probe site
reads that one key and does nothing else: no store, no thread, and this
module is not imported.

Not ported: the JAX store's program tier (``jax.export`` artifacts and
the XLA compilation cache, with ``persist.xlaCache.enabled``).  The port
compiles no programs: its one kernel library is built once into
``_build/``, keyed by its source and flags (``ops/kernels.py``), which a
restarted process finds as it is.  ``hits``, ``misses`` and
``fallback_compiles`` (that tier's counters) therefore stay 0.
"""

from __future__ import annotations

import collections
import concurrent.futures as _cf
import functools
import hashlib
import json
import os
import tempfile
import threading
import uuid
from typing import Optional

from spark_rapids_tpu_torch import config as C

#: bump when the entry layout changes: old-format files read as honest
#: misses instead of parse errors
FORMAT_VERSION = 1
_MAGIC = b"TPUPERSIST1\n"
_SUFFIX = ".tpup"

# ------------------------------------------------------------------ #
# Process-wide counters (the ``persist.*`` event-log surface)
# ------------------------------------------------------------------ #

_STATS_LOCK = threading.Lock()
_STATS: "collections.Counter" = collections.Counter()

_STAT_KEYS = (
    "hits", "misses", "writes", "evictions", "errors",
    "plan_hits", "plan_writes", "result_hits", "result_writes",
    "fallback_compiles",
)


def tick(key: str, n: float = 1) -> None:
    with _STATS_LOCK:
        _STATS[key] += n


def stats() -> dict:
    """Cumulative process-wide counters.  ``hits`` / ``misses`` /
    ``fallback_compiles`` and the two ``*_ms`` times are the JAX
    program tier's, 0 here (module docstring); ``hit_rate`` is theirs
    too."""
    with _STATS_LOCK:
        out = {k: _STATS.get(k, 0) for k in _STAT_KEYS}
        out["deserialize_ms"] = round(_STATS.get("deserialize_ms", 0.0), 3)
        out["serialize_ms"] = round(_STATS.get("serialize_ms", 0.0), 3)
    total = out["hits"] + out["misses"]
    out["hit_rate"] = round(out["hits"] / total, 3) if total else 0.0
    return out


def reset_stats() -> None:
    with _STATS_LOCK:
        _STATS.clear()


@functools.lru_cache(maxsize=1)
def env_stamp() -> dict:
    """The environment written into every entry's header: the format,
    torch's and CUDA's versions, and the card's name and compute
    capability ("cpu" without CUDA).  Plan and result entries are
    version-agnostic JSON and Arrow IPC, so a read checks the format
    only, as in the JAX store."""
    import torch

    out = {"format": FORMAT_VERSION, "torch": torch.__version__,
           "cuda": torch.version.cuda or "", "device": "cpu"}
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        out["device"] = (f"{torch.cuda.get_device_name(0)} "
                         f"sm_{major}{minor}")
    return out


# ------------------------------------------------------------------ #
# The validated store
# ------------------------------------------------------------------ #

_KINDS = ("plans", "results")


class PersistStore:
    """One store directory (module docstring).  Every write goes through
    :meth:`_write_entry` (a unique temp file, then ``os.replace``) and
    every read through :meth:`_read_entry` (magic, header, length,
    checksum and format; any failure deletes the entry and reads as
    None)."""

    def __init__(self, root: str):
        self.root = root
        for kind in _KINDS:
            os.makedirs(os.path.join(root, kind), exist_ok=True)

    # -- the entry format ------------------------------------------- #

    def _write_entry(self, path: str, meta: dict, payload: bytes) -> bool:
        header = {
            "stamp": env_stamp(),
            "meta": meta,
            "len": len(payload),
            "sha256": hashlib.sha256(payload).hexdigest(),
        }
        blob = _MAGIC + json.dumps(header).encode() + b"\n" + payload
        tmp = os.path.join(os.path.dirname(path),
                           f".tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}")
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        except OSError:
            tick("errors")
            self._delete(tmp)
            return False
        tick("writes")
        return True

    def _read_entry(self, path: str) -> Optional[tuple[dict, bytes]]:
        """(meta, payload), or None: a missing entry, or a corrupt,
        truncated or old-format one, which is deleted."""
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        try:
            if not blob.startswith(_MAGIC):
                raise ValueError("bad magic")
            rest = blob[len(_MAGIC):]
            nl = rest.index(b"\n")
            header = json.loads(rest[:nl])
            payload = rest[nl + 1:]
            if len(payload) != int(header["len"]):
                raise ValueError("truncated payload")
            if hashlib.sha256(payload).hexdigest() != header["sha256"]:
                raise ValueError("checksum mismatch")
            if int((header.get("stamp") or {}).get("format", -1)) \
                    != FORMAT_VERSION:
                raise ValueError("format mismatch")
        except (ValueError, KeyError, TypeError, json.JSONDecodeError):
            tick("errors")
            self._delete(path)
            return None
        self._touch(path)
        return header.get("meta") or {}, payload

    @staticmethod
    def _delete(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    @staticmethod
    def _touch(path: str) -> None:
        try:
            os.utime(path)
        except OSError:
            pass

    # -- eviction and the gauge -------------------------------------- #

    def _entry_files(self) -> list[tuple[float, int, str]]:
        out: list[tuple[float, int, str]] = []
        for kind in _KINDS:
            d = os.path.join(self.root, kind)
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for name in names:
                if not name.endswith(_SUFFIX):
                    continue
                p = os.path.join(d, name)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                out.append((st.st_mtime, st.st_size, p))
        return out

    def evict_over_budget(self, max_bytes: int) -> int:
        """Delete the least recently used entries (mtime order; a hit
        touches its entry) until the entries fit ``max_bytes``; how many
        went."""
        files = sorted(self._entry_files())
        total = sum(sz for _m, sz, _p in files)
        n = 0
        for _mtime, size, path in files:
            if total <= max_bytes:
                break
            self._delete(path)
            total -= size
            n += 1
        if n:
            tick("evictions", n)
        return n

    def bytes_used(self) -> int:
        """Every file's bytes under the root: the
        ``persist_cache.bytes`` gauge."""
        total = 0
        for dirpath, _dirs, names in os.walk(self.root):
            for name in names:
                try:
                    total += os.stat(os.path.join(dirpath, name)).st_size
                except OSError:
                    continue
        return total

    # -- plans ------------------------------------------------------- #

    def _plan_path(self, key: str) -> str:
        return os.path.join(self.root, "plans", f"plan-{key}{_SUFFIX}")

    def load_plan(self, key: str) -> Optional[dict]:
        rec = self._read_entry(self._plan_path(key))
        if rec is None:
            return None
        tick("plan_hits")
        return rec[0]

    def save_plan_async(self, key: str, meta: dict, max_bytes: int) -> None:
        _submit(self._save_job, self._plan_path(key), meta, b"", max_bytes,
                "plan_writes")

    # -- results ----------------------------------------------------- #

    def _result_path(self, key: str) -> str:
        return os.path.join(self.root, "results", f"res-{key}{_SUFFIX}")

    def load_result(self, key: str) -> Optional[tuple[dict, bytes]]:
        """(meta, Arrow IPC payload) or None.  Holding the frame's
        digests against the inputs' current ones is the caller's work
        (``serving/work_share``): this layer proves only that the bytes
        are the bytes that were written."""
        return self._read_entry(self._result_path(key))

    def save_result_async(self, key: str, meta: dict, payload: bytes,
                          max_bytes: int) -> None:
        path = self._result_path(key)
        if os.path.exists(path):
            return
        _submit(self._save_job, path, meta, payload, max_bytes,
                "result_writes")

    def delete_result(self, key: str) -> None:
        self._delete(self._result_path(key))

    def _save_job(self, path: str, meta: dict, payload: bytes,
                  max_bytes: int, stat_key: str) -> None:
        if self._write_entry(path, meta, payload):
            tick(stat_key)
            self.evict_over_budget(max_bytes)


# ------------------------------------------------------------------ #
# Activation and the background writer
# ------------------------------------------------------------------ #

_STORES_LOCK = threading.Lock()
_STORES: dict[str, PersistStore] = {}
_WRITER: Optional[_cf.ThreadPoolExecutor] = None  # guard: _STORES_LOCK
_PENDING: "set[_cf.Future]" = set()
_PENDING_LOCK = threading.Lock()


def _default_dir() -> str:
    who = f"{os.getuid()}" if hasattr(os, "getuid") else "user"
    return os.path.join(tempfile.gettempdir(), f"srt-persist-{who}")


def active(conf: C.TorchConf) -> Optional[PersistStore]:
    """The store of ``conf``'s directory, or None while persistence is
    off: the off path is exactly one conf read."""
    if not conf.get(C.PERSIST_ENABLED):
        return None
    root = os.path.abspath(conf.get(C.PERSIST_DIR) or _default_dir())
    with _STORES_LOCK:
        store = _STORES.get(root)
        if store is None:
            try:
                store = PersistStore(root)
            except OSError:
                tick("errors")
                return None
            _STORES[root] = store
    return store


def _submit(fn, *args) -> None:
    global _WRITER
    with _STORES_LOCK:
        if _WRITER is None:
            _WRITER = _cf.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="srt-persist")
        writer = _WRITER
    fut = writer.submit(fn, *args)
    with _PENDING_LOCK:
        _PENDING.add(fut)
    fut.add_done_callback(_discard_pending)


def _discard_pending(fut: "_cf.Future") -> None:
    with _PENDING_LOCK:
        _PENDING.discard(fut)


def flush(timeout: float = 30.0) -> bool:
    """Wait for the background writer (the barrier before another
    process reads the store); True when every write landed."""
    with _PENDING_LOCK:
        pending = list(_PENDING)
    if not pending:
        return True
    _done, not_done = _cf.wait(pending, timeout=timeout)
    return not not_done


def cache_bytes() -> int:
    """The ``persist_cache.bytes`` gauge: the bytes of every store this
    process activated (0, with no directory walk, when none was)."""
    with _STORES_LOCK:
        stores = list(_STORES.values())
    return sum(s.bytes_used() for s in stores)


def max_bytes(conf: C.TorchConf) -> int:
    return int(conf.get(C.PERSIST_MAX_BYTES))


def reset_for_tests() -> None:
    """Drain the writes, stop the writer thread, forget the activated
    stores and zero the counters."""
    global _WRITER
    flush(timeout=10.0)
    with _STORES_LOCK:
        _STORES.clear()
        writer, _WRITER = _WRITER, None
    if writer is not None:
        writer.shutdown(wait=True)
    reset_stats()
