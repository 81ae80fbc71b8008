"""Spill-tiered buffer store.

Counterpart of ``spark_rapids_tpu/memory/store.py`` (RapidsBufferCatalog
and the per-tier stores in the reference):

- ``StorageTier`` DEVICE / HOST / DISK;
- ``SpillableBatch``: the handle an operator keeps for a batch it does
  not use right now; ``get()`` hands it back on the device, restoring it
  (and re-registering it at DEVICE) when it had spilled;
- ``BufferStore``: one priority-ordered registry with byte accounting
  per tier.  ``reserve()`` makes room before a batch is admitted or
  restored by spilling the lowest ``(priority, buffer_id)`` unpinned
  entries until the device budget fits: proactive, because the caching
  allocator raises ``torch.cuda.OutOfMemoryError`` only after it has
  freed its own cached blocks and retried, and has no hook before that;
- ``SpillPriorities``: the JAX values; shuffle output spills first,
  active working batches last.

DEVICE -> HOST copies each of a batch's tensors into a host tensor,
page-locked on CUDA.  The copies are queued on the current stream, so
they run after every kernel that made the batch (the scan's side-stream
uploads are already ordered before their consumers), and the store
waits for them before it drops the device tensors or writes the host
copy to disk.  HOST -> DISK writes the ``columnar/serde.py`` frame, under
``memory.spill.compression.codec`` (``none`` or ``zlib``), to
``spill-<id>.tpub`` under ``memory.spill.dir`` or a temporary directory.
With ``memory.spill.compressHostTier`` (and a codec other than
``none``) a DEVICE -> HOST spill holds the batch as that one frame
(``_HostFrame``, JAX ``memory/store.py:316-345``): the host budget
counts the frame's bytes, a HOST -> DISK spill writes the frame as it
is, and a restore decompresses it.  ``spill_stats()`` gives the host
tier's stored bytes (``host_used``) beside the raw bytes they hold
(``host_raw_bytes``).
A restore uploads on the consumer's current stream and re-registers the
bytes at DEVICE.  Entries are keyed by batch, so a spill only moves
bytes: a run that spills gives the bits of one that does not.

Accounting counts each tensor's live rows (port batches hold no
padding rows); the JAX store counts pow2-padded capacity, so at equal
budgets the two spill at different points.  A dictionary sidecar
(``codes`` with ``dict_values``, or ``dict_chars`` / ``dict_lens``)
spills and restores with its column, so a restored key still takes
the coded group-by; a sidecar shared by sibling batches is copied per
entry, and dropping one entry's reference frees nothing the others
hold.  An array or map spills as its offsets, its row validity and its
children's leaves (``<prefix>_e``, ``_k``, ``_v``), a struct as its
validity and its fields' leaves (``<prefix>_f<i>``), and restores the
same column.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import tempfile
import threading
import time
from typing import Optional

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import trace as _trace
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import (
    Column,
    ListColumn,
    MapColumn,
    StringColumn,
    StructColumn,
)


class StorageTier(enum.IntEnum):
    DEVICE = 0
    HOST = 1
    DISK = 2


class SpillPriorities:
    """Lower spills first (the JAX values)."""

    OUTPUT_FOR_SHUFFLE = -100
    COALESCE_PENDING = 0
    SHARED_RESULT = 10
    CACHED = 20
    AGGREGATE_PARTIAL = 50
    JOIN_BUILD = 80
    #: shared by every stream partition: re-spilling is paid many times
    BROADCAST = 90
    ACTIVE_ON_DECK = 100


class ConsumedBatchError(RuntimeError):
    """A handle whose batch was handed off (``mark_consumed``)."""


def _col_leaves(c, prefix: str) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) leaves of one column, sidecar included."""
    if isinstance(c, StructColumn):
        out = [(f"{prefix}_valid", c.validity)]
        for j, kid in enumerate(c.children):
            out += _col_leaves(kid, f"{prefix}_f{j}")
        return out
    if isinstance(c, ListColumn):
        return [(f"{prefix}_offsets", c.offsets), (f"{prefix}_valid",
                                                   c.validity),
                *_col_leaves(c.child, f"{prefix}_e")]
    if isinstance(c, MapColumn):
        return [(f"{prefix}_offsets", c.offsets), (f"{prefix}_valid",
                                                   c.validity),
                *_col_leaves(c.keys, f"{prefix}_k"),
                *_col_leaves(c.values, f"{prefix}_v")]
    if isinstance(c, StringColumn):
        out = [(f"{prefix}_chars", c.chars), (f"{prefix}_lengths", c.lengths),
               (f"{prefix}_valid", c.validity)]
        if c.codes is not None:
            out += [(f"{prefix}_codes", c.codes),
                    (f"{prefix}_dchars", c.dict_chars),
                    (f"{prefix}_dlens", c.dict_lens)]
        return out
    out = [(f"{prefix}_data", c.data), (f"{prefix}_valid", c.validity)]
    if c.codes is not None:
        out += [(f"{prefix}_codes", c.codes),
                (f"{prefix}_dvals", c.dict_values)]
    return out


def _leaves(batch: ColumnarBatch) -> list[tuple[str, torch.Tensor]]:
    out: list[tuple[str, torch.Tensor]] = []
    for i, c in enumerate(batch.columns):
        out += _col_leaves(c, f"c{i}")
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def batch_device_bytes(batch: ColumnarBatch) -> int:
    """Bytes of a batch's tensors (live rows; sidecars included)."""
    return sum(_nbytes(t) for _, t in _leaves(batch))


def batch_to_host(batch: ColumnarBatch) -> dict[str, torch.Tensor]:
    """The batch's tensors copied to host tensors (page-locked from a
    CUDA batch), complete when this returns; ``__num_rows`` holds the
    row count.  The batch itself is untouched."""
    cuda = batch.device.type == "cuda"
    host: dict[str, torch.Tensor] = {}
    for name, t in _leaves(batch):
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
        h.copy_(t, non_blocking=cuda)
        host[name] = h
    if cuda:
        # the copies ran on the current stream, after the kernels that
        # made the batch; nothing reads them, or frees their sources,
        # before they are done
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(batch.device))
        done.synchronize()
    host["__num_rows"] = torch.tensor(batch.num_rows, dtype=torch.int64)
    return host


def host_bytes(arrays: dict) -> int:
    return sum(_nbytes(t) for t in arrays.values())


def _host_to_col(arrays: dict, prefix: str, dtype: T.DataType,
                 device: torch.device):
    def up(name: str) -> Optional[torch.Tensor]:
        t = arrays.get(f"{prefix}_{name}")
        return None if t is None else t.to(device, non_blocking=True)

    if isinstance(dtype, T.StructType):
        return StructColumn(tuple(
            _host_to_col(arrays, f"{prefix}_f{j}", f.dtype, device)
            for j, f in enumerate(dtype.fields)), up("valid"), dtype)
    if isinstance(dtype, T.ListType):
        return ListColumn(up("offsets"), _host_to_col(
            arrays, f"{prefix}_e", dtype.element, device), up("valid"), dtype)
    if isinstance(dtype, T.MapType):
        return MapColumn(
            up("offsets"),
            _host_to_col(arrays, f"{prefix}_k", dtype.key, device),
            _host_to_col(arrays, f"{prefix}_v", dtype.value, device),
            up("valid"), dtype)
    if isinstance(dtype, T.StringType):
        return StringColumn(up("chars"), up("lengths"), up("valid"), dtype,
                            up("codes"), up("dchars"), up("dlens"))
    return Column(up("data"), up("valid"), dtype, up("codes"), up("dvals"))


def host_to_batch(arrays: dict, schema: T.Schema,
                  device: torch.device) -> ColumnarBatch:
    """Host tensors (``batch_to_host``'s layout) uploaded to ``device``
    on its current stream."""
    cols = [_host_to_col(arrays, f"c{i}", f.dtype, device)
            for i, f in enumerate(schema.fields)]
    return ColumnarBatch(cols, int(arrays["__num_rows"]), schema, device)


def _to_numpy(arrays: dict) -> dict:
    return {k: t.numpy() for k, t in arrays.items()}


class _HostFrame:
    """A HOST entry held as one compressed serde frame (the
    compressed host tier)."""

    __slots__ = ("frame",)

    def __init__(self, frame: bytes):
        self.frame = frame


def _host_arrays(held) -> dict:
    """A HOST entry's host tensors (a frame decompressed)."""
    if isinstance(held, _HostFrame):
        from spark_rapids_tpu_torch.columnar.serde import deserialize_arrays

        return _from_numpy(deserialize_arrays(bytearray(held.frame)))
    return held


def _host_bytes(held) -> int:
    """The bytes a HOST entry holds (a frame: its length)."""
    if isinstance(held, _HostFrame):
        return len(held.frame)
    return host_bytes(held)


def _from_numpy(arrays: dict) -> dict:
    return {k: torch.from_numpy(a) for k, a in arrays.items()}


@dataclasses.dataclass
class _Entry:
    buffer_id: int
    priority: int
    nbytes: int
    tier: StorageTier
    batch: Optional[ColumnarBatch]  # DEVICE
    host: Optional[dict]  # HOST
    path: Optional[str]  # DISK
    schema: T.Schema
    device: torch.device
    #: pin count: an acquired entry is never a victim, and a shared one
    #: (a broadcast build) stays pinned until its last user unpins
    pins: int = 0
    #: host bytes parked on disk (what disk_used gives back)
    disk_bytes: int = 0
    #: raw bytes of the batch held at HOST (host_raw_bytes' share)
    host_raw: int = 0

    @property
    def pinned(self) -> bool:
        return self.pins > 0


class SpillableBatch:
    """A registered batch.  ``get()`` pins it and returns it on the
    device; ``unpin()`` makes it a spill candidate again; ``close()``
    drops it from the store."""

    def __init__(self, store: "BufferStore", buffer_id: int):
        self._store = store
        self.buffer_id = buffer_id
        self._consumed = False

    def _check(self, what: str) -> None:
        if self._consumed:
            raise ConsumedBatchError(
                f"buffer {self.buffer_id} was handed off; {what} is gone")

    def get(self) -> ColumnarBatch:
        self._check("its batch")
        return self._store.acquire(self.buffer_id)

    def get_host(self) -> dict:
        """The batch as host tensors, without a device copy (pins)."""
        self._check("its host view")
        return self._store.acquire_host(self.buffer_id)

    def mark_consumed(self) -> None:
        """Hand the batch off: the store forgets it and never spills or
        counts it again; ``unpin`` / ``close`` become no-ops."""
        if not self._consumed:
            self._consumed = True
            self._store.remove(self.buffer_id)

    @property
    def consumed(self) -> bool:
        return self._consumed

    def unpin(self) -> None:
        if self._consumed:
            return
        with self._store._lock:
            e = self._store._entries.get(self.buffer_id)
            if e is not None:
                e.pins = max(0, e.pins - 1)

    @property
    def tier(self) -> StorageTier:
        self._check("its tier")
        return self._store._entries[self.buffer_id].tier

    @property
    def nbytes(self) -> int:
        self._check("its byte count")
        return self._store._entries[self.buffer_id].nbytes

    def close(self) -> None:
        if not self._consumed:
            self._store.remove(self.buffer_id)


class BufferStore:
    def __init__(self, device_budget: Optional[int] = None,
                 host_budget: Optional[int] = None,
                 spill_dir: Optional[str] = None, codec: str = "none",
                 compress_host: bool = False):
        self.device_budget = C.DEFAULTS[C.HBM_BUDGET_BYTES] \
            if device_budget is None else device_budget
        self.host_budget = C.DEFAULTS[C.HOST_SPILL_BYTES] \
            if host_budget is None else host_budget
        self._spill_dir = spill_dir or None
        from spark_rapids_tpu_torch.columnar import compression as WC

        WC.get_bytes_codec(codec)  # an unknown codec raises here
        self._codec = codec
        self._host_compress = compress_host and codec != "none"
        self._tmpdir: Optional[tempfile.TemporaryDirectory] = None
        self._entries: dict[int, _Entry] = {}  # guard: _lock
        self._next_id = 0  # guard: _lock
        self._lock = threading.RLock()
        # guard: _lock, every counter below
        self.device_used = 0
        self.host_used = 0
        self.host_raw_bytes = 0
        self.disk_used = 0
        self.peak_device_used = 0
        self.spilled_device_to_host = 0
        self.spilled_host_to_disk = 0
        self.restores = 0
        self.restored_bytes = 0
        self.spill_ns = 0
        self.restore_ns = 0

    def spill_stats(self) -> dict[str, int]:
        """One consistent read of the gauges (``*_used``, the peak of
        ``device_used``, the raw bytes the host tier holds) and the
        monotonic totals (bytes spilled per
        hop, restores, restored bytes, ns inside spill and restore)."""
        with self._lock:
            return {
                "device_used": self.device_used,
                "host_used": self.host_used,
                "host_raw_bytes": self.host_raw_bytes,
                "disk_used": self.disk_used,
                "peak_device_used": self.peak_device_used,
                "spilled_device_to_host": self.spilled_device_to_host,
                "spilled_host_to_disk": self.spilled_host_to_disk,
                "restores": self.restores,
                "restored_bytes": self.restored_bytes,
                "spill_ns": self.spill_ns,
                "restore_ns": self.restore_ns,
            }

    def _add_device(self, nbytes: int) -> None:
        self.device_used += nbytes
        if self.device_used > self.peak_device_used:
            self.peak_device_used = self.device_used

    # -- registration --------------------------------------------------- #

    def register(self, batch: ColumnarBatch,
                 priority: int = SpillPriorities.ACTIVE_ON_DECK
                 ) -> SpillableBatch:
        """Admit a device batch, unpinned: from here the store may spill
        it, so the caller should keep no other reference to it."""
        nbytes = batch_device_bytes(batch)
        with self._lock:
            self.reserve(nbytes)
            bid = self._next_id
            self._next_id += 1
            self._entries[bid] = _Entry(bid, priority, nbytes,
                                        StorageTier.DEVICE, batch, None,
                                        None, batch.schema, batch.device)
            self._add_device(nbytes)
            return SpillableBatch(self, bid)

    def register_host(self, arrays: dict, schema: T.Schema,
                      device: torch.device,
                      priority: int = SpillPriorities.ACTIVE_ON_DECK
                      ) -> SpillableBatch:
        """Admit a batch already on the host (``batch_to_host``'s
        layout), at HOST; ``get()`` uploads it to ``device``."""
        with self._lock:
            bid = self._next_id
            self._next_id += 1
            nbytes = host_bytes(arrays)
            self._entries[bid] = _Entry(bid, priority, nbytes,
                                        StorageTier.HOST, None, arrays, None,
                                        schema, torch.device(device),
                                        host_raw=nbytes)
            self.host_used += nbytes
            self.host_raw_bytes += nbytes
            while self.host_used > self.host_budget:
                if not self._spill_one_host_locked():
                    break
            return SpillableBatch(self, bid)

    def _read_disk(self, e: _Entry) -> dict:
        from spark_rapids_tpu_torch.columnar.serde import read_spill_file

        return _from_numpy(read_spill_file(e.path))

    def acquire(self, buffer_id: int) -> ColumnarBatch:
        with self._lock:
            e = self._entries[buffer_id]
            # pinned before reserve(): a cascaded spill must never pick
            # the entry being acquired
            e.pins += 1
            if e.tier == StorageTier.DEVICE:
                return e.batch
            t0 = time.perf_counter_ns()
            try:
                with _trace.span("spill.restore", tier=e.tier.name,
                                 bytes=e.nbytes, buffer=e.buffer_id):
                    arrays = _host_arrays(e.host) \
                        if e.tier == StorageTier.HOST else self._read_disk(e)
                    self.reserve(e.nbytes)
                    batch = host_to_batch(arrays, e.schema, e.device)
            except BaseException:
                e.pins = max(0, e.pins - 1)  # a failed acquire keeps no pin
                raise
            if e.tier == StorageTier.HOST:
                self._leave_host(e)
            else:
                # unlinked only once the upload is done: a failure above
                # must not lose the only copy
                _unlink(e.path)
                self.disk_used -= e.disk_bytes
                e.disk_bytes = 0
            e.batch, e.host, e.path = batch, None, None
            e.tier = StorageTier.DEVICE
            self._add_device(e.nbytes)
            self.restores += 1
            self.restored_bytes += e.nbytes
            self.restore_ns += time.perf_counter_ns() - t0
            return batch

    def acquire_host(self, buffer_id: int) -> dict:
        """Host tensors of an entry at any tier (pins it; a DEVICE entry
        is copied down and stays on the device)."""
        with self._lock:
            e = self._entries[buffer_id]
            e.pins += 1
            try:
                if e.tier == StorageTier.HOST:
                    return _host_arrays(e.host)
                if e.tier == StorageTier.DISK:
                    return self._read_disk(e)
                return batch_to_host(e.batch)
            except BaseException:
                e.pins = max(0, e.pins - 1)
                raise

    def remove(self, buffer_id: int) -> None:
        with self._lock:
            e = self._entries.pop(buffer_id, None)
            if e is None:
                return
            if e.tier == StorageTier.DEVICE:
                self.device_used -= e.nbytes
            elif e.tier == StorageTier.HOST:
                self._leave_host(e)
            else:
                _unlink(e.path)
                self.disk_used -= e.disk_bytes
            e.batch = e.host = None

    # -- budget / spill -------------------------------------------------- #

    def reserve(self, nbytes: int) -> None:
        """Make room for ``nbytes`` on the device by spilling.  The
        ``alloc.device`` seam sits in front: a retryable failure there
        is absorbed once by spilling every unpinned entry and asking
        again; a second failure goes to the caller's split ladder."""
        from spark_rapids_tpu_torch.memory.device_manager import (
            device_alloc_checkpoint,
        )

        with self._lock:
            try:
                device_alloc_checkpoint(nbytes)
            except BaseException as err:  # noqa: BLE001 - classified below
                from spark_rapids_tpu_torch.execs.retry import is_retryable
                from spark_rapids_tpu_torch.robustness import faults

                if not is_retryable(err):
                    raise
                while self._spill_one_device_locked():
                    pass
                device_alloc_checkpoint(nbytes)
                faults.note_recovered(err, action="alloc_spill_retry")
            while self.device_used + nbytes > self.device_budget:
                if not self._spill_one_device_locked():
                    break  # nothing left to spill: let the allocator try

    def leak_report(self) -> list[str]:
        """The entries still registered (empty after a query)."""
        with self._lock:
            return [f"buffer {bid}: tier={e.tier.name} pins={e.pins} "
                    f"bytes={e.nbytes}" for bid, e in self._entries.items()]

    def assert_all_released(self) -> None:
        leaks = self.leak_report()
        assert not leaks, (f"{len(leaks)} buffer(s) never released:\n  "
                           + "\n  ".join(leaks))

    def spill_all_unpinned(self) -> int:
        """Spill every unpinned DEVICE entry (the step between retry
        attempts); how many."""
        n = 0
        with self._lock:
            while self._spill_one_device_locked():
                n += 1
        return n

    def _victim(self, tier: StorageTier) -> Optional[_Entry]:
        best = None
        for e in self._entries.values():
            if e.tier == tier and not e.pinned and (
                    best is None
                    or (e.priority, e.buffer_id)
                    < (best.priority, best.buffer_id)):
                best = e
        return best

    def _spill_one_device_locked(self) -> bool:
        e = self._victim(StorageTier.DEVICE)
        if e is None:
            return False
        t0 = time.perf_counter_ns()
        with _trace.span("spill.device_to_host", tier="DEVICE",
                         bytes=e.nbytes, buffer=e.buffer_id):
            arrays = batch_to_host(e.batch)
            held = arrays
            if self._host_compress:
                from spark_rapids_tpu_torch.columnar.serde import (
                    serialize_arrays,
                )

                held = _HostFrame(serialize_arrays(_to_numpy(arrays),
                                                   self._codec))
        e.batch, e.host, e.tier = None, held, StorageTier.HOST
        e.host_raw = host_bytes(arrays)
        self.device_used -= e.nbytes
        self.host_used += _host_bytes(held)
        self.host_raw_bytes += e.host_raw
        self.spilled_device_to_host += e.nbytes
        self.spill_ns += time.perf_counter_ns() - t0
        while self.host_used > self.host_budget:
            if not self._spill_one_host_locked():
                break
        return True

    def _spill_one_host_locked(self) -> bool:
        from spark_rapids_tpu_torch.columnar.serde import write_spill_file

        e = self._victim(StorageTier.HOST)
        if e is None:
            return False
        t0 = time.perf_counter_ns()
        path = os.path.join(self._dir(), f"spill-{e.buffer_id}.tpub")
        hb = _host_bytes(e.host)
        with _trace.span("spill.host_to_disk", tier="HOST", bytes=hb,
                         buffer=e.buffer_id):
            if isinstance(e.host, _HostFrame):
                # the host tier holds the frame already: written as is
                with open(path, "wb") as f:
                    f.write(e.host.frame)
            else:
                write_spill_file(path, _to_numpy(e.host), self._codec)
        self._leave_host(e)
        e.host, e.path, e.tier = None, path, StorageTier.DISK
        e.disk_bytes = hb
        self.disk_used += hb
        self.spilled_host_to_disk += hb
        self.spill_ns += time.perf_counter_ns() - t0
        return True

    def _leave_host(self, e: _Entry) -> None:
        """Give back a HOST entry's bytes (it is restored, removed or
        moves to disk)."""
        self.host_used -= _host_bytes(e.host)
        self.host_raw_bytes -= e.host_raw
        e.host_raw = 0

    def _dir(self) -> str:
        if self._spill_dir:
            os.makedirs(self._spill_dir, exist_ok=True)
            return self._spill_dir
        if self._tmpdir is None:
            self._tmpdir = tempfile.TemporaryDirectory(
                prefix="spark_rapids_tpu_torch_spill_")
        return self._tmpdir.name

    def close(self) -> None:
        """Drop every entry and the temporary directory; the store stays
        usable."""
        with self._lock:
            for bid in list(self._entries):
                self.remove(bid)
            if self._tmpdir is not None:
                self._tmpdir.cleanup()
                self._tmpdir = None


def _unlink(path: Optional[str]) -> None:
    if path:
        try:
            os.unlink(path)
        except OSError:
            pass


_STORE: Optional[BufferStore] = None
_STORE_LOCK = threading.Lock()


def get_store() -> BufferStore:
    """The process store (one with the default budgets until a session
    installs its own)."""
    global _STORE
    with _STORE_LOCK:
        if _STORE is None:
            _STORE = BufferStore()
        return _STORE


def peek_store() -> Optional[BufferStore]:
    """The process store, without making one."""
    with _STORE_LOCK:
        return _STORE


def reset_store(store: Optional[BufferStore] = None) -> None:
    """Close the process store and install ``store`` (None: the next
    ``get_store`` makes a default one)."""
    global _STORE
    with _STORE_LOCK:
        if _STORE is not None and _STORE is not store:
            _STORE.close()
        _STORE = store
