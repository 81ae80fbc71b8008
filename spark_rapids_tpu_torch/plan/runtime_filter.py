"""Runtime join filters: the build side's keys prune the probe side's
scan.

Counterpart of ``spark_rapids_tpu/plan/runtime_filter.py``.  For an
eligible join (inner or left_semi, an equi-key of a supported type on
both sides, the probe key a plain column), the build side's key column
folds into a Bloom filter and a [min, max] range **on the device** as
its batches stream through ``TpuRuntimeFilterBuildExec``
(``execs/join.py``).  Once the build side has drained, the filter is
read back and published; the probe side's file scan (Parquet, ORC or
CSV: ``io/scan.py``; the key may be a file column or a Hive partition
column, JAX ``_probe_scan_targets``) then applies it
**on the host**, where the port spends most of its time (decode and
upload), at the two of the JAX package's three points a pyarrow scan
has:

1. row-group pruning: the filter's [min, max] against each Parquet
   row group's footer statistics (``io/pushdown.py``): a pruned row
   group is never decoded (a partition column has no statistics, an
   ORC or CSV file none the scan reads: point 3 alone);
3. a post-decode row mask (``io/pa_filter.py``): rows whose key cannot
   match are dropped before they are uploaded; a dictionary column
   probes its dictionary once.  A filter whose [min, max] is narrow
   (``LUT_MAX_SPAN``) answers from a table of its Bloom over that range,
   made on the device when the filter is published, so a probe row
   costs a gather instead of two Murmur3 lanes and ``k`` bit lookups
   (the same answers: the Bloom is fixed).

Point 2, the dictionary LUT inside the JAX package's native decoder
(``io/fastpar.py``), has no counterpart: the port has no such decoder.
A ``TpuAdaptiveJoinExec`` (``execs/adaptive.py``) gets a filter as its
static partition-wise plan would: built right, below the right
exchange; and the pass sets its ``rf_build_first`` to "right", so it
runs the right map stage first and the filter is published before the
left side scans.

Soundness: a filter only drops probe rows whose key provably (min/max)
or certainly (a Bloom "no") matches no build key.  For inner and
left_semi joins such rows make no output, NULL keys included; outer and
anti joins keep non-matching rows and never get a filter.

**K6**, the device fold (``device_update`` ... ``finalize``), is plain
PyTorch, as it is jnp in the JAX package: each batch's two Murmur3
lanes (seeds ``BLOOM_SEED1`` and ``BLOOM_SEED2``) come from K1
(``kernels.hash_columns``, one launch per lane and batch); the ``k``
double-hashed bit positions ``(h1 + i*h2) mod m`` are uint32 arithmetic
emulated in int64; ``scatter_reduce_("amax")`` of 0/1 into a
byte-per-bit uint8 tensor is the OR (NULL rows scatter 0, so no
boolean-mask indexing and no sync); ``finalize`` packs the bytes into
little-endian 32-bit words, held as int64 in [0, 2^32), and makes the
one device-to-host read; a narrow range's table takes two more K1
launches and a second read.  The host probe of a wide range hashes with
the numpy mirrors in ``exprs/hashing.py``.

``spark.rapids.tpu.sql.runtimeFilter.enabled`` (``config.py``) turns
the pass on and off, and its four other keys act as in JAX:
``minMaxEnabled`` off keeps every row group and drops the row mask's
range test (and the range table, which answers only inside [min, max]);
``bloomEnabled`` off folds no Bloom (no K1 launch) and probes none; both
off inject nothing; ``maxBuildRows`` gates the build side's estimated
rows and ``fpp`` sizes the Bloom.
"""

from __future__ import annotations

import math
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.exprs import hashing

#: join types whose probe side a build side's keys may prune
ELIGIBLE_JOIN_TYPES = ("inner", "left_semi")

#: key types hashed as one 4-byte block, and as an 8-byte value
_SUPPORTED_32 = (T.ByteType, T.ShortType, T.IntegerType, T.DateType)
_SUPPORTED_64 = (T.LongType, T.TimestampType)

#: Murmur3 seeds of the two lanes, h_i = h1 + i*h2 mod m (the JAX
#: package's: Spark's default seed and the classic Murmur3 test seed)
BLOOM_SEED1 = 42
BLOOM_SEED2 = 0x9747B28C

_INT64_MAX = (1 << 63) - 1
_INT64_MIN = -(1 << 63)

#: a filter whose [min, max] holds at most this many values is published
#: with a table of its Bloom's answer for every value of the range, made
#: on the device; the host then probes a row by one gather (hashing every
#: probe row in numpy cost ~0.11 s per million rows on the host of an
#: H100 machine: PERF.md)
LUT_MAX_SPAN = 1 << 20


def supported_key_dtype(dt: T.DataType) -> bool:
    return isinstance(dt, _SUPPORTED_32 + _SUPPORTED_64)


def bloom_params(n_est: int, fpp: float) -> tuple[int, int]:
    """(n_bits, n_hashes) for an expected key count at the target false
    positive rate; n_bits is a power of two, so an index is one AND."""
    n_est = max(int(n_est), 1)
    bits = -n_est * math.log(fpp) / (math.log(2.0) ** 2)
    m = 1 << max(6, math.ceil(math.log2(max(bits, 64.0))))
    k = max(1, min(6, round(math.log(2.0) * m / n_est)))
    return m, k


# --------------------------------------------------------------------- #
# Process-wide counters (JAX ``stats()``): what the event log and
# ``explain("analyze")`` report as a query's runtime-filter activity
# --------------------------------------------------------------------- #

_STATS_LOCK = threading.Lock()
_STATS = {"filters_built": 0, "build_rows": 0, "build_ms": 0.0,
          "pruned_rows": 0, "row_groups_pruned": 0}


def stats() -> dict:
    """Filters built, their keys and build ms, and the rows and row
    groups the scans pruned with them, process-wide and cumulative."""
    with _STATS_LOCK:
        return dict(_STATS)


def reset_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0.0 if k == "build_ms" else 0


def record(key: str, v) -> None:
    if v:
        with _STATS_LOCK:
            _STATS[key] += v


# --------------------------------------------------------------------- #
# The filter
# --------------------------------------------------------------------- #

_NEXT_ID = [0]
_ID_LOCK = threading.Lock()


class _Published(NamedTuple):
    min_val: int
    max_val: int
    n_keys: int
    bloom_words: np.ndarray
    build_ms: float
    range_table: Optional[np.ndarray]


class RuntimeFilter:
    """One filter on one join key: pending until its build exec
    publishes it.  A scan never waits for it: a filter that is not
    ready applies nothing."""

    def __init__(self, key_name: str, dtype: T.DataType, join_type: str,
                 n_bits: int, n_hashes: int, build_desc: str = "",
                 use_minmax: bool = True, use_bloom: bool = True):
        with _ID_LOCK:
            _NEXT_ID[0] += 1
            self.rf_id = _NEXT_ID[0]
        self.key_name = key_name
        self.dtype = dtype
        self.join_type = join_type
        self.n_bits = n_bits
        self.n_hashes = n_hashes
        self.build_desc = build_desc
        #: which parts the filter applies (the runtime filter's keys)
        self.use_minmax = use_minmax
        self.use_bloom = use_bloom
        self.is64 = isinstance(dtype, _SUPPORTED_64)
        #: the published state, replaced as one object, so a scan that
        #: read it keeps a whole one while a reset or publish goes on
        self._pub: Optional[_Published] = None
        #: what the last drain published, kept for explain() and the
        #: tests once close() has set the filter pending again
        self.last: Optional[_Published] = None

    @property
    def ready(self) -> bool:
        return self._pub is not None

    min_val = property(lambda self: self._field("min_val"))
    max_val = property(lambda self: self._field("max_val"))
    n_keys = property(lambda self: self._field("n_keys", 0))
    #: uint32[n_bits/32]
    bloom_words = property(lambda self: self._field("bloom_words"))
    build_ms = property(lambda self: self._field("build_ms", 0.0))
    #: bool[max - min + 3]: the Bloom's answers over [min, max] between
    #: two False ends (``LUT_MAX_SPAN``), or None
    range_table = property(lambda self: self._field("range_table"))

    def _field(self, name: str, default=None):
        pub = self._pub
        return default if pub is None else getattr(pub, name)

    def reset(self) -> None:
        """Pending again: the build exec's close() calls it after a
        drain, so a cached plan's next drain starts as a first drain
        does, and its scans apply nothing until the build side has
        published this drain's keys (the last drain's may not hold)."""
        self._pub = None

    def publish(self, min_val: int, max_val: int, n_keys: int,
                bloom_words: np.ndarray, build_ms: float,
                range_table: Optional[np.ndarray] = None) -> None:
        self._pub = self.last = _Published(
            int(min_val), int(max_val), int(n_keys), bloom_words, build_ms,
            range_table)
        record("filters_built", 1)
        record("build_rows", int(n_keys))
        record("build_ms", build_ms)

    def range_may_match(self, lo, hi) -> bool:
        """Could a key in [lo, hi] pass this filter's min/max?  Unknown
        bounds keep the row group."""
        pub = self._pub
        if pub is None:
            return True
        if pub.n_keys == 0:
            return False  # an empty build side matches nothing
        if not self.use_minmax or lo is None or hi is None:
            return True
        return not (hi < pub.min_val or lo > pub.max_val)

    def probe_host(self, values, validity=None) -> np.ndarray:
        """bool[n] keep-mask for int64 key values; NULL slots (validity
        False) are dropped, since a NULL key never equi-matches."""
        values = np.asarray(values, np.int64)
        pub = self._pub
        if pub is None:
            return np.ones(len(values), bool)
        if pub.n_keys == 0:
            return np.zeros(len(values), bool)
        if pub.range_table is not None:
            # a key's offset from min - 1 lands in [1, max - min + 1]
            # exactly when the key is in range (int64 wrapping is a
            # bijection); any other offset clips onto a False end
            mask = np.take(pub.range_table, values - (pub.min_val - 1),
                           mode="clip")
        else:
            mask = (values >= pub.min_val) & (values <= pub.max_val) \
                if self.use_minmax else np.ones(len(values), bool)
            if self.use_bloom:
                rows = np.flatnonzero(mask)
                mask[rows] = self._bloom_mask(values[rows], pub.bloom_words)
        if validity is not None:
            mask &= np.asarray(validity, bool)
        return mask

    def _bloom_mask(self, values: np.ndarray,
                    bloom_words: np.ndarray) -> np.ndarray:
        """bool[n]: may each key be in the Bloom filter?"""
        if self.is64:
            h1 = hashing.np_hash_int64_blocks(values, BLOOM_SEED1)
            h2 = hashing.np_hash_int64_blocks(values, BLOOM_SEED2)
        else:
            w = values.astype(np.int32)
            h1 = hashing.np_hash_int32_block(w, BLOOM_SEED1)
            h2 = hashing.np_hash_int32_block(w, BLOOM_SEED2)
        m_mask = np.uint32(self.n_bits - 1)
        mask = np.ones(len(values), bool)
        for i in range(self.n_hashes):
            idx = (h1 + np.uint32(i) * h2) & m_mask
            bit = (bloom_words[idx >> np.uint32(5)]
                   >> (idx & np.uint32(31))) & np.uint32(1)
            mask &= bit.astype(bool)
        return mask

    def describe(self) -> str:
        pub = self._pub
        if pub is not None:
            state = f"ready n={pub.n_keys}"
        elif self.last is not None:
            state = f"pending, last drain n={self.last.n_keys}"
        else:
            state = "pending"
        parts = (["minmax"] if self.use_minmax else []) + (
            [f"bloom[{self.n_bits}b x{self.n_hashes}]"] if self.use_bloom
            else [])
        return (f"rf#{self.rf_id} key={self.key_name} "
                f"({'+'.join(parts) or 'none'}, {self.join_type}, {state})")


# --------------------------------------------------------------------- #
# K6: the device fold
# --------------------------------------------------------------------- #


def device_key_hashes(col) -> tuple[torch.Tensor, torch.Tensor]:
    """(h1, h2): the key column's two Murmur3 lanes, int64 in [0, 2^32),
    one K1 launch each.  K1 hashes INT and DATE as one 4-byte block and
    LONG as two, as the host probe does."""
    n = len(col)
    dev = col.validity.device
    return tuple(hashing.from_int32_bits(
        hashing.hash_columns([col], n, dev, seed=seed))
        for seed in (BLOOM_SEED1, BLOOM_SEED2))


def device_init_state(n_bits: int, device, use_bloom: bool = True) -> tuple:
    """(bits, lo, hi, count): a byte per Bloom bit (one byte without a
    Bloom), and int64 scalars."""
    def scalar(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    bits = torch.zeros(n_bits if use_bloom else 1, dtype=torch.uint8,
                       device=device)
    return bits, scalar(_INT64_MAX), scalar(_INT64_MIN), scalar(0)


def device_update(state: tuple, col, n_bits: int, n_hashes: int,
                  use_bloom: bool = True) -> tuple:
    """Fold one batch's key column into the state; NULL rows scatter 0
    (no bit) and count nothing.  Without a Bloom only the range and the
    count fold (no K1 launch)."""
    bits, lo, hi, count = state
    if len(col) == 0:
        return state
    v = col.data.long()
    contrib = col.validity
    lo = torch.minimum(lo, torch.where(contrib, v, _INT64_MAX).min())
    hi = torch.maximum(hi, torch.where(contrib, v, _INT64_MIN).max())
    count = count + contrib.sum()
    if not use_bloom:
        return bits, lo, hi, count
    h1, h2 = device_key_hashes(col)
    one = contrib.to(torch.uint8)
    for i in range(n_hashes):
        # (h1 + i*h2) mod 2^32, then mod m: m divides 2^32, so one AND
        # does both
        idx = (h1 + i * h2) & (n_bits - 1)
        bits.scatter_reduce_(0, idx, one, reduce="amax")
    return bits, lo, hi, count


def device_range_table(bits: torch.Tensor, lo: int, hi: int,
                       dtype: T.DataType, n_hashes: int) -> np.ndarray:
    """bool[hi - lo + 3]: the Bloom's answer for every value of [lo, hi]
    between two False ends, hashed on the device by the same two K1
    lanes as the build, and read back."""
    n = hi - lo + 1
    dev = bits.device
    keys = (torch.arange(n, dtype=torch.int64, device=dev) + lo).to(
        T.to_torch_dtype(dtype))
    h1, h2 = device_key_hashes(Column(
        keys, torch.ones(n, dtype=torch.bool, device=dev), dtype))
    hit = torch.ones(n, dtype=torch.bool, device=dev)
    for i in range(n_hashes):
        hit &= bits[(h1 + i * h2) & (bits.shape[0] - 1)].bool()
    table = np.zeros(n + 2, bool)
    table[1:-1] = hit.cpu().numpy()
    return table


def device_merge_states(a: tuple, b: tuple) -> tuple:
    return (torch.maximum(a[0], b[0]), torch.minimum(a[1], b[1]),
            torch.maximum(a[2], b[2]), a[3] + b[3])


def device_pack_bits(bits_u8: torch.Tensor) -> torch.Tensor:
    """A byte per bit, uint8[m] -> little-endian 32-bit words, int64[m/32]
    in [0, 2^32) (the layout the host probe indexes)."""
    m = bits_u8.shape[0]
    b = bits_u8.view(m // 32, 32).long()
    shifts = torch.arange(32, device=bits_u8.device)
    return (b << shifts[None, :]).sum(dim=1)


def finalize(rf: RuntimeFilter, state: tuple) -> None:
    """Pack the bits, read the state back in one transfer, make the range
    table when [min, max] is narrow and the filter applies both its
    range and its Bloom (a second read), and publish.
    ``build_ms`` is this step's wall time, the synchronous cost the
    filter puts on the build's critical path."""
    from spark_rapids_tpu_torch import trace as _trace
    from spark_rapids_tpu_torch.parallel.pipeline import device_read

    bits, lo, hi, count = state
    t0 = time.perf_counter()
    with _trace.span("rf.build", rf=rf.rf_id, key=rf.key_name):
        packed = [device_pack_bits(bits)] if rf.use_bloom else []
        host = device_read(torch.cat([lo.view(1), hi.view(1),
                                      count.view(1), *packed]),
                           tag="rf.build")
        lo, hi, n_keys = (int(v) for v in host[:3])
        table = None
        if n_keys and rf.use_minmax and rf.use_bloom \
                and hi - lo < LUT_MAX_SPAN and lo > _INT64_MIN:
            table = device_range_table(bits, lo, hi, rf.dtype, rf.n_hashes)
        build_ms = (time.perf_counter() - t0) * 1e3
        rf.publish(lo, hi, n_keys, host[3:].astype(np.uint32), build_ms,
                   table)


# --------------------------------------------------------------------- #
# The planner pass
# --------------------------------------------------------------------- #


def _probe_scan_targets(node, ordinal: int) -> list:
    """[(scan, column name)]: the scans the probe subtree reaches through
    execs that keep their child's schema, so the key's ordinal holds at
    every hop.  Any other exec ends that branch (no target, never a
    wrong one)."""
    from spark_rapids_tpu_torch.execs.adaptive import (
        CoalescedShuffleReaderExec,
    )
    from spark_rapids_tpu_torch.execs.basic import TpuFilterExec
    from spark_rapids_tpu_torch.execs.exchange import (
        TpuCoalescePartitionsExec,
        TpuShuffleExchangeExec,
    )
    from spark_rapids_tpu_torch.execs.join import TpuRuntimeFilterBuildExec
    from spark_rapids_tpu_torch.io.scan import ParquetScanExec

    passthrough = (TpuShuffleExchangeExec, TpuFilterExec,
                   TpuCoalescePartitionsExec, CoalescedShuffleReaderExec,
                   TpuRuntimeFilterBuildExec)
    out = []
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, ParquetScanExec):
            fields = n.schema.fields
            if ordinal < len(fields):
                out.append((n, fields[ordinal].name))
        elif isinstance(n, passthrough):
            stack.extend(n.children)
    return out


def _eligible_key_pairs(left_keys, right_keys,
                        build_is_right: bool) -> list:
    """[(key index, build key, probe key ordinal, dtype)] for the key
    columns a filter can be built and pushed for: the same supported
    type on both sides, the probe key a plain column."""
    from spark_rapids_tpu_torch.exprs.base import BoundReference

    build_keys = right_keys if build_is_right else left_keys
    probe_keys = left_keys if build_is_right else right_keys
    out = []
    for i, (bk, pk) in enumerate(zip(build_keys, probe_keys)):
        if not isinstance(pk, BoundReference):
            continue
        if bk.dtype != pk.dtype or not supported_key_dtype(pk.dtype):
            continue
        out.append((i, bk, pk.ordinal, pk.dtype))
    return out


def inject_runtime_filters(root, conf: C.TorchConf) -> list[RuntimeFilter]:
    """For each eligible join of the lowered plan, wrap its build side in
    a key-collecting pass-through exec and register the filters on every
    probe-side scan they reach.  Returns the filters."""
    use_minmax = conf.get(C.RF_MINMAX_ENABLED)
    use_bloom = conf.get(C.RF_BLOOM_ENABLED)
    if not conf.get(C.RF_ENABLED) or not (use_minmax or use_bloom):
        return []
    from spark_rapids_tpu_torch.execs.adaptive import TpuAdaptiveJoinExec
    from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
    from spark_rapids_tpu_torch.execs.join import (
        TpuRuntimeFilterBuildExec,
        _HashJoinBase,
    )
    from spark_rapids_tpu_torch.plan.cost import exec_estimated_rows

    max_rows = conf.get(C.RF_MAX_BUILD_ROWS)
    fpp = conf.get(C.RF_FPP)
    filters: list[RuntimeFilter] = []
    for node in list(root.walk()):
        if isinstance(node, TpuAdaptiveJoinExec):
            # its static plan builds right for every eligible type (only
            # right_outer builds left, and it is not eligible)
            build_is_right = True
        elif isinstance(node, _HashJoinBase) and node.condition is None:
            build_is_right = node.build_is_right
        else:
            continue
        jt = node.join_type
        if jt not in ELIGIBLE_JOIN_TYPES:
            continue
        pairs = _eligible_key_pairs(node.left_keys, node.right_keys,
                                    build_is_right)
        if not pairs:
            continue
        build_idx = 1 if build_is_right else 0
        build_child = node.children[build_idx]
        probe_child = node.children[1 - build_idx]
        # never act on an unknown estimate
        est = exec_estimated_rows(build_child)
        if est is None or est > max_rows:
            continue
        n_bits, n_hashes = bloom_params(est, fpp)
        entries = []
        for _i, bk, probe_ord, dt in pairs:
            targets = _probe_scan_targets(probe_child, probe_ord)
            if not targets:
                continue
            rf = RuntimeFilter(targets[0][1], dt, jt, n_bits, n_hashes,
                               build_desc=f"{node.name}[{jt}]",
                               use_minmax=use_minmax, use_bloom=use_bloom)
            for scan, col_name in targets:
                scan.runtime_filters.append((col_name, rf))
            entries.append((bk, rf))
            filters.append(rf)
        if not entries:
            continue
        # below the build side's exchange (its map stage streams the
        # whole build input once), or right under the join, which
        # collects its build side before it reads the probe side
        if isinstance(build_child, TpuShuffleExchangeExec):
            build_child.children[0] = TpuRuntimeFilterBuildExec(
                build_child.children[0], entries)
        else:
            node.children[build_idx] = TpuRuntimeFilterBuildExec(
                build_child, entries)
        if isinstance(node, TpuAdaptiveJoinExec):
            node.rf_build_first = "right"
    return filters


def plan_runtime_filters(root) -> list[RuntimeFilter]:
    """The filters of a lowered plan, in plan order."""
    from spark_rapids_tpu_torch.execs.join import TpuRuntimeFilterBuildExec

    return [rf for node in root.walk()
            if isinstance(node, TpuRuntimeFilterBuildExec)
            for _k, rf in node.entries]


def render_runtime_filters(root) -> list[str]:
    """explain() lines: one per build site and one per scan that applies
    a filter, with its pruned-row count once executed."""
    from spark_rapids_tpu_torch.execs.join import TpuRuntimeFilterBuildExec

    lines: list[str] = []
    for node in root.walk():
        if isinstance(node, TpuRuntimeFilterBuildExec):
            for _k, rf in node.entries:
                lines.append(f"build {rf.describe()} <- {rf.build_desc} "
                             f"[{node.children[0].name}]")
        for col_name, rf in getattr(node, "runtime_filters", ()):
            pruned = node.metrics["rfPrunedRows"]
            lines.append(f"apply rf#{rf.rf_id} on {node.name}.{col_name} "
                         f"(rfPrunedRows={pruned})")
    return lines
