"""Segmented window primitives over a batch sorted by (partition keys,
order keys).

Counterpart of ``spark_rapids_tpu/ops/window.py``: every window column
derives from a few segmented scans.  Segment starts give each row its
partition's first and last position (running max / reversed running
min of positions); inclusive prefix sums turn into any frame's sum and
count (``c[hi] - c[lo - 1]``); ranks are arithmetic on start positions
and peer-change flags; lead/lag are gathers clamped to the segment.

Batches hold live rows only, so there is no live mask and no capacity:
position ``i`` is row ``i``.  JAX's ``associative_scan`` has no torch
call; ``segmented_cummin_cummax`` is a log2(n)-step shifted scan over
(value, start flag).
"""

from __future__ import annotations

from typing import Optional

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import AnyColumn, Column


def _idx(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, device=device)


def _segment_ends(is_start: torch.Tensor) -> torch.Tensor:
    """True where the next row starts a segment, and at the last row."""
    is_end = torch.ones_like(is_start)
    is_end[:-1] = is_start[1:]
    return is_end


def segment_positions(is_start: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row, its segment's first and last position (inclusive)."""
    n = is_start.shape[0]
    idx = _idx(n, is_start.device)
    start_idx = torch.cummax(torch.where(is_start, idx, 0), 0).values
    last = torch.where(_segment_ends(is_start), idx, n - 1)
    end_idx = torch.cummin(last.flip(0), 0).values.flip(0)
    return start_idx, end_idx


def prefix_at(c: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``c`` is an inclusive prefix sum: the sum over [0, pos], where
    ``pos`` may be -1 (empty: 0)."""
    v = c[pos.clamp(0, c.shape[0] - 1)]
    return torch.where(pos < 0, torch.zeros_like(v), v)


def range_sum(c: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """The sum over rows [lo, hi] from inclusive prefix sums ``c``;
    empty (hi < lo): 0."""
    s = prefix_at(c, hi) - prefix_at(c, lo - 1)
    return torch.where(hi < lo, torch.zeros_like(s), s)


def frame_bounds(start_idx: torch.Tensor, end_idx: torch.Tensor,
                 lo_off: Optional[int], hi_off: Optional[int]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """A ROWS frame (offsets from the current row; None = unbounded) as
    absolute [lo, hi] clamped to the segment."""
    idx = _idx(start_idx.shape[0], start_idx.device)
    lo = start_idx if lo_off is None else torch.minimum(
        torch.maximum(idx + lo_off, start_idx), end_idx + 1)
    hi = end_idx if hi_off is None else torch.minimum(
        torch.maximum(idx + hi_off, start_idx - 1), end_idx)
    return lo, hi


def bounded_bisect(keys: torch.Tensor, targets: torch.Tensor,
                   lo_b: torch.Tensor, hi_b: torch.Tensor, side: str,
                   key_cls: Optional[torch.Tensor] = None,
                   target_cls: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Per row, the insertion point of ``targets`` in ``keys[lo_b ..
    hi_b]`` (sorted within the segment): side 'left' -> first key >=
    target, 'right' -> first key > target.  Every row searches at once,
    log2(n) + 1 rounds of gathers and compares.  ``key_cls`` /
    ``target_cls`` (int8) make the compare lexicographic on (class,
    key), so NULL and NaN rows never collide with real +-inf keys."""
    n = keys.shape[0]
    lo = lo_b.clone()
    hi = hi_b + 1
    for _ in range(max(n, 2).bit_length() + 1):
        cont = lo < hi
        mid = (lo + hi) // 2
        midc = mid.clamp(0, n - 1)
        mv = keys[midc]
        kv_lt = (mv < targets) if side == "left" else (mv <= targets)
        if key_cls is not None:
            mc = key_cls[midc]
            pred = (mc < target_cls) | ((mc == target_cls) & kv_lt)
        else:
            pred = kv_lt
        lo = torch.where(cont & pred, mid + 1, lo)
        hi = torch.where(cont & ~pred, mid, hi)
    return lo


def range_frame_bounds(okey: Column, descending: bool,
                       nulls_first_sorted: bool, fstart: Optional[int],
                       fend: Optional[int], start_idx: torch.Tensor,
                       end_idx: torch.Tensor, peer_start: torch.Tensor,
                       peer_end: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row [lo, hi] of a bounded value RANGE frame over one numeric
    order key, as Spark defines it: ascending, ``s PRECEDING .. e
    FOLLOWING`` holds the rows whose key lies in [v+s, v+e] (s < 0);
    descending measures the other way, on the negated key.  A NULL or
    NaN key's frame is its peer group.  Ordering classes mirror the
    sorted layout: NULLs -2 (first) or 4 (last), NaN 2 ascending and
    -1 descending (NaN is the largest value), every other key 1."""
    data, valid = okey.data, okey.validity
    n = data.shape[0]
    if data.is_floating_point():
        w = data.double()
        big = float("inf")
    else:
        w = data.long()
        big = torch.iinfo(torch.int64).max
    if descending:
        w = -w
    cls = torch.ones(n, dtype=torch.int8, device=data.device)
    if data.is_floating_point():
        isnan_key = valid & torch.isnan(data)
        cls = torch.where(isnan_key, -1 if descending else 2, cls)
        w = torch.where(isnan_key, big, w)  # own class: value unused
    else:
        isnan_key = torch.zeros_like(valid)
    cls = torch.where(valid, cls, -2 if nulls_first_sorted else 4).to(
        torch.int8)
    w = torch.where(valid, w, big)
    cur = torch.where(valid, w, 0)
    tcls = torch.ones_like(cls)
    lo = start_idx if fstart is None else bounded_bisect(
        w, cur + fstart, start_idx, end_idx, "left", cls, tcls)
    hi = end_idx if fend is None else bounded_bisect(
        w, cur + fend, start_idx, end_idx, "right", cls, tcls) - 1
    idx = _idx(n, data.device)
    first_peer = torch.cummax(torch.where(peer_start, idx, 0), 0).values
    special = ~valid | isnan_key
    lo = torch.where(special, first_peer, lo)
    hi = torch.where(special, peer_end, hi)
    return lo, hi


def windowed_sum_count(col: Column, lo: torch.Tensor, hi: torch.Tensor,
                       out_dtype: T.DataType
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum over the frame, non-NULL count over the frame).

    Floating sums keep NaN and +-inf out of the prefix sums and count
    them per frame instead, so a non-finite value reaches only the
    frames that hold it, as a direct sum would."""
    phys = T.to_torch_dtype(out_dtype)
    valid = col.validity
    vals = torch.where(valid, col.data.to(phys),
                       torch.zeros((), dtype=phys, device=valid.device))
    n = range_sum(torch.cumsum(valid.long(), 0), lo, hi)
    if not vals.is_floating_point():
        return range_sum(torch.cumsum(vals, 0), lo, hi), n
    finite = torch.isfinite(vals)
    s = range_sum(torch.cumsum(torch.where(finite, vals, 0.0), 0), lo, hi)

    def frame_count(mask):
        return range_sum(torch.cumsum(mask.long(), 0), lo, hi) > 0

    pos_inf = frame_count(vals == float("inf"))
    neg_inf = frame_count(vals == float("-inf"))
    nan = frame_count(torch.isnan(vals)) | (pos_inf & neg_inf)
    s = torch.where(pos_inf, float("inf"), s)
    s = torch.where(neg_inf, float("-inf"), s)
    return torch.where(nan, float("nan"), s), n


def segmented_cummin_cummax(vals: torch.Tensor, is_start: torch.Tensor,
                            op: str) -> torch.Tensor:
    """Running min or max within segments: an inclusive scan under
    combine((a, fa), (b, fb)) = (b if fb else op(a, b), fa | fb), in
    log2(n) shifted steps."""
    f = torch.minimum if op == "min" else torch.maximum
    v, flag = vals, is_start
    step = 1
    while step < v.shape[0]:
        prev_v, prev_f = v[:-step], flag[:-step]
        cur_v, cur_f = v[step:], flag[step:]
        v = torch.cat([v[:step], torch.where(cur_f, cur_v, f(prev_v, cur_v))])
        flag = torch.cat([flag[:step], cur_f | prev_f])
        step *= 2
    return v


def minmax_sentinel(dtype: torch.dtype, op: str):
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def windowed_minmax(col: Column, op: str, is_start: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor,
                    anchored_start: bool
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """min/max over frames unbounded on one side: a frame from the
    partition's start reads the forward running scan at ``hi``, a frame
    to its end the reversed running scan at ``lo``.  Returns (values,
    non-empty-frame mask).  Spark's NaN is the largest double: MAX
    propagates it (IEEE ``maximum`` does), MIN skips it unless the
    frame holds nothing else."""
    n = col.data.shape[0]
    valid = col.validity
    sent = minmax_sentinel(col.data.dtype, op)
    vals = torch.where(valid, col.data, sent)
    min_nan = col.data.is_floating_point() and op == "min"
    if min_nan:
        isnan = valid & torch.isnan(col.data)
        vals = torch.where(isnan, sent, vals)
    if anchored_start:
        run = segmented_cummin_cummax(vals, is_start, op)
        out = run[hi.clamp(0, n - 1)]
    else:
        # reversed, a segment's last row starts it
        run = segmented_cummin_cummax(
            vals.flip(0), _segment_ends(is_start).flip(0), op).flip(0)
        out = run[lo.clamp(0, n - 1)]
    cnt = range_sum(torch.cumsum(valid.long(), 0), lo, hi)
    if min_nan:
        n_nan = range_sum(torch.cumsum(isnan.long(), 0), lo, hi)
        out = torch.where((cnt > 0) & (n_nan == cnt), float("nan"), out)
    return out, cnt > 0


def gather_in_segment(col: AnyColumn, offset: int, start_idx: torch.Tensor,
                      end_idx: torch.Tensor) -> tuple[AnyColumn, torch.Tensor]:
    """lead/lag: each row's value ``offset`` rows away when that row is
    in its segment (returned mask True), else NULL."""
    n = start_idx.shape[0]
    src = _idx(n, start_idx.device) + offset
    ok = (src >= start_idx) & (src <= end_idx)
    return col.gather(src.clamp(0, max(n - 1, 0)), ok), ok
