"""String expressions over the fixed-width byte matrix.

Counterpart of ``spark_rapids_tpu/exprs/strings.py``, all of it:
``length``, ``upper`` / ``lower``, ``startswith`` / ``endswith`` /
``contains``, ``LIKE``, ``substring``, ``trim`` / ``ltrim`` / ``rtrim``,
``concat``, and the long tail: ``replace``, ``regexp_replace`` (plain
patterns), ``lpad`` / ``rpad``, ``locate``, ``substring_index``,
``initcap``, ``concat_ws``, ``split`` (its ``split(s, d)[i]`` form as
``SplitPart``) and ``get_json_object`` (CPU engine only).  A
``StringColumn`` is ``chars[N, W]`` uint8 with ``lengths`` and
``validity``; every op here is a dense program over that matrix, on the
batch's device:

- character-indexed ops (length, substring, pads, locate) number the
  characters by a cumulative sum of UTF-8 start bytes (every byte that
  is not 0b10xxxxxx);
- re-layout ops (substring, trim, replace) move each kept byte to its
  place in the row with one scatter (its place is the count of kept
  bytes before it), and concat / concat_ws gather each part's bytes at
  its offset;
- case mapping decodes UTF-8 to code points, maps them through a BMP
  table built once from Python's casing rules, and re-encodes them in
  place.  A code point whose mapped UTF-8 length differs ('ß' -> 'SS',
  'ı' -> 'I') maps to itself, as in the JAX package; 4-byte sequences
  and invalid bytes pass through unchanged;
- literal search (replace, locate, substring_index, split) finds each
  byte where a whole needle starts (``_match_starts``), then keeps the
  matches a left-to-right scan takes, as Java's ``String.replace`` and
  ``split`` do (``_greedy_matches``: one small step a byte column, the
  JAX ``lax.scan``).  A needle with no border (no proper prefix that is
  also a suffix: every one-byte needle, ``Street``) cannot overlap
  itself, so every candidate is a match and the scan is skipped.

Every output keeps the port's invariant: bytes past a row's length
are zero, and a NULL row is zeroed with length 0.  No output carries a
dictionary sidecar, so the coded group-by never reads an input's codes
for a computed string.

``Like`` takes the patterns the JAX ``Like.check_supported`` accepts
(``x``, ``x%``, ``%x``, ``%x%``, ``x%y``) and raises TypeError on the
others, as that check does; the planner then runs the node on the CPU
engine.  The long tail keeps the JAX checks too: literal needles,
lengths and separators, an ASCII pad, a ``regexp_replace`` pattern
without regex metacharacters and a replacement without ``$`` or ``\\``;
a bare ``split`` (an array of strings, which JAX keeps off its device)
and ``get_json_object`` always raise there.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import (
    AnyColumn,
    Column,
    StringColumn,
)
from spark_rapids_tpu_torch.exprs.base import (
    EvalContext,
    Expression,
    Literal,
    broadcast_validity,
)


def _string(c: AnyColumn, what: str) -> StringColumn:
    if not isinstance(c, StringColumn):
        raise TypeError(f"{what} needs a STRING input, got {c.dtype}")
    return c


def _positions(width: int, device) -> torch.Tensor:
    return torch.arange(width, dtype=torch.int32, device=device)[None, :]


def _in_string(c: StringColumn) -> torch.Tensor:
    """(N, W) True at the bytes inside each row's length."""
    return _positions(c.width, c.chars.device) < c.lengths[:, None]


def _is_char_start(chars: torch.Tensor) -> torch.Tensor:
    """True for bytes that start a UTF-8 character (not 0b10xxxxxx)."""
    return (chars & 0xC0) != 0x80


def _finish(chars: torch.Tensor, lengths: torch.Tensor,
            validity: torch.Tensor) -> StringColumn:
    """A string column with NULL rows zeroed (length 0, no bytes) and at
    least one byte column."""
    if chars.shape[1] == 0:
        chars = torch.zeros((chars.shape[0], 1), dtype=torch.uint8,
                            device=chars.device)
    lengths = torch.where(validity, lengths.to(torch.int32), 0)
    chars = chars * validity[:, None].to(torch.uint8)
    return StringColumn(chars.contiguous(), lengths, validity)


def _pack_rows(chars: torch.Tensor, keep: torch.Tensor):
    """Left-pack each row's kept bytes in order, zeros after them:
    (chars, new lengths).  One scatter: a kept byte goes to the count of
    kept bytes before it, a dropped one to a spare column cut off
    after."""
    n, w = chars.shape
    k = keep.to(torch.int32)
    dest = torch.where(keep, torch.cumsum(k, dim=1) - 1, w).to(torch.int64)
    out = torch.zeros((n, w + 1), dtype=torch.uint8, device=chars.device)
    out.scatter_(1, dest, chars)
    return out[:, :w], k.sum(dim=1)


def char_length(c: StringColumn) -> torch.Tensor:
    """Characters (not bytes) in each row, int32."""
    return (_is_char_start(c.chars) & _in_string(c)).sum(
        dim=1, dtype=torch.int32)


@dataclasses.dataclass(repr=False)
class Length(Expression):
    """character_length: characters, not bytes."""

    child: Expression

    @property
    def dtype(self) -> T.DataType:
        return T.INT

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = _string(self.child.eval(ctx), "length")
        return Column(char_length(c), c.validity, T.INT)


# --------------------------------------------------------------------- #
# Case mapping
# --------------------------------------------------------------------- #


@lru_cache(maxsize=2)
def _case_table(upper: bool) -> np.ndarray:
    """BMP code point -> its cased code point, where the mapping keeps
    the UTF-8 byte length (every other code point maps to itself)."""
    tbl = np.arange(0x10000, dtype=np.int32)
    for cp in range(0x10000):
        if 0xD800 <= cp <= 0xDFFF:  # surrogates are not characters
            continue
        ch = chr(cp)
        m = ch.upper() if upper else ch.lower()
        if len(m) == 1 and ord(m) < 0x10000 \
                and len(m.encode("utf-8")) == len(ch.encode("utf-8")):
            tbl[cp] = ord(m)
    return tbl


@lru_cache(maxsize=8)
def _device_case_table(upper: bool, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_case_table(upper)).to(device)


def _shifted(c: torch.Tensor, k: int) -> torch.Tensor:
    """Each row's bytes moved left by ``k`` columns, zero filled."""
    return torch.nn.functional.pad(c[:, k:], (0, k))


def _decode_codepoints(chars: torch.Tensor):
    """Per byte: (the code point of the character it starts, -1 on
    continuation bytes and 4-byte leads; whether it starts one).  Up to
    3-byte sequences (the BMP)."""
    c = chars.to(torch.int32)
    start = _is_char_start(chars)
    b1, b2 = _shifted(c, 1), _shifted(c, 2)
    cp2 = ((c & 0x1F) << 6) | (b1 & 0x3F)
    cp3 = ((c & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    cp = torch.where(c < 0x80, c,
                     torch.where(c < 0xE0, cp2,
                                 torch.where(c < 0xF0, cp3, -1)))
    return torch.where(start, cp, -1), start


def _forward_fill(tag: torch.Tensor, fill: torch.Tensor):
    """(each position's ``tag`` at the last position at or before it
    where ``fill`` is True, that position): -1 and -1 before the
    first."""
    pos = _positions(tag.shape[1], tag.device).expand_as(tag)
    last = torch.cummax(torch.where(fill, pos, -1), dim=1).values
    got = torch.gather(tag, 1, last.clamp(min=0).to(torch.int64))
    return torch.where(last >= 0, got, -1), last


def _encode_inplace(chars: torch.Tensor, mapped: torch.Tensor,
                    start: torch.Tensor) -> torch.Tensor:
    """Re-encode mapped code points over the same byte layout (the
    table only maps within one UTF-8 length).  A character with no
    mapping (-1: a 4-byte sequence or a stray byte) keeps its bytes."""
    c = chars.to(torch.int32)
    one = start & (mapped >= 0) & (mapped < 0x80)
    two = start & (mapped >= 0x80) & (mapped < 0x800)
    three = start & (mapped >= 0x800)
    out = torch.where(one, mapped, c)
    out = torch.where(two, 0xC0 | (mapped >> 6), out)
    out = torch.where(three, 0xE0 | (mapped >> 12), out)
    # continuation bytes take their character's code point; -2 marks a
    # character with no mapping, whose continuation bytes stay as they
    # are
    tag = torch.where(mapped >= 0, mapped, -2)
    cp_here, start_pos = _forward_fill(tag, start)
    off = _positions(c.shape[1], c.device) - start_pos
    cont1 = ~start & (off == 1)
    cont2 = ~start & (off == 2)
    is3 = cp_here >= 0x800
    out = torch.where(cont1 & is3, 0x80 | ((cp_here >> 6) & 0x3F), out)
    out = torch.where(cont1 & ~is3 & (cp_here >= 0x80),
                      0x80 | (cp_here & 0x3F), out)
    out = torch.where(cont2 & is3, 0x80 | (cp_here & 0x3F), out)
    return out.to(torch.uint8)


@dataclasses.dataclass(repr=False)
class Upper(Expression):
    child: Expression

    _upper = True

    @property
    def dtype(self) -> T.DataType:
        return T.STRING

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = _string(self.child.eval(ctx), type(self).__name__.lower())
        tbl = _device_case_table(self._upper, c.chars.device)
        cp, start = _decode_codepoints(c.chars)
        mapped = torch.where(cp >= 0, tbl[cp.clamp(0, 0xFFFF)], cp)
        chars = _encode_inplace(c.chars, mapped, start)
        chars = chars * _in_string(c).to(torch.uint8)
        return _finish(chars, c.lengths, c.validity)


class Lower(Upper):
    _upper = False


# --------------------------------------------------------------------- #
# Search (literal needles) and LIKE
# --------------------------------------------------------------------- #


def _needle_bytes(e: Expression) -> bytes:
    if not isinstance(e, Literal):
        raise TypeError("the needle must be a literal")
    return (e.value or "").encode("utf-8")


def _needle(nb: bytes, device) -> torch.Tensor:
    return torch.tensor(list(nb), dtype=torch.uint8, device=device)


@dataclasses.dataclass(repr=False)
class StartsWith(Expression):
    left: Expression
    right: Expression  # a literal

    @property
    def dtype(self) -> T.DataType:
        return T.BOOLEAN

    @staticmethod
    def _match(c: StringColumn, nb: bytes) -> torch.Tensor:
        m = len(nb)
        if m == 0:
            return torch.ones(len(c), dtype=torch.bool,
                              device=c.chars.device)
        if m > c.width:
            return torch.zeros(len(c), dtype=torch.bool,
                               device=c.chars.device)
        return (c.lengths >= m) & (
            c.chars[:, :m] == _needle(nb, c.chars.device)).all(dim=1)

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = _string(self.left.eval(ctx), type(self).__name__.lower())
        r = self.right.eval(ctx)
        return Column(self._match(c, _needle_bytes(self.right)),
                      broadcast_validity(c, r), T.BOOLEAN)


class EndsWith(StartsWith):
    @staticmethod
    def _match(c: StringColumn, nb: bytes) -> torch.Tensor:
        m = len(nb)
        if m == 0 or m > c.width:
            return StartsWith._match(c, nb)
        idx = (c.lengths - m).clamp(min=0)[:, None].to(torch.int64) \
            + torch.arange(m, device=c.chars.device)[None, :]
        tail = torch.gather(c.chars, 1, idx.clamp(max=c.width - 1))
        return (c.lengths >= m) & (
            tail == _needle(nb, c.chars.device)).all(dim=1)


class Contains(StartsWith):
    @staticmethod
    def _match(c: StringColumn, nb: bytes) -> torch.Tensor:
        m = len(nb)
        if m == 0 or m > c.width:
            return StartsWith._match(c, nb)
        windows = c.chars.unfold(1, m, 1)  # (N, W - m + 1, m)
        hit = (windows == _needle(nb, c.chars.device)).all(dim=2)
        fits = _positions(c.width - m + 1, c.chars.device) + m \
            <= c.lengths[:, None]
        return (hit & fits).any(dim=1)


@dataclasses.dataclass(repr=False)
class Like(Expression):
    """SQL LIKE for the patterns ``x``, ``x%``, ``%x``, ``%x%`` and
    ``x%y``; a pattern with ``_``, an escape or more ``%`` raises
    TypeError (``check_supported``)."""

    left: Expression
    pattern: str

    @property
    def dtype(self) -> T.DataType:
        return T.BOOLEAN

    def check_supported(self) -> None:
        p = self.pattern
        if "_" in p:
            raise TypeError("LIKE with '_' is not ported")
        if "\\" in p:
            raise TypeError("LIKE with escapes is not ported")
        inner = p.strip("%")
        if "%" in inner and len(inner.split("%")) != 2:
            raise TypeError(f"LIKE pattern {p!r} is not ported")

    def eval(self, ctx: EvalContext) -> AnyColumn:
        self.check_supported()
        c = _string(self.left.eval(ctx), "like")
        p = self.pattern
        lead, trail = p.startswith("%"), p.endswith("%")
        inner = p.strip("%")
        nb = inner.encode("utf-8")
        if "%" in inner:
            pre, suf = (s.encode("utf-8") for s in inner.split("%"))
            out = (StartsWith._match(c, pre) & EndsWith._match(c, suf)
                   & (c.lengths >= len(pre) + len(suf)))
        elif lead and trail:
            out = Contains._match(c, nb)
        elif trail:
            out = StartsWith._match(c, nb)
        elif lead:
            out = EndsWith._match(c, nb)
        else:
            out = StartsWith._match(c, nb) & (c.lengths == len(nb))
        return Column(out, c.validity, T.BOOLEAN)


# --------------------------------------------------------------------- #
# Re-layout ops
# --------------------------------------------------------------------- #


@dataclasses.dataclass(repr=False)
class Substring(Expression):
    """substring(str, pos[, len]): characters, 1-based; pos 0 counts as
    1 and a negative pos counts from the end.  As Spark's
    ``substringSQL``, the length runs from the unclamped start:
    substring('abc', -5, 3) = 'a'."""

    child: Expression
    pos: int
    length: Optional[int] = None

    @property
    def dtype(self) -> T.DataType:
        return T.STRING

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = _string(self.child.eval(ctx), "substring")
        nchars = char_length(c).to(torch.int64)
        if self.pos > 0:
            start = torch.full_like(nchars, self.pos - 1)
        elif self.pos == 0:
            start = torch.zeros_like(nchars)
        else:
            start = nchars + self.pos
        end = nchars if self.length is None \
            else start + max(self.length, 0)
        start = start.clamp(min=0)
        in_str = _in_string(c)
        char_idx = torch.cumsum((_is_char_start(c.chars) & in_str)
                                .to(torch.int64), dim=1) - 1
        keep = in_str & (char_idx >= start[:, None]) \
            & (char_idx < end[:, None])
        chars, lengths = _pack_rows(c.chars, keep)
        return _finish(chars, lengths, c.validity)


@dataclasses.dataclass(repr=False)
class StringTrim(Expression):
    """trim(str): leading and trailing spaces (0x20) removed; ltrim and
    rtrim one side each."""

    child: Expression

    _lead = True
    _trail = True

    @property
    def dtype(self) -> T.DataType:
        return T.STRING

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = _string(self.child.eval(ctx), "trim")
        in_str = _in_string(c)
        sp = (c.chars == 32) & in_str
        keep = in_str
        if self._lead:
            keep = keep & (torch.cumprod(sp.to(torch.int32), dim=1) == 0)
        if self._trail:
            rev = (sp | ~in_str).flip(1).to(torch.int32)
            keep = keep & (torch.cumprod(rev, dim=1).flip(1) == 0)
        chars, lengths = _pack_rows(c.chars, keep)
        return _finish(chars, lengths, c.validity)


class StringTrimLeft(StringTrim):
    _trail = False


class StringTrimRight(StringTrim):
    _lead = False


@dataclasses.dataclass(repr=False)
class Concat(Expression):
    """concat(s1, s2, ...): NULL when any input is NULL, as Spark's
    concat."""

    exprs: tuple[Expression, ...]

    def __init__(self, *exprs: Expression):
        self.exprs = tuple(exprs)

    @property
    def children(self) -> tuple[Expression, ...]:
        return self.exprs

    def with_children(self, children):
        return Concat(*children)

    @property
    def dtype(self) -> T.DataType:
        return T.STRING

    def eval(self, ctx: EvalContext) -> AnyColumn:
        cols = [_string(e.eval(ctx), "concat") for e in self.exprs]
        dev = cols[0].chars.device
        n = len(cols[0])
        width = sum(c.width for c in cols)
        out_pos = _positions(width, dev)
        chars = torch.zeros((n, width), dtype=torch.uint8, device=dev)
        offset = torch.zeros(n, dtype=torch.int32, device=dev)
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        for c in cols:
            src = out_pos - offset[:, None]
            inside = (src >= 0) & (src < c.lengths[:, None])
            got = torch.gather(c.chars, 1,
                               src.clamp(0, c.width - 1).to(torch.int64))
            chars = torch.where(inside, got, chars)
            offset = offset + c.lengths
            valid = valid & c.validity
        return _finish(chars, offset, valid)


# --------------------------------------------------------------------- #
# The long tail: literal search, pads, locate, substring_index, initcap,
# concat_ws, split
# --------------------------------------------------------------------- #


def _has_border(nb: bytes) -> bool:
    """Whether a proper prefix of the needle is also its suffix: only
    then can two of its matches overlap."""
    return any(nb[:k] == nb[-k:] for k in range(1, len(nb)))


def _match_starts(c: StringColumn, nb: bytes) -> torch.Tensor:
    """(N, W) True where a whole needle starts, inside the row's
    length."""
    m, w = len(nb), c.width
    dev = c.chars.device
    if m == 0 or m > w:
        return torch.zeros((len(c), w), dtype=torch.bool, device=dev)
    hit = (c.chars.unfold(1, m, 1) == _needle(nb, dev)).all(dim=2)
    hit = hit & (_positions(w - m + 1, dev) + m <= c.lengths[:, None])
    return torch.nn.functional.pad(hit, (0, m - 1))


def _greedy_matches(starts: torch.Tensor, nb: bytes) -> torch.Tensor:
    """The candidates a left-to-right scan keeps: one is real unless a
    real match before it still covers it (Java's non-overlapping
    search).  A needle with no border never overlaps itself, so every
    candidate is real; otherwise one step a byte column."""
    m = len(nb)
    if not _has_border(nb):
        return starts
    n, w = starts.shape
    reals = torch.zeros_like(starts)
    free_from = torch.zeros(n, dtype=torch.int64, device=starts.device)
    for j in range(w - m + 1):
        real = starts[:, j] & (free_from <= j)
        reals[:, j] = real
        free_from = torch.where(real, j + m, free_from)
    return reals


def _covered(reals: torch.Tensor, m: int) -> torch.Tensor:
    """(N, W) True at the bytes inside a real match (matches never
    overlap, so a running count of starts minus ends is 0 or 1)."""
    marks = reals.to(torch.int32)
    ends = torch.nn.functional.pad(marks, (m, 0))[:, :marks.shape[1]]
    return torch.cumsum(marks - ends, dim=1) > 0


def _empty_like(c: StringColumn) -> StringColumn:
    """Empty strings where ``c`` is valid."""
    n = len(c)
    return _finish(torch.zeros((n, 1), dtype=torch.uint8,
                               device=c.chars.device),
                   torch.zeros(n, dtype=torch.int32, device=c.chars.device),
                   c.validity)


@dataclasses.dataclass(repr=False)
class StringReplace(Expression):
    """replace(str, search, replacement), literal search and
    replacement: every non-overlapping match, left to right, as Java's
    ``String.replace``; an empty search leaves the input as it is.  The
    output is as wide as the batch's longest result (one sync)."""

    child: Expression
    search: Expression  # literal
    replacement: Expression  # literal

    @property
    def dtype(self) -> T.DataType:
        return T.STRING

    @property
    def name(self) -> str:
        return (f"replace({self.child.name}, {self.search.name}, "
                f"{self.replacement.name})")

    def check_supported(self) -> None:
        if not isinstance(self.search, Literal) \
                or not isinstance(self.replacement, Literal):
            raise TypeError("replace search/replacement must be literals")

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = _string(self.child.eval(ctx), "replace")
        sb = _needle_bytes(self.search)
        rb = _needle_bytes(self.replacement)
        m, r = len(sb), len(rb)
        if m == 0 or m > c.width:
            return c
        reals = _greedy_matches(_match_starts(c, sb), sb)
        covered = _covered(reals, m)
        in_str = _in_string(c)
        contrib = torch.where(reals, r, (in_str & ~covered).to(torch.int64))
        out_end = torch.cumsum(contrib, dim=1)
        out_start = out_end - contrib
        new_len = out_end[:, -1]
        w_out = max(int(new_len.max()) if len(c) else 0, 1)
        out = torch.zeros((len(c), w_out + 1), dtype=torch.uint8,
                          device=c.chars.device)
        plain = in_str & ~covered
        out.scatter_(1, torch.where(plain, out_start, w_out), c.chars)
        for k in range(r):
            dest = torch.where(reals, out_start + k, w_out)
            out.scatter_(1, dest, torch.full_like(c.chars, rb[k]))
        return _finish(out[:, :w_out], new_len, c.validity)


@dataclasses.dataclass(repr=False)
class RegExpReplace(StringReplace):
    """regexp_replace with a pattern that is a plain string (no regex
    metacharacter) and a replacement without back-references: the
    replace above.  A real regular expression raises in
    ``check_supported`` and runs on the CPU engine."""

    _META = frozenset("\\^$.|?*+()[]{}")

    def check_supported(self) -> None:
        super().check_supported()
        pat = self.search.value
        if pat is None or any(ch in self._META for ch in pat):
            raise TypeError(
                f"regexp pattern {pat!r} is a real regular expression; "
                "the GPU runs only plain-string patterns (CPU fallback)")
        rep = self.replacement.value
        if rep is not None and ("$" in rep or "\\" in rep):
            raise TypeError(
                "regexp replacement with backrefs is not supported")


@dataclasses.dataclass(repr=False)
class StringLPad(Expression):
    """lpad(str, len, pad) with a literal length and an ASCII literal
    pad: characters, not bytes.  A string longer than ``len`` is cut to
    its first ``len`` characters (rpad too); an empty pad leaves the
    string unpadded; ``len`` <= 0 gives ''."""

    child: Expression
    length: Expression  # literal int
    pad: Expression  # literal string

    _left = True

    @property
    def dtype(self) -> T.DataType:
        return T.STRING

    def check_supported(self) -> None:
        if not isinstance(self.length, Literal) \
                or not isinstance(self.pad, Literal):
            raise TypeError("pad length/fill must be literals")
        if any(ord(ch) > 127 for ch in (self.pad.value or "")):
            raise TypeError("non-ASCII pad strings not supported on the GPU")

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = _string(self.child.eval(ctx), "pad")
        target = int(self.length.value)
        pb = _needle_bytes(self.pad)
        if target <= 0:
            return _empty_like(c)
        dev = c.chars.device
        nchars = char_length(c).to(torch.int64)
        npad = (target - nchars).clamp(min=0) if pb \
            else torch.zeros_like(nchars)
        w = c.width + target
        pos = _positions(w, dev).to(torch.int64)
        chars = torch.nn.functional.pad(c.chars, (0, target))
        fill = _needle((pb * (w // max(len(pb), 1) + 1))[:w], dev) if pb \
            else torch.zeros(w, dtype=torch.uint8, device=dev)
        lengths = c.lengths.to(torch.int64)[:, None]
        if self._left:
            src = pos - npad[:, None]
            got = torch.gather(chars, 1, src.clamp(min=0))
            out = torch.where(src >= 0, got, fill[None, :])
        else:
            pad_at = (pos - lengths).clamp(min=0)
            out = torch.where(pos < lengths, chars, fill[pad_at])
        total = lengths + npad[:, None]
        # the first ``target`` characters (pad bytes are ASCII)
        in_out = pos < total
        char_idx = torch.cumsum((_is_char_start(out) & in_out)
                                .to(torch.int32), dim=1)
        keep = in_out & (char_idx <= target)
        return _finish(out * keep.to(torch.uint8), keep.sum(dim=1),
                       c.validity)


class StringRPad(StringLPad):
    _left = False


@dataclasses.dataclass(repr=False)
class StringLocate(Expression):
    """locate(substr, str, start): the 1-based character position of
    the first match at or after character ``start``, 0 when there is
    none or ``start`` <= 0; an empty substr gives min(start, length +
    1), as Java's indexOf.  Literal substr and start."""

    substr: Expression  # literal
    child: Expression
    start: Expression  # literal int

    @property
    def dtype(self) -> T.DataType:
        return T.INT

    def check_supported(self) -> None:
        if not isinstance(self.substr, Literal) \
                or not isinstance(self.start, Literal):
            raise TypeError("locate substr/start must be literals")

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = _string(self.child.eval(ctx), "locate")
        nb = _needle_bytes(self.substr)
        start = int(self.start.value)
        dev = c.chars.device
        if start <= 0:
            out = torch.zeros(len(c), dtype=torch.int32, device=dev)
        elif not nb:
            out = (char_length(c) + 1).clamp(max=start)
        else:
            char_pos = torch.cumsum(_is_char_start(c.chars)
                                    .to(torch.int32), dim=1)
            cand = _match_starts(c, nb) & (char_pos >= start)
            best = torch.where(cand, char_pos, 2 ** 30).min(dim=1).values
            out = torch.where(best < 2 ** 30, best, 0).to(torch.int32)
        return Column(out, c.validity, T.INT)


@dataclasses.dataclass(repr=False)
class SubstringIndex(Expression):
    """substring_index(str, delim, count): the text before the
    ``count``-th delimiter (all of it when there are fewer); a negative
    count takes the text after the ``|count|``-th delimiter from the
    right; 0 or an empty delimiter gives ''.  Literal delim and count."""

    child: Expression
    delim: Expression  # literal
    count: Expression  # literal int

    @property
    def dtype(self) -> T.DataType:
        return T.STRING

    def check_supported(self) -> None:
        if not isinstance(self.delim, Literal) \
                or not isinstance(self.count, Literal):
            raise TypeError("substring_index delim/count must be literals")

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = _string(self.child.eval(ctx), "substring_index")
        db = _needle_bytes(self.delim)
        count = int(self.count.value)
        m = len(db)
        if count == 0 or m == 0:
            return _empty_like(c)
        if m > c.width:
            return c
        reals = _greedy_matches(_match_starts(c, db), db)
        occ = torch.cumsum(reals.to(torch.int32), dim=1)
        pos = _positions(c.width, c.chars.device).to(torch.int64)
        lengths = c.lengths.to(torch.int64)
        if count > 0:
            cut = torch.where(reals & (occ == count), pos, 2 ** 30)
            new_len = torch.minimum(cut.min(dim=1).values, lengths)
            keep = pos < new_len[:, None]
            return _finish(c.chars * keep.to(torch.uint8), new_len,
                           c.validity)
        want = occ[:, -1] + count  # delimiters before the kept text
        after = torch.where(reals & (occ == (want + 1)[:, None]), pos + m,
                            -1).max(dim=1).values
        start = torch.where(want < 0, 0, after.clamp(min=0))
        new_len = lengths - start
        src = (pos + start[:, None]).clamp(max=c.width - 1)
        chars = torch.gather(c.chars, 1, src)
        keep = pos < new_len[:, None]
        return _finish(chars * keep.to(torch.uint8), new_len, c.validity)


@dataclasses.dataclass(repr=False)
class InitCap(Expression):
    """initcap: each character after a space (0x20) or at the start
    upper-cased, every other lower-cased, through the case tables
    (their byte-length caveat holds)."""

    child: Expression

    @property
    def dtype(self) -> T.DataType:
        return T.STRING

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = _string(self.child.eval(ctx), "initcap")
        dev = c.chars.device
        cp, start = _decode_codepoints(c.chars)
        prev = torch.nn.functional.pad(c.chars[:, :-1], (1, 0),
                                       value=0x20)
        word_start = start & (prev == 0x20)
        safe = cp.clamp(0, 0xFFFF)
        mapped = torch.where(word_start, _device_case_table(True, dev)[safe],
                             _device_case_table(False, dev)[safe])
        mapped = torch.where(cp >= 0, mapped, cp)
        chars = _encode_inplace(c.chars, mapped, start)
        chars = chars * _in_string(c).to(torch.uint8)
        return _finish(chars, c.lengths, c.validity)


@dataclasses.dataclass(repr=False)
class ConcatWs(Expression):
    """concat_ws(sep, s1, s2, ...) with a literal separator: the valid
    inputs joined by it, NULLs skipped, '' when none is valid; NULL
    only when the separator is NULL."""

    sep: Expression  # literal
    exprs: tuple[Expression, ...]

    def __init__(self, sep: Expression, *exprs: Expression):
        self.sep = sep
        self.exprs = tuple(exprs)

    @property
    def children(self) -> tuple[Expression, ...]:
        return (self.sep,) + self.exprs

    def with_children(self, children):
        return ConcatWs(*children)

    @property
    def dtype(self) -> T.DataType:
        return T.STRING

    @property
    def nullable(self) -> bool:
        return self.sep.nullable

    @property
    def name(self) -> str:
        return "concat_ws(" + ", ".join(
            e.name for e in (self.sep,) + self.exprs) + ")"

    def check_supported(self) -> None:
        if not isinstance(self.sep, Literal):
            raise TypeError("concat_ws separator must be a literal")

    def eval(self, ctx: EvalContext) -> AnyColumn:
        sep = _needle_bytes(self.sep)
        cols = [_string(e.eval(ctx), "concat_ws") for e in self.exprs]
        n, dev = ctx.batch.num_rows, ctx.batch.device
        width = max(sum(c.width for c in cols)
                    + len(sep) * max(len(cols) - 1, 0), 1)
        out_pos = _positions(width, dev)
        chars = torch.zeros((n, width), dtype=torch.uint8, device=dev)
        offset = torch.zeros(n, dtype=torch.int32, device=dev)
        any_prev = torch.zeros(n, dtype=torch.bool, device=dev)
        sep_t = _needle(sep, dev) if sep else None
        for c in cols:
            if sep_t is not None:
                here = c.validity & any_prev
                src = out_pos - offset[:, None]
                inside = here[:, None] & (src >= 0) & (src < len(sep))
                chars = torch.where(inside, sep_t[src.clamp(0, len(sep) - 1)
                                                  .to(torch.int64)], chars)
                offset = offset + torch.where(here, len(sep), 0)
            src = out_pos - offset[:, None]
            inside = c.validity[:, None] & (src >= 0) \
                & (src < c.lengths[:, None])
            got = torch.gather(c.chars, 1,
                               src.clamp(0, c.width - 1).to(torch.int64))
            chars = torch.where(inside, got, chars)
            offset = offset + torch.where(c.validity, c.lengths, 0)
            any_prev = any_prev | c.validity
        valid = torch.full((n,), self.sep.value is not None,
                           dtype=torch.bool, device=dev)
        return _finish(chars, offset, valid)


@dataclasses.dataclass(repr=False)
class StringSplit(Expression):
    """split(str, pattern[, limit]): an array of strings, which has no
    device layout here, as in the JAX package: ``check_supported``
    always raises, so a bare split runs on the CPU engine; the planner
    rewrites its ``split(s, d)[i]`` form, over a plain literal
    delimiter, to ``SplitPart``."""

    child: Expression
    delim: Expression  # literal
    limit: int = -1

    _META = RegExpReplace._META

    @property
    def dtype(self) -> T.DataType:
        return T.ListType(T.STRING)

    @property
    def name(self) -> str:
        return f"split({self.child.name}, {self.delim.name})"

    def check_supported(self) -> None:
        if not isinstance(self.delim, Literal) or not self.delim.value:
            raise TypeError("split delimiter must be a non-empty literal")
        if any(ch in self._META for ch in self.delim.value):
            raise TypeError(
                f"split pattern {self.delim.value!r} is a real regular "
                "expression; the GPU runs only plain-string delimiters")
        if self.limit != -1:
            raise TypeError("split with an explicit limit falls back")
        raise TypeError(
            "bare split() produces array<string> (no dense device "
            "layout); only the split(s, d)[i] form runs on device — "
            "CPU fallback")

    def eval(self, ctx: EvalContext):
        raise AssertionError("rewritten by the planner or CPU-run")


@dataclasses.dataclass(repr=False)
class SplitPart(Expression):
    """split(str, delim)[index]: the index-th piece between plain
    delimiters (0-based; Java's split keeps trailing empty pieces), NULL
    past the last piece."""

    child: Expression
    delim: Expression  # literal, plain, non-empty
    index: int

    @property
    def dtype(self) -> T.DataType:
        return T.STRING

    @property
    def name(self) -> str:
        return f"split({self.child.name}, {self.delim.name})[{self.index}]"

    def check_supported(self) -> None:
        if not isinstance(self.delim, Literal) or not self.delim.value:
            raise TypeError("split delimiter must be a non-empty literal")
        if any(ch in StringSplit._META for ch in self.delim.value):
            raise TypeError("regex delimiters fall back")
        if self.index < 0:
            raise TypeError("negative split index falls back")

    def eval(self, ctx: EvalContext) -> AnyColumn:
        c = _string(self.child.eval(ctx), "split")
        db = _needle_bytes(self.delim)
        m, k = len(db), self.index
        if m > c.width:  # no row holds a delimiter: piece 0 is the row
            if k == 0:
                return c
            return _finish(c.chars, c.lengths,
                           torch.zeros_like(c.validity))
        reals = _greedy_matches(_match_starts(c, db), db)
        occ = torch.cumsum(reals.to(torch.int32), dim=1)
        pos = _positions(c.width, c.chars.device).to(torch.int64)
        if k == 0:
            start = torch.zeros(len(c), dtype=torch.int64,
                                device=c.chars.device)
        else:
            start = torch.where(reals & (occ == k), pos + m, -1) \
                .max(dim=1).values
        end = torch.where(reals & (occ == k + 1), pos, 2 ** 30) \
            .min(dim=1).values
        end = torch.minimum(end, c.lengths.to(torch.int64))
        in_range = (occ[:, -1] >= k) & (start >= 0)
        start = start.clamp(min=0)
        new_len = (end - start).clamp(min=0)
        chars = torch.gather(c.chars, 1,
                             (pos + start[:, None]).clamp(max=c.width - 1))
        keep = pos < new_len[:, None]
        return _finish(chars * keep.to(torch.uint8), new_len,
                       c.validity & in_range)


@dataclasses.dataclass(repr=False)
class GetJsonObject(Expression):
    """get_json_object(json, path) with a literal path: evaluated on the
    CPU engine only (``check_supported`` always raises), as in the JAX
    package.  Path grammar: ``$`` root, ``.field`` / ``['field']``
    access, ``[n]`` array index."""

    child: Expression
    path: Expression  # literal string

    @property
    def dtype(self) -> T.DataType:
        return T.STRING

    @property
    def name(self) -> str:
        return f"get_json_object({self.child.name}, {self.path.name})"

    def check_supported(self) -> None:
        if not isinstance(self.path, Literal) or not self.path.value:
            raise TypeError("get_json_object path must be a literal")
        raise TypeError(
            "get_json_object evaluates JSON paths on the CPU engine "
            "(no device JSON kernel yet)")

    def eval(self, ctx: EvalContext):
        raise AssertionError("CPU-engine only")

    @staticmethod
    def parse_path(path: str):
        """'$.a.b[2]' -> ['a', 'b', 2]; None on malformed paths
        (Spark returns NULL for every row then)."""
        import re

        if not path.startswith("$"):
            return None
        steps = []
        rest = path[1:]
        token = re.compile(
            r"\.(\w+)|\[(\d+)\]|\['([^']*)'\]|\[\"([^\"]*)\"\]")
        pos = 0
        while pos < len(rest):
            m = token.match(rest, pos)
            if m is None:
                return None
            field, idx, q1, q2 = m.groups()
            if idx is not None:
                steps.append(int(idx))
            else:
                steps.append(field if field is not None
                             else (q1 if q1 is not None else q2))
            pos = m.end()
        return steps
