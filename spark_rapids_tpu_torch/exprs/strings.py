"""String expressions over the fixed-width byte matrix.

Counterpart of the part of ``spark_rapids_tpu/exprs/strings.py`` that
the SQL frontend maps: ``length``, ``upper`` / ``lower``, ``startswith``
/ ``endswith`` / ``contains``, ``LIKE``, ``substring``, ``trim`` /
``ltrim`` / ``rtrim`` and ``concat``.  A ``StringColumn`` is ``chars[N,
W]`` uint8 with ``lengths`` and ``validity``; every op here is a dense
program over that matrix, on the batch's device:

- character-indexed ops (length, substring) number the characters by a
  cumulative sum of UTF-8 start bytes (every byte that is not
  0b10xxxxxx);
- re-layout ops (substring, trim) move each kept byte to its place in
  the row with one scatter (its place is the count of kept bytes
  before it), and concat gathers each part's bytes at its offset;
- case mapping decodes UTF-8 to code points, maps them through a BMP
  table built once from Python's casing rules, and re-encodes them in
  place.  A code point whose mapped UTF-8 length differs ('ß' -> 'SS',
  'ı' -> 'I') maps to itself, as in the JAX package; 4-byte sequences
  and invalid bytes pass through unchanged.

Every output keeps the port's invariant: bytes past a row's length
are zero, and a NULL row is zeroed with length 0.  No output carries a
dictionary sidecar, so the coded group-by never reads an input's codes
for a computed string.

``Like`` takes the patterns the JAX ``Like.check_supported`` accepts
(``x``, ``x%``, ``%x``, ``%x%``, ``x%y``) and raises TypeError on the
others, as that check does; the planner then runs the node on the CPU
engine.  The rest of the JAX module (replace, pad, locate,
``substring_index``, initcap, ``concat_ws``, split) is not ported yet.
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
