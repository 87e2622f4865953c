"""String expressions over fixed-width padded byte matrices.

Port of ``spark_rapids_tpu/expressions/strings.py`` (reference:
stringFunctions.scala): char length and octet length, simple case mapping,
initcap, substring, concat, concat_ws, locate, trim, pad, repeat, replace,
translate, format_number, reverse, ascii, chr, levenshtein, soundex,
substring_index, hex, bin, conv, find_in_set, empty2null, str_to_map, and
the string predicates contains / startswith / endswith with a literal
pattern. A
string column is ``uint8[rows, max_len]`` plus int32 byte lengths, so every
expression is a rectangular torch program:

- per-row byte COMPACTION (substring, trim, translate, and the codepoint
  helpers) is a gather: the source of output byte j is the first position
  whose running count of kept bytes passes j (a row-wise searchsorted),
  where the JAX package scatters into a drop slot. A gather has one writer
  per output byte, so it is deterministic on CUDA;
- SEARCH (contains, startswith, endswith, locate, replace,
  substring_index) is the window-match matrix: on a CUDA tensor the
  hand-written kernel of ``kernels/string_search.py`` for every pattern of
  1 to ``max_len`` bytes, on a CPU tensor its plain version;
- UNSIGNED 64-bit math (hex, bin, conv, format_number of INT64_MIN) keeps
  the bits in int64, which torch computes on CUDA where uint64 has no
  arithmetic: arithmetic shifts masked to the bits read, an unsigned
  division that halves first, and digits of the negated magnitude.

Loops that the JAX package runs as ``lax.scan`` / ``fori_loop`` (the greedy
matches of replace, soundex's state, levenshtein's DP rows) are Python
loops of torch ops over byte positions, with no host read, so a fused stage
can capture them in a CUDA graph.

Unicode: lengths and substring positions count CODEPOINTS (UTF-8 lead
bytes), as Spark does. upper/lower map ASCII bytewise plus simple
(single-char, length-preserving) case tables for the 2-byte and 3-byte
UTF-8 ranges; ß -> SS, cross-width mappings and 4-byte scripts pass
through unchanged, which is why the planner's rule is ``incompat``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import types as T
from ..batch import DeviceColumn
from ..types import TypeKind
from ..kernels.string_search import window_match
from .base import (EvalContext, Expression, Literal, _device_row,
                   and_validity, lit_if_needed, numeric_column)


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def _is_lead(data: torch.Tensor) -> torch.Tensor:
    """True for UTF-8 lead bytes (not 10xxxxxx continuations)."""
    return (data & 0xC0) != 0x80


def _in_str(col: DeviceColumn) -> torch.Tensor:
    ml = col.data.shape[1]
    return torch.arange(ml, device=col.data.device)[None, :] \
        < col.lengths[:, None]


def _char_count(col: DeviceColumn) -> torch.Tensor:
    return (_is_lead(col.data) & _in_str(col)).sum(
        dim=1, dtype=torch.int32)


def _compact_index(keep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(source column of each output slot, kept count per row): output slot
    j of a row takes the row's (j+1)-th kept position. Slots past the
    count point at the last column and must be masked by the caller."""
    n, ml = keep.shape
    running = keep.to(torch.int32).cumsum(dim=1, dtype=torch.int32)
    want = (torch.arange(ml, dtype=torch.int32, device=keep.device) + 1
            ).expand(n, ml).contiguous()
    src = torch.searchsorted(running, want)
    return src.clamp_(max=ml - 1), running[:, -1]


def _compact_bytes(data: torch.Tensor, keep: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-pack kept bytes per row; returns (packed, new_lengths)."""
    n, ml = data.shape
    if ml == 0:
        return data, torch.zeros(n, dtype=torch.int32, device=data.device)
    src, counts = _compact_index(keep)
    packed = data.gather(1, src)
    live = torch.arange(ml, device=data.device)[None, :] < counts[:, None]
    return torch.where(live, packed, torch.zeros_like(packed)), counts


def _string_column(data, lengths, validity, max_len: int) -> DeviceColumn:
    """Zero bytes past each row's length and every byte of an invalid row
    (the canonical padding), lengths 0 on invalid rows."""
    mask = (torch.arange(data.shape[1], device=data.device)[None, :]
            < lengths[:, None]) & validity[:, None]
    data = torch.where(mask, data, torch.zeros((), dtype=data.dtype,
                                               device=data.device))
    lengths = torch.where(validity, lengths.to(torch.int32),
                          torch.zeros((), dtype=torch.int32,
                                      device=lengths.device))
    return DeviceColumn(data, validity, T.string(max_len), lengths)


def _widen(data: torch.Tensor, width: int) -> torch.Tensor:
    """The byte matrix zero-padded (or cut) to ``width`` columns."""
    ml = data.shape[1]
    if ml < width:
        return F.pad(data, (0, width - ml))
    return data[:, :width]


def _literal_bytes(e: Expression, what: str) -> bytes:
    if not isinstance(e, Literal):
        raise TypeError(f"{what} must be a literal")
    return str(e.value).encode("utf-8")


@functools.lru_cache(maxsize=256)
def _device_table(values: bytes, dtype: str,
                  device: torch.device) -> torch.Tensor:
    """A lookup table (the bytes of a numpy array of ``dtype``) on the
    device, copied there once per table and device: safe inside a CUDA
    graph capture."""
    return torch.from_numpy(np.frombuffer(values, dtype).copy()).to(device)


def _table(arr: np.ndarray, device) -> torch.Tensor:
    return _device_table(arr.tobytes(), arr.dtype.str, torch.device(device))


def _window_match(data: torch.Tensor, lengths: torch.Tensor,
                  pat: bytes) -> torch.Tensor:
    """match[row, s] = pattern equals data[row, s:s+k] (k = len(pat))."""
    n, ml = data.shape
    k = len(pat)
    if k == 0:
        return torch.arange(ml, device=data.device)[None, :] \
            <= lengths[:, None]
    if k > ml:
        return torch.zeros((n, ml), dtype=torch.bool, device=data.device)
    return window_match(data.contiguous(), lengths.contiguous(), pat)


def _first_true(m: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row (0 where none)."""
    return m.to(torch.uint8).argmax(dim=1)


# ---------------------------------------------------------------------------
# Length, OctetLength
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class Length(Expression):
    """char_length: CODEPOINTS, not bytes (Spark length)."""

    child: Expression

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return Length(c[0])

    @property
    def dtype(self):
        return T.INT32

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        return numeric_column(_char_count(c), c.validity, T.INT32)


@dataclass(frozen=True, eq=False)
class OctetLength(Expression):
    """octet_length / bit_length: BYTES, unlike char length."""

    child: Expression
    bits: bool = False

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return OctetLength(c[0], self.bits)

    @property
    def dtype(self):
        return T.INT32

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        v = c.lengths.to(torch.int32)
        if self.bits:
            v = v * 8
        return numeric_column(v, c.validity, T.INT32)


# ---------------------------------------------------------------------------
# Upper / Lower
# ---------------------------------------------------------------------------

def _case_tables():
    """Single-char case maps for the 2-byte UTF-8 range (U+0080-U+07FF:
    Latin-1 Supplement, Latin Extended, Greek, Cyrillic, ...): codepoint ->
    codepoint, identity where the mapping changes char count or leaves the
    2-byte range."""
    up = np.arange(0x800, dtype=np.int32)
    lo = np.arange(0x800, dtype=np.int32)
    for cp in range(0x80, 0x800):
        u = chr(cp).upper()
        if len(u) == 1 and 0x80 <= ord(u) < 0x800:
            up[cp] = ord(u)
        low = chr(cp).lower()
        if len(low) == 1 and 0x80 <= ord(low) < 0x800:
            lo[cp] = ord(low)
    return up, lo


_UPPER_2B, _LOWER_2B = _case_tables()


def _case_tables_3b():
    """Single-char case maps for the 3-byte UTF-8 range (U+0800-U+FFFF:
    Georgian, Cherokee, full-width Latin, Greek Extended, ...): identity
    where the mapping changes char count or leaves the 3-byte range."""
    up = np.arange(0x10000, dtype=np.int32)
    lo = np.arange(0x10000, dtype=np.int32)
    for cp in range(0x800, 0x10000):
        ch = chr(cp)
        u = ch.upper()
        if len(u) == 1 and 0x800 <= ord(u) < 0x10000:
            up[cp] = ord(u)
        low = ch.lower()
        if len(low) == 1 and 0x800 <= ord(low) < 0x10000:
            lo[cp] = ord(low)
    return up, lo


_UPPER_3B, _LOWER_3B = _case_tables_3b()


def _ahead(a: torch.Tensor, k: int) -> torch.Tensor:
    """``a`` shifted left by k columns (the byte at position +k)."""
    return torch.cat([a[:, k:], torch.zeros_like(a[:, :k])], dim=1)


def _behind(a: torch.Tensor, k: int) -> torch.Tensor:
    """``a`` shifted right by k columns (the value from position -k)."""
    return torch.cat([torch.zeros_like(a[:, :k]), a[:, :-k]], dim=1)


def _cont(b: torch.Tensor) -> torch.Tensor:
    return (b >= 0x80) & (b < 0xC0)


@dataclass(frozen=True, eq=False)
class Upper(Expression):
    """upper/lower: ASCII bytewise plus SIMPLE case mapping for every
    2-byte codepoint whose counterpart is also 2-byte and every 3-byte
    codepoint whose counterpart is also 3-byte. Length-changing mappings
    (ß -> SS), cross-width mappings and 4-byte scripts pass through."""

    child: Expression
    _upper = True

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return type(self)(c[0])

    @property
    def dtype(self):
        return self.child.dtype

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        d = c.data
        dev = d.device
        if self._upper:
            is_lo = (d >= ord("a")) & (d <= ord("z"))
            out = torch.where(is_lo, d - 32, d)
            table2, table3 = _UPPER_2B, _UPPER_3B
        else:
            is_up = (d >= ord("A")) & (d <= ord("Z"))
            out = torch.where(is_up, d + 32, d)
            table2, table3 = _LOWER_2B, _LOWER_3B
        table2 = _table(table2, dev)
        table3 = _table(table3, dev)
        di = d.to(torch.int32)
        nxt = _ahead(di, 1)
        n2 = _ahead(di, 2)
        # 2-byte sequences: lead 0xC2-0xDF followed by a continuation
        lead2 = (di >= 0xC2) & (di <= 0xDF) & _cont(nxt)
        cp = ((di & 0x1F) << 6) | (nxt & 0x3F)
        mapped = table2[cp.clamp(0, 0x7FF).long()]
        bytes2 = [(0xC0 | (mapped >> 6)).to(d.dtype),
                  (0x80 | (mapped & 0x3F)).to(d.dtype)]
        # 3-byte sequences: lead 0xE0-0xEF + two continuations
        lead3 = (di >= 0xE0) & (di <= 0xEF) & _cont(nxt) & _cont(n2)
        cp3 = ((di & 0x0F) << 12) | ((nxt & 0x3F) << 6) | (n2 & 0x3F)
        m3 = table3[cp3.clamp(0, 0xFFFF).long()]
        bytes3 = [(0xE0 | (m3 >> 12)).to(d.dtype),
                  (0x80 | ((m3 >> 6) & 0x3F)).to(d.dtype),
                  (0x80 | (m3 & 0x3F)).to(d.dtype)]
        # byte k of a sequence whose LEAD sat k columns back
        for lead, seq in ((lead2, bytes2), (lead3, bytes3)):
            out = torch.where(lead, seq[0], out)
            for k in range(1, len(seq)):
                out = torch.where(_behind(lead, k), _behind(seq[k], k), out)
        return DeviceColumn(out, c.validity, c.dtype, c.lengths)


class Lower(Upper):
    _upper = False


# ---------------------------------------------------------------------------
# Substring, Concat
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class Substring(Expression):
    """substring(str, pos, len): 1-based, negative pos counts from the end,
    pos=0 treated as 1 (Spark). Character-indexed."""

    child: Expression
    pos: Expression
    length: Optional[Expression] = None

    @property
    def children(self):
        return (self.child, self.pos) + (
            (self.length,) if self.length is not None else ())

    def with_children(self, c):
        return Substring(c[0], c[1], c[2] if len(c) > 2 else None)

    @property
    def dtype(self):
        return self.child.dtype

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        p = self.pos.eval(batch, ctx)
        parts = [c, p]
        if self.length is not None:
            ln = self.length.eval(batch, ctx)
            parts.append(ln)
            want = ln.data.to(torch.int32)
        else:
            want = torch.full((c.capacity,), 1 << 30, dtype=torch.int32,
                              device=c.data.device)
        validity = and_validity(parts)
        nchars = _char_count(c)
        pos = p.data.to(torch.int32)
        zero = torch.zeros_like(pos)
        start = torch.where(pos > 0, pos - 1,
                            torch.where(pos < 0, nchars + pos, zero))
        start = torch.maximum(start, torch.where(pos < 0, zero, start))
        start = torch.where((pos < 0) & (nchars + pos < 0), nchars, start)
        end = start + want.clamp(min=0)
        in_str = _in_str(c)
        lead = _is_lead(c.data) & in_str
        # char ordinal of each byte (0-based, continuation bytes inherit)
        char_ix = lead.to(torch.int32).cumsum(dim=1, dtype=torch.int32) - 1
        keep = in_str & (char_ix >= start[:, None]) & \
            (char_ix < end[:, None])
        data, lengths = _compact_bytes(c.data, keep)
        return _string_column(data, lengths, validity, self.dtype.max_len)


@dataclass(frozen=True, eq=False)
class Concat(Expression):
    """concat(s1, s2, ...): null if ANY input is null (Spark concat)."""

    exprs: Tuple[Expression, ...]

    @property
    def children(self):
        return self.exprs

    def with_children(self, c):
        return Concat(tuple(c))

    @property
    def dtype(self):
        total = sum(e.dtype.max_len for e in self.exprs)
        return T.string(max(total, 1))

    def eval(self, batch, ctx=EvalContext()):
        cols = [e.eval(batch, ctx) for e in self.exprs]
        validity = and_validity(cols)
        out_ml = self.dtype.max_len
        n = batch.capacity
        dev = batch.device
        j = torch.arange(out_ml, device=dev)[None, :]
        out = torch.zeros((n, out_ml), dtype=torch.uint8, device=dev)
        offset = torch.zeros(n, dtype=torch.int32, device=dev)
        for c in cols:
            # output byte j comes from this input's byte j - offset
            src = j - offset[:, None]
            here = (src >= 0) & (src < c.lengths[:, None])
            g = _widen(c.data, out_ml).gather(
                1, src.clamp(0, out_ml - 1).long())
            out = torch.where(here, g, out)
            offset = offset + c.lengths
        return _string_column(out, offset.clamp(max=out_ml), validity,
                              out_ml)


# ---------------------------------------------------------------------------
# Search: the predicates, locate
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class StringPredicate(Expression):
    """contains / startswith / endswith with a literal pattern (Spark's
    GpuContains takes literal right-hand sides too)."""

    child: Expression
    pattern: Expression        # must be a Literal string
    op: str = "contains"       # contains | startswith | endswith

    @property
    def children(self):
        return (self.child, self.pattern)

    def with_children(self, c):
        return StringPredicate(c[0], c[1], self.op)

    @property
    def dtype(self):
        return T.BOOLEAN

    def _pat(self) -> bytes:
        if not isinstance(self.pattern, Literal):
            raise TypeError("string predicate pattern must be a literal")
        return str(self.pattern.value).encode("utf-8")

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        p = self.pattern.eval(batch, ctx)
        validity = c.validity & p.validity
        pat = self._pat()
        k = len(pat)
        m = _window_match(c.data, c.lengths, pat)
        if self.op == "contains":
            r = m.any(dim=1) | (k == 0)
        elif self.op == "startswith":
            r = (m[:, 0] | (k == 0)) & (c.lengths >= k)
        elif self.op == "endswith":
            idx = (c.lengths - k).clamp(0, c.data.shape[1] - 1)
            r = (m.gather(1, idx[:, None].to(torch.int64))[:, 0]
                 | (k == 0)) & (c.lengths >= k)
        else:
            raise ValueError(f"unknown string predicate {self.op!r}")
        return numeric_column(r, validity, T.BOOLEAN)

    def __repr__(self):
        return f"{self.op}({self.child!r}, {self.pattern!r})"


@dataclass(frozen=True, eq=False)
class StringLocate(Expression):
    """instr/locate: 1-based position of first occurrence, 0 if absent."""

    child: Expression
    pattern: Expression

    @property
    def children(self):
        return (self.child, self.pattern)

    def with_children(self, c):
        return StringLocate(c[0], c[1])

    @property
    def dtype(self):
        return T.INT32

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        p = self.pattern.eval(batch, ctx)
        pat = _literal_bytes(self.pattern, "locate's pattern")
        m = _window_match(c.data, c.lengths, pat)
        first = _first_true(m)
        found = m.any(dim=1)
        # byte position -> char position (count leads up to it)
        char_before = _is_lead(c.data).to(torch.int32).cumsum(
            dim=1, dtype=torch.int32)
        pos = char_before.gather(1, first[:, None])[:, 0]
        r = torch.where(found, pos, torch.zeros_like(pos))
        if len(pat) == 0:
            r = torch.ones_like(r)
        return numeric_column(r, c.validity & p.validity, T.INT32)


# ---------------------------------------------------------------------------
# Trim, pad, repeat, replace
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class StringTrim(Expression):
    """trim/ltrim/rtrim of ASCII spaces (Spark default trim set)."""

    child: Expression
    side: str = "both"    # both | leading | trailing

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return StringTrim(c[0], self.side)

    @property
    def dtype(self):
        return self.child.dtype

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        ml = c.data.shape[1]
        in_str = _in_str(c)
        nonspace = in_str & (c.data != 32)
        any_ns = nonspace.any(dim=1)
        first_ns = _first_true(nonspace)
        last_ns = ml - 1 - _first_true(nonspace.flip(1))
        zero = torch.zeros_like(first_ns)
        lengths = c.lengths.long()
        lo = torch.where(any_ns, first_ns, zero) \
            if self.side != "trailing" else zero
        if self.side == "leading":
            hi = torch.where(any_ns, lengths, zero)
        else:
            hi = torch.where(any_ns, last_ns + 1, zero)
        j = torch.arange(ml, device=c.data.device)[None, :]
        keep = in_str & (j >= lo[:, None]) & (j < hi[:, None])
        data, lengths = _compact_bytes(c.data, keep)
        return _string_column(data, lengths, c.validity, self.dtype.max_len)


@dataclass(frozen=True, eq=False)
class StringPad(Expression):
    """lpad/rpad(str, len, pad): CHARACTER-counted (ASCII pad assumed)."""

    child: Expression
    target_len: Expression
    pad: Expression
    left: bool = True

    @property
    def children(self):
        return (self.child, self.target_len, self.pad)

    def with_children(self, c):
        return StringPad(c[0], c[1], c[2], self.left)

    @property
    def dtype(self):
        return T.string(max(self.child.dtype.max_len, 64))

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        tl = self.target_len.eval(batch, ctx)
        pd = self.pad.eval(batch, ctx)
        validity = and_validity([c, tl, pd])
        pad_bytes = _literal_bytes(self.pad, "the pad")
        out_ml = self.dtype.max_len
        n = batch.capacity
        dev = c.data.device
        want = tl.data.to(torch.int32).clamp(0, out_ml)
        cur = _char_count(c)  # == byte count for ASCII content
        deficit = (want - cur).clamp(min=0)
        if len(pad_bytes) == 0:
            deficit = torch.zeros_like(deficit)
        # truncation case: want < cur -> keep the first `want` chars
        in_str = _in_str(c)
        lead = _is_lead(c.data) & in_str
        char_ix = lead.to(torch.int32).cumsum(dim=1, dtype=torch.int32) - 1
        keep = in_str & (char_ix < want[:, None])
        body, body_len = _compact_bytes(c.data, keep)
        reps = -(-out_ml // max(len(pad_bytes), 1))
        pad_row = _device_row((pad_bytes * reps)[:out_ml], out_ml, dev)
        total = (body_len + deficit).clamp(max=out_ml)
        j = torch.arange(out_ml, device=dev)[None, :]
        wide_body = _widen(body, out_ml)
        pad_mat = pad_row.expand(n, out_ml)
        if self.left:
            # pad occupies [0, deficit), the body shifts right
            from_body = j >= deficit[:, None]
            body_g = wide_body.gather(
                1, (j - deficit[:, None]).clamp(0, out_ml - 1).long())
            out = torch.where(from_body, body_g, pad_mat)
        else:
            in_body = j < body_len[:, None]
            pad_g = pad_mat.gather(
                1, (j - body_len[:, None]).clamp(0, out_ml - 1).long())
            out = torch.where(in_body, wide_body, pad_g)
        return _string_column(out, total, validity, out_ml)


@dataclass(frozen=True, eq=False)
class StringRepeat(Expression):
    child: Expression
    times: Expression

    @property
    def children(self):
        return (self.child, self.times)

    def with_children(self, c):
        return StringRepeat(c[0], c[1])

    @property
    def dtype(self):
        return T.string(max(self.child.dtype.max_len * 4, 64))

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        t = self.times.eval(batch, ctx)
        validity = c.validity & t.validity
        out_ml = self.dtype.max_len
        reps = t.data.to(torch.int32).clamp(0, out_ml)
        total = (c.lengths * reps).clamp(max=out_ml)
        j = torch.arange(out_ml, device=c.data.device)[None, :]
        src = j % c.lengths.clamp(min=1)[:, None]
        g = _widen(c.data, out_ml).gather(1, src.clamp(0, out_ml - 1).long())
        out = torch.where(j < total[:, None], g, torch.zeros_like(g))
        return _string_column(out, total, validity, out_ml)


@dataclass(frozen=True, eq=False)
class StringReplace(Expression):
    """replace(str, search, replace) with LITERAL search/replace
    (reference: GpuStringReplace has the same literal restriction). The
    output is ``string(max(2 * max_len, 64))`` and a longer result is cut
    at that width, as in the JAX package."""

    child: Expression
    search: Expression
    replacement: Expression

    @property
    def children(self):
        return (self.child, self.search, self.replacement)

    def with_children(self, c):
        return StringReplace(c[0], c[1], c[2])

    @property
    def dtype(self):
        return T.string(max(self.child.dtype.max_len * 2, 64))

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        pat = _literal_bytes(self.search, "replace's search")
        rep = _literal_bytes(self.replacement, "replace's replacement")
        out_ml = self.dtype.max_len
        n, ml = c.data.shape
        dev = c.data.device
        if len(pat) == 0:
            return _string_column(_widen(c.data, out_ml),
                                  c.lengths.clamp(max=out_ml),
                                  c.validity, out_ml)
        m = _window_match(c.data, c.lengths, pat)
        k = len(pat)
        # greedy left-to-right non-overlapping matches: a match at s is
        # real iff no real match before it covers s (the JAX lax.scan)
        blocked = torch.zeros(n, dtype=torch.int32, device=dev)
        reals = []
        for s in range(ml):
            real_s = m[:, s] & (blocked <= s)
            blocked = torch.where(real_s, torch.full_like(blocked, s + k),
                                  blocked)
            reals.append(real_s)
        real = torch.stack(reals, dim=1) if reals else m
        ri = real.to(torch.int32)
        # bytes covered by a real match (its start included)
        cover = ri.cumsum(dim=1, dtype=torch.int32) - \
            F.pad(ri, (k, 0))[:, :ml].cumsum(dim=1, dtype=torch.int32)
        inside = cover > 0
        in_str = _in_str(c)
        emit_copy = in_str & ~inside
        # each input byte emits itself, or (a real start) the replacement
        unit = emit_copy.to(torch.int32) + ri * len(rep)
        upto = unit.cumsum(dim=1, dtype=torch.int32)
        offs = upto - unit
        total = upto[:, -1] if ml else torch.zeros(n, dtype=torch.int32,
                                                   device=dev)
        out_len = total.clamp(max=out_ml)
        # output byte t comes from the first input byte whose emitted run
        # passes t: itself, or byte t - offs of the replacement
        t = torch.arange(out_ml, device=dev).to(torch.int32)[None, :] \
            .expand(n, out_ml).contiguous()
        src = torch.searchsorted(upto, t, right=True).clamp(max=ml - 1)
        from_rep = real.gather(1, src)
        copied = c.data.gather(1, src)
        rep_row = _device_row(rep, max(len(rep), 1), dev)
        rep_ix = (t - offs.gather(1, src)).clamp(0, max(len(rep) - 1, 0))
        rep_byte = rep_row[rep_ix.long()]
        out = torch.where(from_rep, rep_byte, copied)
        return _string_column(out, out_len, c.validity, out_ml)


# ---------------------------------------------------------------------------
# Translate
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class Translate(Expression):
    """translate(str, from, to): per-byte substitution through one
    256-entry lookup table built at bind time; bytes mapped to "delete"
    (from chars beyond len(to)) are compacted out. ASCII from/to only: a
    non-ASCII mapping needs char-level re-encoding, so the planner sends it
    to the CPU."""

    child: Expression = None
    from_str: str = ""
    to_str: str = ""

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return Translate(c[0], self.from_str, self.to_str)

    @property
    def dtype(self):
        return self.child.dtype

    def device_unsupported_reason(self):
        try:
            self.from_str.encode("ascii")
            self.to_str.encode("ascii")
        except UnicodeEncodeError:
            return "translate: non-ASCII mapping needs char re-encoding"
        return None

    def _tables(self):
        table = np.arange(256, dtype=np.uint8)
        delete = np.zeros(256, bool)
        seen = set()
        for i, ch in enumerate(self.from_str):
            b = ord(ch)
            if b in seen:       # Spark: the first occurrence wins
                continue
            seen.add(b)
            if i < len(self.to_str):
                table[b] = ord(self.to_str[i])
            else:
                delete[b] = True
        return table, delete

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        dev = c.data.device
        table, delete = self._tables()
        ix = c.data.long()
        mapped = _table(table, dev)[ix]
        keep = _in_str(c) & ~_table(delete, dev)[ix]
        out, lengths = _compact_bytes(mapped, keep)
        return _string_column(out, lengths, c.validity, c.dtype.max_len)


@dataclass(frozen=True, eq=False)
class InitCap(Expression):
    """initcap(str): first letter of each space-separated word upper, the
    rest lower. ASCII case mapping (the Upper/Lower policy)."""

    child: Expression = None

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return InitCap(c[0])

    @property
    def dtype(self):
        return self.child.dtype

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        d = c.data
        is_up = (d >= ord("A")) & (d <= ord("Z"))
        lowered = torch.where(is_up, d + 32, d)
        # a word starts at position 0 or after a space
        prev_space = torch.cat(
            [torch.ones_like(d[:, :1], dtype=torch.bool),
             d[:, :-1] == ord(" ")], dim=1)
        is_lo = (lowered >= ord("a")) & (lowered <= ord("z"))
        out = torch.where(prev_space & is_lo, lowered - 32, lowered)
        return DeviceColumn(out, c.validity, c.dtype, c.lengths)


@dataclass(frozen=True, eq=False)
class FormatNumber(Expression):
    """format_number(x, d): fixed decimals and thousands separators, over
    an integral or decimal ``x`` (a float falls back: exact HALF_UP on its
    decimal expansion needs arbitrary precision). Integer math on the
    device: a decimal rounds HALF_EVEN to d places, the digits come most
    significant first, a ',' every 3 integer digits. The integer part's
    digits are those of its NEGATED magnitude (truncating division), so
    |INT64_MIN| needs no unsigned type."""

    child: Expression = None
    decimals: int = 2

    _MAX_DIGITS = 19     # int64 decimal digits

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return FormatNumber(c[0], self.decimals)

    @property
    def _d(self) -> int:
        """d, given as an int or an integer literal."""
        d = self.decimals
        return int(d.value) if isinstance(d, Literal) else d

    @property
    def dtype(self):
        # digits + separators + sign + point + decimals
        n = self._MAX_DIGITS
        return T.string(n + (n - 1) // 3 + 2 + max(self._d, 0))

    def device_unsupported_reason(self):
        if self._d < 0:
            return "format_number: negative d"
        if self._d > 9:
            return "format_number: d > 9 overflows the int64 scaling"
        if self.child.resolved and \
                self.child.dtype.kind in (TypeKind.FLOAT32,
                                          TypeKind.FLOAT64):
            return ("format_number over floats: exact HALF_UP on the "
                    "decimal expansion needs arbitrary precision")
        return None

    def _parts(self, x: torch.Tensor):
        """(integer part negated, fraction scaled to d digits), without
        scaling the whole value up: x * 10**d overflows int64."""
        d = self._d
        v = x.to(torch.int64)
        if self.child.dtype.kind is not TypeKind.DECIMAL:
            # integral kinds: the fraction is exactly zero
            return torch.where(v < 0, v, -v), torch.zeros_like(v)
        scale = self.child.dtype.scale
        if scale > d:
            # rescale to d decimals, HALF_EVEN (DecimalFormat's default);
            # floor division keeps r in [0, div)
            div = 10 ** (scale - d)
            q = torch.div(v, div, rounding_mode="floor")
            r = v - q * div
            up = (2 * r > div) | ((2 * r == div) & (q % 2 != 0))
            mag = (q + up.to(torch.int64)).abs()
            return -(mag // 10 ** d), mag % 10 ** d
        mag = v.abs()
        return -(mag // 10 ** scale), (mag % 10 ** scale) * 10 ** (d - scale)

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        d = self._d
        nd = self._MAX_DIGITS
        out_ml = self.dtype.max_len
        dev = c.data.device
        neg_int, frac = self._parts(c.data)
        neg = c.data < 0     # the input's sign: -0.004 formats "-0.00"
        # the integer digits, least significant first: digit k of the
        # negated value is -(v / 10^k truncated, mod 10)
        digits = torch.stack(
            [-torch.fmod(torch.div(neg_int, 10 ** k, rounding_mode="trunc"),
                         10) for k in range(nd)], dim=1)          # [n, nd]
        nz = digits > 0
        n_int = torch.where(nz.any(dim=1),
                            nd - _first_true(nz.flip(1)), 1)
        n_commas = (n_int - 1) // 3
        int_len = n_int + n_commas
        sign = neg.to(torch.int64)
        total = sign + int_len + (1 + d if d > 0 else 0)
        # output byte t: '-', then the integer part (from its right end, a
        # ',' after every third digit), then '.' and the fraction
        t = torch.arange(out_ml, device=dev)[None, :]
        u = t - sign[:, None]
        r = int_len[:, None] - 1 - u           # place from the right
        dig = digits.gather(1, (r - r // 4).clamp(0, nd - 1))
        out = torch.where(r % 4 == 3, ord(","), dig + ord("0"))
        if d > 0:
            f = u - int_len[:, None] - 1        # fraction digit index
            fdig = torch.stack([(frac // 10 ** (d - 1 - i)) % 10
                                for i in range(d)], dim=1)
            fch = fdig.gather(1, f.clamp(0, d - 1)) + ord("0")
            out = torch.where(f >= 0, fch, torch.where(f == -1, ord("."),
                                                       out))
        out = torch.where(u < 0, ord("-"), out)
        return _string_column(out.to(torch.uint8), total.to(torch.int32),
                              c.validity, out_ml)


# ---------------------------------------------------------------------------
# Codepoint decode / encode (UTF-8 bytes <-> int32 codepoint matrices)
# ---------------------------------------------------------------------------

def _decode_cp(b0, b1, b2, b3):
    """UTF-8 unit bytes (int32) -> codepoint (every decode site's)."""
    return torch.where(
        b0 < 0x80, b0,
        torch.where(b0 < 0xE0, ((b0 & 0x1F) << 6) | (b1 & 0x3F),
                    torch.where(b0 < 0xF0,
                                ((b0 & 0x0F) << 12) | ((b1 & 0x3F) << 6)
                                | (b2 & 0x3F),
                                ((b0 & 0x07) << 18) | ((b1 & 0x3F) << 12)
                                | ((b2 & 0x3F) << 6) | (b3 & 0x3F))))


def _codepoints(col: DeviceColumn) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codepoints [n, ml] int32 left-packed, char counts [n]). Slots past
    a row's character count are 0."""
    n, ml = col.data.shape
    dev = col.data.device
    lead = _is_lead(col.data) & _in_str(col)
    starts, nchars = _compact_index(lead)       # each char's first byte

    def byte_at(off):
        at = starts + off
        b = col.data.gather(1, at.clamp(0, ml - 1)).to(torch.int32)
        return torch.where(at < col.lengths[:, None], b,
                           torch.zeros_like(b))

    cp = _decode_cp(byte_at(0), byte_at(1), byte_at(2), byte_at(3))
    live = torch.arange(ml, device=dev)[None, :] < nchars[:, None]
    return torch.where(live, cp, torch.zeros_like(cp)), nchars


def _encode_utf8(cps: torch.Tensor, counts: torch.Tensor, out_ml: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode left-packed codepoints back to a padded UTF-8 byte matrix;
    returns (bytes [n, out_ml], byte lengths [n])."""
    n, ml = cps.shape
    dev = cps.device
    live = torch.arange(ml, device=dev)[None, :] < counts[:, None]
    one = torch.ones_like(cps)
    ulen = torch.where(cps < 0x80, one,
                       torch.where(cps < 0x800, one * 2,
                                   torch.where(cps < 0x10000, one * 3,
                                               one * 4)))
    ulen = torch.where(live, ulen, torch.zeros_like(ulen))
    upto = ulen.cumsum(dim=1, dtype=torch.int32)
    offs = upto - ulen                           # exclusive prefix
    lengths = upto[:, -1]
    # output byte t belongs to the char whose run of bytes passes t
    t = torch.arange(out_ml, device=dev).to(torch.int32)[None, :] \
        .expand(n, out_ml).contiguous()
    ch = torch.searchsorted(upto, t, right=True).clamp(max=ml - 1)
    cp = cps.gather(1, ch)
    k = t - offs.gather(1, ch)
    u = ulen.gather(1, ch)
    cont = 0x80 | ((cp >> (6 * (u - 1 - k).clamp(min=0))) & 0x3F)
    lead_mark = torch.where(u == 2, one[:, :1] * 0xC0,
                            torch.where(u == 3, one[:, :1] * 0xE0,
                                        one[:, :1] * 0xF0))
    lead = torch.where(u == 1, cp, lead_mark | (cp >> (6 * (u - 1))))
    out = torch.where(k == 0, lead, cont).to(torch.uint8)
    return out, lengths


@dataclass(frozen=True, eq=False)
class Reverse(Expression):
    """reverse(str): CODEPOINT order reversed (Spark reverse)."""

    child: Expression

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return Reverse(c[0])

    @property
    def dtype(self):
        return self.child.dtype

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        ml = c.data.shape[1]
        cps, nchars = _codepoints(c)
        pos = torch.arange(ml, device=c.data.device)[None, :]
        src = (nchars[:, None] - 1 - pos).clamp(0, ml - 1)
        rev = torch.where(pos < nchars[:, None], cps.gather(1, src),
                          torch.zeros_like(cps))
        data, lengths = _encode_utf8(rev, nchars, ml)
        return _string_column(data, lengths, c.validity, c.dtype.max_len)


@dataclass(frozen=True, eq=False)
class Ascii(Expression):
    """ascii(str): codepoint of the first character; 0 for empty."""

    child: Expression

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return Ascii(c[0])

    @property
    def dtype(self):
        return T.INT32

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        # the first character starts at byte 0: decode its (up to 4) bytes
        ml = c.data.shape[1]
        zero = torch.zeros(c.capacity, dtype=torch.int32,
                           device=c.data.device)

        def byte_at(k):
            if k >= ml:
                return zero
            return torch.where(k < c.lengths, c.data[:, k].to(torch.int32),
                               zero)

        cp = _decode_cp(byte_at(0), byte_at(1), byte_at(2), byte_at(3))
        # Spark's Ascii is charAt(0): the first UTF-16 CODE UNIT, the high
        # surrogate for a supplementary-plane character
        cp = torch.where(cp > 0xFFFF, 0xD800 + ((cp - 0x10000) >> 10), cp)
        first = torch.where(c.lengths > 0, cp, zero)
        return numeric_column(first, c.validity, T.INT32)


@dataclass(frozen=True, eq=False)
class Chr(Expression):
    """chr(n): character with codepoint n % 256; negative n -> empty
    (Spark chr semantics; 128-255 encode as two UTF-8 bytes)."""

    child: Expression

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return Chr(c[0])

    @property
    def dtype(self):
        return T.string(2)

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        v = c.data.to(torch.int64)
        cp = torch.where(v < 0, torch.full_like(v, -1),
                         torch.remainder(v, 256)).to(torch.int32)
        counts = (cp >= 0).to(torch.int32)
        data, lengths = _encode_utf8(cp.clamp(min=0)[:, None], counts, 2)
        return _string_column(data, lengths, c.validity, 2)


# ---------------------------------------------------------------------------
# Levenshtein, Soundex
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class Levenshtein(Expression):
    """levenshtein(a, b): edit distance over CODEPOINTS.

    One loop step per DP row; the insertion chain inside a row, normally a
    sequential scan over j, is a prefix-min of (cand[j] - j) (min-plus
    algebra): ``torch.cummin``."""

    left: Expression
    right: Expression

    @property
    def children(self):
        return (self.left, self.right)

    def with_children(self, c):
        return Levenshtein(c[0], c[1])

    @property
    def dtype(self):
        return T.INT32

    def eval(self, batch, ctx=EvalContext()):
        a = self.left.eval(batch, ctx)
        b = self.right.eval(batch, ctx)
        cpa, la = _codepoints(a)
        cpb, lb = _codepoints(b)
        n, mla = cpa.shape
        mlb = cpb.shape[1]
        dev = cpa.device
        jpos = torch.arange(mlb + 1, device=dev).to(torch.int32)[None, :]
        row = jpos.expand(n, mlb + 1)
        ans = row               # rows with la == 0
        for i in range(mla):
            cost = (cpb != cpa[:, i:i + 1]).to(torch.int32)
            delete = row[:, 1:] + 1
            sub = row[:, :-1] + cost
            cand = torch.cat([torch.full((n, 1), i + 1, dtype=torch.int32,
                                         device=dev),
                              torch.minimum(delete, sub)], dim=1)
            # insertion chain new[j] = min_k<=j cand[k] + (j - k)
            row = torch.cummin(cand - jpos, dim=1).values + jpos
            ans = torch.where((la == i + 1)[:, None], row, ans)
        out = ans.gather(1, lb.clamp(0, mlb)[:, None].long())[:, 0]
        return numeric_column(out, a.validity & b.validity, T.INT32)


_SOUNDEX_CODE = np.zeros(128, np.int32)
for _letters, _code in (("BFPV", 1), ("CGJKQSXZ", 2), ("DT", 3), ("L", 4),
                        ("MN", 5), ("R", 6), ("HW", 7)):
    for _ch in _letters:
        _SOUNDEX_CODE[ord(_ch)] = _code


@dataclass(frozen=True, eq=False)
class Soundex(Expression):
    """soundex(str): first letter + 3 digits (Spark's UTF8String.soundex:
    H/W do not separate duplicate codes, vowels and non-letters do; a
    non-letter first character returns the input unchanged)."""

    child: Expression

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return Soundex(c[0])

    @property
    def dtype(self):
        return T.string(max(self.child.dtype.max_len, 4))

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        n, ml = c.data.shape
        dev = c.data.device
        in_str = _in_str(c)
        d = c.data.to(torch.int32)
        up = torch.where((d >= ord("a")) & (d <= ord("z")), d - 32, d)
        is_letter = (up >= ord("A")) & (up <= ord("Z")) & in_str
        table = _table(_SOUNDEX_CODE, dev)
        codes = torch.where(is_letter, table[up.clamp(0, 127).long()],
                            torch.full_like(up, -1))
        first = up[:, 0]
        first_is_letter = is_letter[:, 0]
        none = torch.full((n,), -1, dtype=torch.int32, device=dev)
        emitted = torch.zeros(n, dtype=torch.int32, device=dev)
        last = torch.where(first_is_letter, codes[:, 0], none)
        digits = torch.zeros((n, 3), dtype=torch.int32, device=dev)
        for i in range(1, ml):
            code = codes[:, i]
            is_l = is_letter[:, i]
            digit = is_l & (code >= 1) & (code <= 6)
            emit = digit & (code != last) & (emitted < 3)
            slot = emitted.clamp(0, 2)[:, None].long()
            digits = digits.scatter(
                1, slot, torch.where(emit, code,
                                     digits.gather(1, slot)[:, 0])[:, None])
            emitted = emitted + emit.to(torch.int32)
            # vowels and non-letters inside the string reset the duplicate
            # tracker; H/W (7) keep it; consonants set it
            reset = (is_l & (code == 0)) | (in_str[:, i] & ~is_l)
            last = torch.where(digit, code, torch.where(reset, none, last))
        out_ml = self.dtype.max_len
        k = torch.arange(3, device=dev)[None, :]
        shown = torch.where(k < emitted[:, None], digits,
                            torch.zeros_like(digits)) + ord("0")
        sx = torch.cat([first[:, None], shown], dim=1).to(torch.uint8)
        sx = _widen(sx, out_ml)
        # a non-letter first char: the input passes through unchanged
        orig = _widen(c.data, out_ml)
        data = torch.where(first_is_letter[:, None], sx, orig)
        lengths = torch.where(first_is_letter, torch.full_like(c.lengths, 4),
                              c.lengths)
        return _string_column(data, lengths, c.validity, out_ml)


# ---------------------------------------------------------------------------
# ConcatWs
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class ConcatWs(Expression):
    """concat_ws(sep, s1, s2, ...): skips NULL inputs (unlike concat);
    null only when the separator is null. Literal separator (reference:
    GpuOverrides' concat_ws rule). Output byte j comes from the input or
    separator whose run of bytes covers j, a gather as in ``Concat``."""

    sep: Expression
    exprs: Tuple[Expression, ...]

    @property
    def children(self):
        return (self.sep,) + self.exprs

    def with_children(self, c):
        return ConcatWs(c[0], tuple(c[1:]))

    @property
    def nullable(self):
        return self.sep.nullable

    def device_unsupported_reason(self):
        if not isinstance(self.sep, Literal):
            return "concat_ws separator must be a literal"
        return None

    def _sep(self) -> Optional[bytes]:
        if not isinstance(self.sep, Literal):
            raise TypeError("concat_ws separator must be a literal")
        if self.sep.value is None:
            return None          # a null separator: an all-null result
        return str(self.sep.value).encode("utf-8")

    @property
    def dtype(self):
        total = sum(e.dtype.max_len for e in self.exprs)
        if isinstance(self.sep, Literal):
            sep_len = len(self._sep() or b"")
        else:
            sep_len = self.sep.dtype.max_len   # the planner needs a type
        total += sep_len * max(len(self.exprs) - 1, 0)
        return T.string(max(total, 1))

    def eval(self, batch, ctx=EvalContext()):
        sep = self._sep()
        out_ml = self.dtype.max_len
        n = batch.capacity
        dev = batch.device
        out = torch.zeros((n, out_ml), dtype=torch.uint8, device=dev)
        if sep is None:
            return _string_column(out, torch.zeros(n, dtype=torch.int32,
                                                   device=dev),
                                  torch.zeros(n, dtype=torch.bool,
                                              device=dev), out_ml)
        j = torch.arange(out_ml, device=dev)[None, :]
        offset = torch.zeros(n, dtype=torch.int32, device=dev)
        seen = torch.zeros(n, dtype=torch.bool, device=dev)  # a value is out
        sep_row = _device_row(sep, len(sep), dev) if sep else None
        for e in self.exprs:
            c = e.eval(batch, ctx)
            if sep_row is not None:
                # the separator before this value when something precedes
                put_sep = seen & c.validity
                src = j - offset[:, None]
                here = put_sep[:, None] & (src >= 0) & (src < len(sep))
                g = sep_row[src.clamp(0, len(sep) - 1)]
                out = torch.where(here, g, out)
                offset = offset + put_sep.to(torch.int32) * len(sep)
            lengths = torch.where(c.validity, c.lengths,
                                  torch.zeros_like(c.lengths))
            src = j - offset[:, None]
            here = (src >= 0) & (src < lengths[:, None])
            g = _widen(c.data, out_ml).gather(
                1, src.clamp(0, out_ml - 1).long())
            out = torch.where(here, g, out)
            offset = offset + lengths
            seen = seen | c.validity
        return _string_column(out, offset.clamp(max=out_ml),
                              batch.row_mask(), out_ml)


# ---------------------------------------------------------------------------
# SubstringIndex
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class SubstringIndex(Expression):
    """substring_index(str, delim, count): prefix before the count-th
    delimiter (count < 0: the suffix after the |count|-th from the right).
    Literal delimiter and count (reference: GpuSubstringIndex, the same
    restriction). Occurrences are the window matches, so a delimiter that
    overlaps itself ('aa' in 'aaa') counts each start, as in the JAX
    package (ROADMAP Queue 3 records it against Spark)."""

    child: Expression
    delim: Expression
    count: Expression

    @property
    def children(self):
        return (self.child, self.delim, self.count)

    def with_children(self, c):
        return SubstringIndex(c[0], c[1], c[2])

    @property
    def dtype(self):
        return self.child.dtype

    def device_unsupported_reason(self):
        if not (isinstance(self.delim, Literal)
                and isinstance(self.count, Literal)):
            return "substring_index delimiter/count must be literals"
        return None

    def _parts(self):
        if not (isinstance(self.delim, Literal)
                and isinstance(self.count, Literal)):
            raise TypeError("substring_index delimiter/count must be "
                            "literals")
        return str(self.delim.value).encode("utf-8"), int(self.count.value)

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        delim, cnt = self._parts()
        ml = c.data.shape[1]
        if cnt == 0 or not delim:
            return _string_column(torch.zeros_like(c.data),
                                  torch.zeros_like(c.lengths), c.validity,
                                  ml)
        m = _window_match(c.data, c.lengths, delim)
        occ = m.to(torch.int32).cumsum(dim=1, dtype=torch.int32)
        total = occ[:, -1]
        k = len(delim)
        idx = torch.arange(ml, device=c.data.device)[None, :]
        if cnt > 0:
            # end = start of the cnt-th occurrence (whole string if fewer)
            hit = m & (occ == cnt)
            pos = torch.where(hit.any(dim=1),
                              _first_true(hit).to(torch.int32), c.lengths)
            data = torch.where(idx < pos[:, None], c.data,
                               torch.zeros_like(c.data))
            return _string_column(data, pos, c.validity, ml)
        # negative: start after the (total + cnt + 1)-th occurrence's end
        want = total + cnt
        hit = m & (occ == want.clamp(min=0)[:, None] + 1)
        has = (want >= 0) & hit.any(dim=1)
        start = torch.where(has, _first_true(hit).to(torch.int32) + k,
                            torch.zeros_like(want))
        new_len = (c.lengths - start).clamp(min=0)
        # shift left by start (a per-row roll as a gather)
        data = c.data.gather(1, (idx + start[:, None]).clamp(0, ml - 1))
        data = torch.where(idx < new_len[:, None], data,
                           torch.zeros_like(data))
        return _string_column(data, new_len, c.validity, ml)


# ---------------------------------------------------------------------------
# Hex, Bin, Conv
# ---------------------------------------------------------------------------

#: the digit characters of bases up to 36
_DIGITS = np.frombuffer(b"0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ", np.uint8)


def _digit_string(mat: torch.Tensor, width: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bytes [n, width], lengths): the digit matrix ``mat`` (most
    significant first, values < 36) as characters with its leading zeros
    dropped; a zero value keeps one '0'."""
    nz = mat != 0
    first = torch.where(nz.any(dim=1), _first_true(nz),
                        torch.full_like(nz[:, 0], mat.shape[1] - 1,
                                        dtype=torch.int64))
    chars = _table(_DIGITS, mat.device)[mat.long()]
    pos = torch.arange(width, device=mat.device)[None, :]
    shifted = F.pad(chars, (0, width - mat.shape[1] + 1)).gather(
        1, (pos + first[:, None]).clamp(max=width))
    length = (mat.shape[1] - first).to(torch.int32)
    return torch.where(pos < length[:, None], shifted,
                       torch.zeros_like(shifted)), length


@dataclass(frozen=True, eq=False)
class Hex(Expression):
    """hex(bigint) / hex(string): uppercase hex, no leading zeros for
    numbers (two's complement for negatives), two digits a byte for
    strings. A number's nibbles come from arithmetic shifts of its int64
    bits (the low four bits of ``v >> 4k`` are nibble k either way)."""

    child: Expression

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return Hex(c[0])

    @property
    def dtype(self):
        if self.child.dtype.kind is TypeKind.STRING:
            return T.string(max(self.child.dtype.max_len * 2, 1))
        return T.string(16)

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        if self.child.dtype.kind is TypeKind.STRING:
            n, ml = c.data.shape
            digits = _table(_DIGITS, c.data.device)
            hi = digits[(c.data >> 4).long()]
            lo = digits[(c.data & 15).long()]
            out = torch.stack([hi, lo], dim=2).reshape(n, 2 * ml)
            return _string_column(out, c.lengths * 2, c.validity, 2 * ml)
        v = c.data.to(torch.int64)
        mat = torch.stack([(v >> (4 * (15 - d))) & 15 for d in range(16)],
                          dim=1)
        out, length = _digit_string(mat, 16)
        return _string_column(out, length, c.validity, 16)


@dataclass(frozen=True, eq=False)
class Bin(Expression):
    """bin(bigint): binary string, no leading zeros (two's complement)."""

    child: Expression

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return Bin(c[0])

    @property
    def dtype(self):
        return T.string(64)

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        v = c.data.to(torch.int64)
        mat = torch.stack([(v >> (63 - d)) & 1 for d in range(64)], dim=1)
        out, length = _digit_string(mat, 64)
        return _string_column(out, length, c.validity, 64)


def _unsigned_digits(v: torch.Tensor, base: int) -> torch.Tensor:
    """The 64 base-``base`` digits of the UNSIGNED value of the int64 bits
    ``v`` (torch has no uint64 arithmetic on CUDA), most significant
    first. The first division halves: with v = 2h + l (h = v >>> 1, which
    is non-negative), v // b = 2 (h // b) + carry, and every later
    quotient is a non-negative int64."""
    h = (v >> 1) & ((1 << 63) - 1)
    q1 = h // base
    r2 = 2 * (h - q1 * base) + (v & 1)
    carry = (r2 >= base).to(torch.int64)
    q = 2 * q1 + carry                       # v // b, below 2^63
    # digit k + 1 of v is digit k of q; a power past 2^63 leaves a 0
    powers = [base ** k for k in range(63)]
    fits = _table(np.array([p < 1 << 63 for p in powers]), v.device)
    p = _table(np.array([p if p < 1 << 63 else 1 for p in powers],
                        np.int64), v.device)
    upper = torch.where(fits, (q[:, None] // p) % base,
                        torch.zeros((), dtype=torch.int64, device=v.device))
    return torch.cat([upper.flip(1), (r2 - carry * base)[:, None]], dim=1)


@dataclass(frozen=True, eq=False)
class Conv(Expression):
    """conv(numstr, from_base, to_base): base conversion with LITERAL
    bases 2..36 (reference: GpuConv, the same literal restriction). Parses
    the longest valid prefix (an empty or invalid one gives "0") with no
    trimming; a negative input wraps as unsigned 64-bit when to_base > 0.
    The accumulation ``v * from_base + digit`` wraps mod 2^64 in int64, as
    the JAX package's uint64 does (Spark saturates instead)."""

    child: Expression
    from_base: Expression
    to_base: Expression

    @property
    def children(self):
        return (self.child, self.from_base, self.to_base)

    def with_children(self, c):
        return Conv(c[0], c[1], c[2])

    @property
    def dtype(self):
        return T.string(65)

    def device_unsupported_reason(self):
        if not (isinstance(self.from_base, Literal)
                and isinstance(self.to_base, Literal)):
            return "conv bases must be literals"
        return None

    def _bases(self):
        if not (isinstance(self.from_base, Literal)
                and isinstance(self.to_base, Literal)):
            raise TypeError("conv bases must be literals")
        return int(self.from_base.value), int(self.to_base.value)

    def eval(self, batch, ctx=EvalContext()):
        fb, tb = self._bases()
        c = self.child.eval(batch, ctx)
        n = batch.capacity
        dev = batch.device
        if not (2 <= fb <= 36 and 2 <= abs(tb) <= 36):
            return _string_column(
                torch.zeros((n, 65), dtype=torch.uint8, device=dev),
                torch.zeros(n, dtype=torch.int32, device=dev),
                torch.zeros(n, dtype=torch.bool, device=dev), 65)
        data, lengths = c.data, c.lengths
        ml = data.shape[1]
        # an optional '-', then the digits of from_base (longest prefix)
        neg = (lengths > 0) & (data[:, 0] == ord("-"))
        d = data.to(torch.int64)
        up = torch.where((d >= ord("a")) & (d <= ord("z")), d - 32, d)
        digit = torch.where((up >= ord("0")) & (up <= ord("9")),
                            up - ord("0"),
                            torch.where((up >= ord("A")) & (up <= ord("Z")),
                                        up - ord("A") + 10,
                                        torch.full_like(up, 99)))
        idx = torch.arange(ml, device=dev)[None, :]
        in_range = (idx >= neg.to(torch.int64)[:, None]) & \
            (idx < lengths[:, None])
        ok = digit < fb
        bad_before = (in_range & ~ok).to(torch.int32).cumsum(
            dim=1, dtype=torch.int32)
        use = in_range & ok & (bad_before == 0)
        v = torch.zeros(n, dtype=torch.int64, device=dev)
        for j in range(ml):
            v = torch.where(use[:, j], v * fb + digit[:, j], v)
        any_digit = use.any(dim=1)
        v = torch.where(neg & any_digit, (~v) + 1, v)
        if tb < 0:
            out_neg = v < 0
            v = torch.where(out_neg, -v, v)   # -MIN keeps 2^63's bits
        else:
            out_neg = torch.zeros(n, dtype=torch.bool, device=dev)
        body, length = _digit_string(_unsigned_digits(v, abs(tb)), 65)
        out = torch.where(out_neg[:, None],
                          F.pad(body[:, :-1], (1, 0), value=ord("-")), body)
        out_len = length + out_neg.to(torch.int32)
        zero = F.pad(torch.full((n, 1), ord("0"), dtype=torch.uint8,
                                device=dev), (0, 64))
        out = torch.where(any_digit[:, None], out, zero)
        out_len = torch.where(any_digit, out_len, torch.ones_like(out_len))
        return _string_column(out, out_len, c.validity, 65)


# ---------------------------------------------------------------------------
# FindInSet, Empty2Null
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class FindInSet(Expression):
    """find_in_set(str, set): 1-based index of ``str`` within the
    comma-separated ``set``, 0 when absent or when ``str`` contains a
    comma (reference: GpuStringFindInSet)."""

    child: Expression = None
    set: Expression = None

    @property
    def children(self):
        return (self.child, self.set)

    def with_children(self, c):
        return FindInSet(c[0], c[1])

    @property
    def dtype(self):
        return T.INT32

    def eval(self, batch, ctx=EvalContext()):
        q = self.child.eval(batch, ctx)
        s = self.set.eval(batch, ctx)
        comma = ord(",")
        n, mls = s.data.shape
        mlq = q.data.shape[1]
        dev = s.data.device
        pos = torch.arange(mls, device=dev)[None, :]
        in_set = pos < s.lengths[:, None]
        is_comma = (s.data == comma) & in_set
        # a needle per row: m[row, p] = set[p:p+qlen] == str (bytes past
        # the set's end wrap around, and such a p fails the end test)
        m = torch.ones((n, mls), dtype=torch.bool, device=dev)
        for j in range(mlq):
            shifted = torch.roll(s.data, -j, dims=1)
            m = m & ((j >= q.lengths)[:, None]
                     | (shifted == q.data[:, j:j + 1]))
        # entries start at position 0 or right after a comma
        start = torch.cat([torch.ones_like(in_set[:, :1]),
                           is_comma[:, :-1]], dim=1) & in_set
        # and must END exactly at p + qlen (a comma or the set's end)
        endp = pos + q.lengths[:, None]
        at_end = endp == s.lengths[:, None]
        comma_at_end = is_comma.gather(1, endp.clamp(0, mls - 1).long()) \
            & (endp < mls)
        hit = start & m & (at_end | comma_at_end) & \
            (endp <= s.lengths[:, None])
        ci = is_comma.to(torch.int32)
        entry_id = ci.cumsum(dim=1, dtype=torch.int32) - ci
        found = hit.any(dim=1)
        idx = entry_id.gather(1, _first_true(hit)[:, None])[:, 0] + 1
        # the empty entry STARTING at position len(set) (an empty set, or
        # a trailing comma) lies outside the position grid
        n_entries = ci.sum(dim=1, dtype=torch.int32) + 1
        last_ix = (s.lengths - 1).clamp(0, mls - 1)
        end_empty = (s.lengths == 0) | is_comma.gather(
            1, last_ix[:, None].long())[:, 0]
        end_hit = (q.lengths == 0) & end_empty
        zero = torch.zeros_like(idx)
        idx = torch.where(found, idx, torch.where(end_hit, n_entries, zero))
        found = found | end_hit
        has_comma = ((q.data == comma) & (
            torch.arange(mlq, device=dev)[None, :] < q.lengths[:, None])
        ).any(dim=1)
        r = torch.where(found & ~has_comma, idx, zero)
        return numeric_column(r.to(torch.int32), q.validity & s.validity,
                              T.INT32)


@dataclass(frozen=True, eq=False)
class Empty2Null(Expression):
    """'' -> NULL (Spark inserts it around Hive text writes; reference:
    GpuEmpty2Null)."""

    child: Expression = None

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return Empty2Null(c[0])

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def nullable(self):
        return True

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        return DeviceColumn(c.data, c.validity & (c.lengths > 0), c.dtype,
                            c.lengths)


@dataclass(frozen=True, eq=False)
class StringToMap(Expression):
    """str_to_map(str, pair_delim, kv_delim) with literal single-byte
    delimiters -> map<string,string> (reference: GpuStringToMap).

    The JAX package's layout, bit for bit: keys in ``data`` and values in
    ``data2``, each ``uint8[cap, max_entries, max_len]`` and zero-padded,
    so an element's length is its last non-zero byte
    (``string_elem_lengths``). An entry without the kv delimiter has the
    whole entry as its key and a NULL value, marked by 0xFF in the value's
    first byte (0xFF never occurs in valid UTF-8). A row of more entries
    than ``max_entries`` raises ``CAPACITY_str_to_map_entries`` in every
    mode."""

    child: Expression = None
    pair_delim: str = ","
    kv_delim: str = ":"
    max_entries: int = 16

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return StringToMap(c[0], self.pair_delim, self.kv_delim,
                           self.max_entries)

    def device_unsupported_reason(self):
        if len(self.pair_delim.encode()) != 1 or \
                len(self.kv_delim.encode()) != 1:
            return "str_to_map: delimiters must be single-byte literals"
        return None

    @property
    def dtype(self):
        ml = self.child.dtype.max_len or 64
        return T.map_(T.string(ml), T.string(ml), self.max_entries)

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        pd = self.pair_delim.encode()[0]
        kd = self.kv_delim.encode()[0]
        n, ml = c.data.shape
        E = self.max_entries
        dev = c.data.device
        pos = torch.arange(ml, dtype=torch.int32, device=dev)[None, :]
        in_str = pos < c.lengths[:, None]
        is_pd = (c.data == pd) & in_str
        # each byte's entry (a delimiter closes the entry before it)
        ipd = is_pd.to(torch.int32)
        entry_id = torch.cumsum(ipd, dim=1, dtype=torch.int32) - ipd
        n_entries = torch.where(c.lengths > 0, entry_id[:, -1] + 1,
                                torch.where(c.validity, 1, 0))
        ctx.report((n_entries > E) & c.validity,
                   "CAPACITY_str_to_map_entries", always=True)
        # each byte's offset within its entry
        starts = torch.where(is_pd, pos + 1, 0)
        off = pos - torch.cummax(starts, dim=1).values
        eid = entry_id.clamp(0, E - 1).to(torch.int64)
        rows = torch.arange(n, device=dev)[:, None].expand(n, ml)
        flat = rows * E + eid
        # the first kv delimiter of each entry (ml + 1: none, a NULL value)
        is_kd = (c.data == kd) & in_str & ~is_pd
        kv_off = torch.full((n * E + 1,), ml + 1, dtype=torch.int32,
                            device=dev).scatter_reduce_(
            0, torch.where(is_kd, flat, n * E).reshape(-1),
            off.reshape(-1).to(torch.int32), "amin")[:n * E].reshape(n, E)
        kv_here = kv_off.gather(1, eid)
        body = in_str & ~is_pd
        is_key = body & (off < kv_here)
        is_val = body & (off > kv_here)
        voff = off - kv_here - 1
        # every byte lands in its entry's key or value row, the rest in a
        # dropped slot past the end
        drop = n * E * ml

        def place(member, at):
            idx = torch.where(member, flat * ml + at, drop).reshape(-1)
            out = torch.zeros(drop + 1, dtype=torch.uint8, device=dev)
            out[idx] = c.data.reshape(-1)
            return out[:drop].reshape(n, E, ml)

        keys = place(is_key, off)
        vals = place(is_val, voff)
        slot = torch.arange(E, device=dev)[None, :]
        no_kv = (kv_off > ml) & (slot < n_entries.clamp(max=E)[:, None])
        vals[:, :, 0] = torch.where(no_kv, 0xFF, vals[:, :, 0]).to(
            torch.uint8)
        lengths = torch.where(c.validity, n_entries.clamp(max=E), 0).to(
            torch.int32)
        return DeviceColumn(keys, c.validity, self.dtype, lengths,
                            data2=vals)


def string_elem_lengths(b3: torch.Tensor) -> torch.Tensor:
    """The byte lengths of the elements of a zero-padded ``[..., ml]``
    string tensor (canonical padding; valid UTF-8 holds no NUL): one past
    the last non-zero byte."""
    ml = b3.shape[-1]
    nz = b3 != 0
    last = ml - 1 - nz.flip(-1).to(torch.uint8).argmax(dim=-1)
    return torch.where(nz.any(dim=-1), last + 1, 0).to(torch.int32)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def upper(e):
    return Upper(e)


def lower(e):
    return Lower(e)


def length(e):
    return Length(e)


def substring(e, pos, ln=None):
    return Substring(e, lit_if_needed(pos),
                     lit_if_needed(ln) if ln is not None else None)


def concat(*es):
    return Concat(tuple(es))


def contains(e, pat):
    return StringPredicate(e, lit_if_needed(pat), "contains")


def startswith(e, pat):
    return StringPredicate(e, lit_if_needed(pat), "startswith")


def endswith(e, pat):
    return StringPredicate(e, lit_if_needed(pat), "endswith")
