"""Regular expressions on the device: a plan-time DFA and a table-driven
scan over byte positions.

Port of ``RegexUnsupported``, the parser, ``CompiledRegex`` /
``compile_regex``, ``rlike_device``, ``RLike``, ``like_to_regex``,
``Like``, and the span programs (``compile_spans``, the span scans,
``RegexpExtract``, ``RegexpReplace``, ``split_device`` and
``StringSplit``) of
``spark_rapids_tpu/expressions/regex.py`` (reference:
RegexParser.scala, which transpiles Java regex to cudf's dialect and falls
back to the CPU for what it cannot). A supported SUBSET of Java regex is
parsed on the host at plan time, compiled Thompson NFA -> subset DFA over
byte-equivalence classes, and matched on the device as one
``[state, class]`` table gather per byte position for every row at once.
The host part is the JAX package's, copied (this package imports nothing
of it); the scan is a loop of torch ops over the ``max_len`` byte positions
with no host read, as the JAX package leaves it to XLA: no hand-written
kernel stands behind it (no Pallas kernel does there).

Supported subset: literals, '.', character classes [a-z0-9_^-], \\d \\w
\\s (and negations), anchors ^ $, quantifiers * + ? {m,n} on single atoms,
alternation |, non-capturing groups. Unsupported constructs raise
``RegexUnsupported`` when the expression is built, with the JAX package's
messages. ``spark.rapids.tpu.sql.regexp.enabled=false`` sends RLIKE to the
CPU (``plan/overrides.py``).

Semantics: RLIKE = Java Matcher.find() (unanchored substring search) over
UTF-8 BYTES. Positive matching units are ASCII, but '.' and negated classes
match one full NON-ASCII character through a UTF-8 lead + continuation
submachine, so counting characters holds over multi-byte text.
``StringSplit`` gives an ``array<string>`` in the 3D byte layout.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import types as T
from ..batch import ColumnarBatch, DeviceColumn
from .base import EvalContext, Expression, _device_row, numeric_column
from .strings import _first_true, _string_column


class RegexUnsupported(ValueError):
    """Construct outside the device subset (CPU fallback signal)."""


# ---------------------------------------------------------------------------
# Parser -> NFA (Thompson construction)
# ---------------------------------------------------------------------------

EPS = -1


class _NFA:
    def __init__(self):
        self.transitions: List[List[Tuple[Optional[FrozenSet[int]], int]]] = []

    def new_state(self) -> int:
        self.transitions.append([])
        return len(self.transitions) - 1

    def add(self, s: int, charset: Optional[FrozenSet[int]], t: int):
        self.transitions[s].append((charset, t))


_CLASS_D = frozenset(range(ord("0"), ord("9") + 1))
_CLASS_W = _CLASS_D | frozenset(range(ord("a"), ord("z") + 1)) | \
    frozenset(range(ord("A"), ord("Z") + 1)) | {ord("_")}
_CLASS_S = {ord(" "), ord("\t"), ord("\n"), ord("\r"), 0x0B, 0x0C}
_ALL = frozenset(range(1, 128))     # ASCII sans NUL (padding byte)
# Sentinel member: "plus any single NON-ASCII character". Java regex treats
# e.g. 'é' as ONE '.'/'\\D'/'[^a]' unit; the byte-level NFA realizes it as a
# UTF-8 submachine (lead byte + continuation bytes) in _build_atom, so
# char-counting semantics hold over multi-byte text.
NONASCII = -1
_CONT = frozenset(range(0x80, 0xC0))    # UTF-8 continuation bytes
_LEAD2 = frozenset(range(0xC2, 0xE0))
_LEAD3 = frozenset(range(0xE0, 0xF0))
_LEAD4 = frozenset(range(0xF0, 0xF5))
_DOT = (_ALL - {ord("\n")}) | {NONASCII}   # Java '.' excludes line terminators


class _Parser:
    """Recursive-descent over the supported subset."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.anchored_start = False
        self.anchored_end = False
        self.depth = 0
        self.saw_top_alternation = False
        self.dot = _DOT

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    # grammar: alt := seq ('|' seq)* ; seq := rep* ; rep := atom [*+?{m,n}]
    def parse(self, nfa: _NFA) -> Tuple[int, int]:
        if self.p.startswith("(?s)"):
            # inline DOTALL: '.' matches any char incl. newline (LIKE '%'/'_')
            self.i = 4
            self.dot = _ALL | {NONASCII}
        if self.peek() == "^":
            self.next()
            self.anchored_start = True
        start, end = self._alt(nfa)
        if self.i < len(self.p):
            raise RegexUnsupported(f"trailing input at {self.i}: {self.p}")
        return start, end

    def _alt(self, nfa: _NFA) -> Tuple[int, int]:
        parts = [self._seq(nfa)]
        while self.peek() == "|":
            self.next()
            if self.depth == 0:
                self.saw_top_alternation = True
            parts.append(self._seq(nfa))
        if len(parts) == 1:
            return parts[0]
        s, e = nfa.new_state(), nfa.new_state()
        for ps, pe in parts:
            nfa.add(s, None, ps)
            nfa.add(pe, None, e)
        return s, e

    def _seq(self, nfa: _NFA) -> Tuple[int, int]:
        s = nfa.new_state()
        cur = s
        while self.peek() not in (None, "|", ")"):
            if self.peek() == "$":
                # $ is modeled as a GLOBAL end anchor, so it is only sound
                # at the very end of the whole pattern
                save = self.i
                self.next()
                if self.peek() is None and self.depth == 0 \
                        and not self.saw_top_alternation:
                    self.anchored_end = True
                    break
                raise RegexUnsupported(
                    f"$ only supported at pattern end (pos {save})")
            cur = self._rep(nfa, cur)
        e = nfa.new_state()
        nfa.add(cur, None, e)
        return s, e

    def _rep(self, nfa: _NFA, prev: int) -> int:
        a_start, a_end = self._atom(nfa)
        lo, hi = 1, 1
        c = self.peek()
        if c == "*":
            self.next()
            lo, hi = 0, -1
        elif c == "+":
            self.next()
            lo, hi = 1, -1
        elif c == "?":
            self.next()
            lo, hi = 0, 1
        elif c == "{":
            self.next()
            lo, hi = self._bounds()
        if self.peek() == "?":
            raise RegexUnsupported("lazy quantifiers")

        # expand {lo,hi} by duplication (bounded); * and + via back-eps
        if (lo, hi) == (1, 1):
            nfa.add(prev, None, a_start)
            return a_end
        if hi == -1:
            entry = nfa.new_state()
            exit_ = nfa.new_state()
            nfa.add(prev, None, entry)
            nfa.add(entry, None, a_start)
            nfa.add(a_end, None, entry)     # loop
            if lo == 0:
                nfa.add(entry, None, exit_)
            nfa.add(a_end, None, exit_)
            if lo > 1:
                raise RegexUnsupported("{m,} with m>1")
            return exit_
        if hi > 8 or lo > hi:
            raise RegexUnsupported(f"counted repetition {{{lo},{hi}}} > 8")
        cur = prev
        frag = self._fragment_of(nfa, a_start, a_end)
        exits = []
        for k in range(hi):
            fs, fe = frag() if k > 0 else (a_start, a_end)
            nfa.add(cur, None, fs)
            if k + 1 >= lo:
                exits.append(fe)
            cur = fe
        out = nfa.new_state()
        for e in exits:
            nfa.add(e, None, out)
        if lo == 0:
            nfa.add(prev, None, out)
        return out

    def _fragment_of(self, nfa: _NFA, s: int, e: int):
        """Duplicator for counted repetition of a single atom."""
        spec = self._last_atom_spec
        def dup():
            return self._build_atom(nfa, spec)
        return dup

    def _bounds(self) -> Tuple[int, int]:
        num = ""
        while self.peek() and self.peek().isdigit():
            num += self.next()
        lo = int(num)
        hi = lo
        if self.peek() == ",":
            self.next()
            num = ""
            while self.peek() and self.peek().isdigit():
                num += self.next()
            hi = int(num) if num else -1
        if self.peek() != "}":
            raise RegexUnsupported("malformed {m,n}")
        self.next()
        return lo, hi

    def _atom(self, nfa: _NFA) -> Tuple[int, int]:
        c = self.peek()
        if c is None:
            raise RegexUnsupported("empty atom")
        if c == "(":
            self.next()
            self.depth += 1
            if self.peek() == "?":
                self.next()
                if self.peek() != ":":
                    raise RegexUnsupported("lookaround / named groups")
                self.next()
            s, e = self._alt(nfa)
            if self.peek() != ")":
                raise RegexUnsupported("unbalanced group")
            self.next()
            self.depth -= 1
            self._last_atom_spec = None   # groups not duplicable via {m,n}
            return s, e
        spec = self._charset()
        self._last_atom_spec = spec
        return self._build_atom(nfa, spec)

    def _build_atom(self, nfa: _NFA, spec) -> Tuple[int, int]:
        if spec is None:
            raise RegexUnsupported("counted repetition of a group")
        s, e = nfa.new_state(), nfa.new_state()
        ascii_part = frozenset(b for b in spec if b >= 0)
        if ascii_part:
            nfa.add(s, ascii_part, e)
        if NONASCII in spec:
            # one full UTF-8 character: lead byte then continuation bytes
            m1 = nfa.new_state()
            nfa.add(s, _LEAD2, m1)
            nfa.add(m1, _CONT, e)
            m2, m3 = nfa.new_state(), nfa.new_state()
            nfa.add(s, _LEAD3, m2)
            nfa.add(m2, _CONT, m3)
            nfa.add(m3, _CONT, e)
            m4, m5, m6 = (nfa.new_state() for _ in range(3))
            nfa.add(s, _LEAD4, m4)
            nfa.add(m4, _CONT, m5)
            nfa.add(m5, _CONT, m6)
            nfa.add(m6, _CONT, e)
        return s, e

    def _charset(self) -> FrozenSet[int]:
        c = self.next()
        if c == ".":
            return self.dot
        if c == "\\":
            return self._escape()
        if c == "[":
            return self._cls()
        if c in "*+?{}()|":
            raise RegexUnsupported(f"unexpected metachar {c!r}")
        if c == "^":
            raise RegexUnsupported("^ only supported at pattern start")
        if ord(c) > 127:
            raise RegexUnsupported("non-ASCII literal (multi-byte units)")
        return frozenset({ord(c)})

    def _escape(self) -> FrozenSet[int]:
        c = self.next()
        if c == "d":
            return frozenset(_CLASS_D)
        if c == "D":
            return (_ALL - _CLASS_D) | {NONASCII}
        if c == "w":
            return frozenset(_CLASS_W)
        if c == "W":
            return (_ALL - _CLASS_W) | {NONASCII}
        if c == "s":
            return frozenset(_CLASS_S)
        if c == "S":
            return (_ALL - frozenset(_CLASS_S)) | {NONASCII}
        if c in ".\\[](){}*+?|^$":
            return frozenset({ord(c)})
        if c == "n":
            return frozenset({10})
        if c == "t":
            return frozenset({9})
        if c == "r":
            return frozenset({13})
        raise RegexUnsupported(f"escape \\{c}")

    def _cls(self) -> FrozenSet[int]:
        neg = False
        if self.peek() == "^":
            self.next()
            neg = True
        out: Set[int] = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise RegexUnsupported("unterminated class")
            if c == "]" and not first:
                self.next()
                break
            first = False
            if c == "\\":
                self.next()
                out |= self._escape()
                continue
            self.next()
            if ord(c) > 127:
                raise RegexUnsupported("non-ASCII in class")
            if self.peek() == "-" and self.i + 1 < len(self.p) and \
                    self.p[self.i + 1] != "]":
                self.next()
                hi = self.next()
                out |= set(range(ord(c), ord(hi) + 1))
            else:
                out.add(ord(c))
        return ((_ALL - out) | {NONASCII}) if neg else frozenset(out)


# ---------------------------------------------------------------------------
# NFA -> DFA (subset construction over byte equivalence classes)
# ---------------------------------------------------------------------------

@dataclass
class CompiledRegex:
    table: np.ndarray          # int32 [n_states, n_classes]
    byte_class: np.ndarray     # int32 [256]
    accepting: np.ndarray      # bool [n_states]
    start_state: int
    anchored_start: bool
    anchored_end: bool
    max_states: int = 0
    #: device -> (transition table, byte classes, accepting flags) in the
    #: scan's layout, each copied there once: a later scan makes no host
    #: copy
    _on: Dict[object, Tuple[torch.Tensor, ...]] = field(
        default_factory=dict, repr=False, compare=False)

    def scan_tables(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """The span scans' tables on ``device`` (``on``'s layout in int32,
        read where the grids are widest): ``step[s * C + c] = next(s, c) *
        C``, the byte classes, and ``hits[s * C + c] = accepting(next(s,
        c))``, so one index into a row's (state + class) gives the next
        state and whether it accepts."""
        key = ("scan", device)
        t = self._on.get(key)
        if t is None:
            c = self.table.shape[1]
            nxt = self.table.astype(np.int64).ravel()
            t = (torch.from_numpy((nxt * c).astype(np.int32)).to(device),
                 torch.from_numpy(self.byte_class.astype(np.int32)
                                  ).to(device),
                 torch.from_numpy(self.accepting[nxt].astype(np.bool_)
                                  ).to(device))
            self._on[key] = t
        return t

    def on(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """The tables on ``device``, with each state premultiplied by the
        class count (a state is its row's offset): ``step[s * C + c] =
        next(s, c) * C`` and ``accepting[s * C + c] = accepting(s)``, both
        flat, and the byte classes; int64 and bool."""
        t = self._on.get(device)
        if t is None:
            c = self.table.shape[1]
            t = (torch.from_numpy(self.table.astype(np.int64).ravel() * c
                                  ).to(device),
                 torch.from_numpy(self.byte_class.astype(np.int64)
                                  ).to(device),
                 torch.from_numpy(np.repeat(self.accepting.astype(np.bool_),
                                            c)).to(device))
            self._on[device] = t
        return t


def compile_regex(pattern: str, max_states: int = 128) -> CompiledRegex:
    nfa = _NFA()
    parser = _Parser(pattern)
    start, accept = parser.parse(nfa)

    # Unanchored find(): an any-byte self-loop on the NFA start makes the
    # subset-constructed DFA the exact `.*P` matcher — all candidate match
    # starts are tracked simultaneously (the textbook construction; a
    # single-candidate DFA with restart hacks is wrong for self-overlapping
    # patterns).
    if not parser.anchored_start:
        nfa.add(start, frozenset(range(256)), start)

    # byte equivalence classes from all charsets in the NFA
    sig = {}
    for trs in nfa.transitions:
        for cs, _ in trs:
            if cs is not None:
                for b in range(256):
                    sig.setdefault(b, [])
    # build signature per byte: membership vector over distinct charsets
    charsets = []
    seen = set()
    for trs in nfa.transitions:
        for cs, _ in trs:
            if cs is not None and id(cs) not in seen:
                seen.add(id(cs))
                charsets.append(cs)
    byte_sig: Dict[int, Tuple[bool, ...]] = {
        b: tuple(b in cs for cs in charsets) for b in range(256)}
    classes: Dict[Tuple[bool, ...], int] = {}
    byte_class = np.zeros(256, np.int32)
    for b in range(256):
        s = byte_sig[b]
        if s not in classes:
            classes[s] = len(classes)
        byte_class[b] = classes[s]
    n_classes = len(classes)
    rep_byte = {}
    for b in range(256):
        rep_byte.setdefault(int(byte_class[b]), b)

    def eps_closure(states: FrozenSet[int]) -> FrozenSet[int]:
        stack = list(states)
        out = set(states)
        while stack:
            s = stack.pop()
            for cs, t in nfa.transitions[s]:
                if cs is None and t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    start_set = eps_closure(frozenset({start}))
    dfa_states: Dict[FrozenSet[int], int] = {start_set: 0}
    rows: List[List[int]] = []
    accepting: List[bool] = []
    worklist = [start_set]
    while worklist:
        cur = worklist.pop()
        idx = dfa_states[cur]
        while len(rows) <= idx:
            rows.append([0] * n_classes)
            accepting.append(False)
        accepting[idx] = accept in cur
        for cls_id, rb in rep_byte.items():
            nxt = set()
            for s in cur:
                for cs, t in nfa.transitions[s]:
                    if cs is not None and rb in cs:
                        nxt.add(t)
            nxt_f = eps_closure(frozenset(nxt)) if nxt else frozenset()
            if nxt_f not in dfa_states:
                dfa_states[nxt_f] = len(dfa_states)
                if len(dfa_states) > max_states:
                    raise RegexUnsupported(
                        f"DFA exceeds {max_states} states")
                worklist.append(nxt_f)
            rows[idx][cls_id] = dfa_states[nxt_f]
    # dead state = eps_closure(frozenset()) mapping (empty set)
    table = np.asarray(rows, np.int32)
    acc = np.asarray(accepting, bool)
    # pad accepting to table length
    if len(acc) < table.shape[0]:
        acc = np.pad(acc, (0, table.shape[0] - len(acc)))
    return CompiledRegex(table, byte_class, acc, 0,
                         parser.anchored_start, parser.anchored_end,
                         table.shape[0])



# ---------------------------------------------------------------------------
# Device matcher
# ---------------------------------------------------------------------------

def rlike_device(col: DeviceColumn, rx: CompiledRegex) -> torch.Tensor:
    """bool[n]: does Java find() succeed per row. One step per byte
    position, each a single [state, class] table gather for all rows at
    once (the JAX package's ``lax.scan``), with no host read, so a fused
    stage can capture it: three launches a step (index, gather, select)
    and three more where the pattern does not end in ``$``. Under ``$``
    only the state a row ends in can accept (a row's state stops at its
    length), so that is read once after the loop."""
    data = col.data            # uint8 [n, ml]
    lengths = col.lengths
    n, ml = data.shape
    dev = data.device
    step, bclass, accepting = rx.on(dev)
    classes = bclass[data.long()]                              # [n, ml]
    in_str = torch.arange(ml, device=dev)[None, :] < lengths[:, None]
    state = torch.full((n,), rx.start_state * rx.table.shape[1],
                       dtype=torch.int64, device=dev)
    matched = torch.zeros(n, dtype=torch.bool, device=dev)
    for j in range(ml):
        valid = in_str[:, j]
        state = torch.where(valid, step[state + classes[:, j]], state)
        if not rx.anchored_end:
            matched = matched | (accepting[state] & valid)
    if rx.anchored_end:
        matched = accepting[state] & (lengths > 0)

    if bool(rx.accepting[rx.start_state]):
        # the pattern matches the empty string somewhere:
        if rx.anchored_start and rx.anchored_end:
            matched = matched | (lengths == 0)   # ^...$ needs empty subject
        else:
            matched = torch.ones_like(matched)   # zero-length find() hit
    return matched


@dataclass(frozen=True, eq=False)
class RLike(Expression):
    """str RLIKE pattern (reference: GpuRLike via the regex transpiler).
    The pattern is a string literal, compiled once when the expression is
    built; unsupported constructs raise ``RegexUnsupported`` there."""

    child: "Expression" = None
    pattern: str = ""

    def __post_init__(self):
        object.__setattr__(self, "_compiled", compile_regex(self.pattern))

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return RLike(c[0], self.pattern)

    @property
    def dtype(self):
        return T.BOOLEAN

    def eval(self, batch: ColumnarBatch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        m = rlike_device(c, self._compiled)
        return numeric_column(m, c.validity, T.BOOLEAN)

    def __repr__(self):
        return f"{self.child!r} RLIKE {self.pattern!r}"


def rlike(e: Expression, pattern: str) -> RLike:
    return RLike(e, pattern)


def like_to_regex(like_pattern: str, escape: str = "\\") -> str:
    """SQL LIKE -> regex (Spark's LikeSimplification handles the fast paths
    upstream; this covers the general case: % -> .*, _ -> ., DOTALL so %
    crosses newlines)."""
    out = ["(?s)^"]
    i = 0
    while i < len(like_pattern):
        ch = like_pattern[i]
        if ch == escape and i + 1 < len(like_pattern):
            out.append(_regex_quote(like_pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(_regex_quote(ch))
        i += 1
    out.append("$")
    return "".join(out)


def _regex_quote(ch: str) -> str:
    return "\\" + ch if ch in ".\\[](){}*+?|^$" else ch


@dataclass(frozen=True, eq=False)
class Like(Expression):
    """str LIKE pattern, through the same DFA."""

    child: "Expression" = None
    pattern: str = ""

    def __post_init__(self):
        object.__setattr__(
            self, "_compiled", compile_regex(like_to_regex(self.pattern)))

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return Like(c[0], self.pattern)

    @property
    def dtype(self):
        return T.BOOLEAN

    def eval(self, batch: ColumnarBatch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        m = rlike_device(c, self._compiled)
        return numeric_column(m, c.validity, T.BOOLEAN)

    def __repr__(self):
        return f"{self.child!r} LIKE {self.pattern!r}"


# ---------------------------------------------------------------------------
# Match spans + capture groups (regexp_extract / regexp_replace)
#
# Java's backtracking order for a greedy concatenation picks, left to
# right, the LONGEST prefix for each segment such that the rest of the
# pattern can still match. That is computed here without backtracking: the
# pattern is split into a top-level concatenation of SEGMENTS (quantified
# atoms and groups), and for segment i at position p, end_i = max q where
# (segment i matches [p, q)) AND (suffix i+1 is feasible from q). Each test
# is one scan of a DFA over the byte positions.
#
# Subset: concatenations of quantified character classes and groups.
# Alternation ('|') and lazy quantifiers change Java's search order in ways
# a longest-feasible rule cannot reproduce -> RegexUnsupported (CPU
# fallback). The compiler is the JAX package's, copied; each machine comes
# from this module's compile_regex.
# ---------------------------------------------------------------------------


@dataclass
class _Segment:
    src: str                    # pattern source for this segment
    compiled: CompiledRegex     # anchored-start machine for the segment


@dataclass
class SpanProgram:
    """Compiled form for span/group queries."""

    segments: List[_Segment]
    suffixes: List[Optional[CompiledRegex]]   # machine for segments[i:]
    group_bounds: Dict[int, Tuple[int, int]]  # group -> (first, last excl)
    n_groups: int
    anchored_start: bool
    anchored_end: bool


def _compile_anchored(pattern: str) -> CompiledRegex:
    """Compile with NO unanchored-find start loop (the machine starts
    exactly at its activation position)."""
    return compile_regex("^" + pattern if not pattern.startswith("^")
                         else pattern)


class _SegmentParser:
    """Source-level splitter: top-level concatenation -> segment sources.

    An unquantified group is flattened into its inner segments (capturing
    groups record which segment range they cover, so nesting of
    unquantified captures is fine). A QUANTIFIED group must have a
    fixed-shape body (a plain unit sequence): its greedy repetition is then
    longest-feasible, which matches Java.
    """

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.group_bounds: Dict[int, Tuple[int, int]] = {}
        self.n_groups = 0
        self.anchored_start = False
        self.anchored_end = False
        self._segs_emitted = 0

    def parse(self) -> List[str]:
        if self.p.startswith("(?s)"):
            self.i = 4
        if self._peek() == "^":
            self.i += 1
            self.anchored_start = True
        segs = self._concat(top=True)
        if self.i < len(self.p):
            raise RegexUnsupported(
                f"spans: trailing input at {self.i}: {self.p}")
        return segs

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def _concat(self, top: bool) -> List[str]:
        segs: List[str] = []
        while True:
            c = self._peek()
            if c is None or c == ")":
                return segs
            if c == "|":
                raise RegexUnsupported(
                    "spans: alternation changes Java's search order; "
                    "longest-feasible cannot reproduce it")
            if c == "$":
                nxt = self.i + 1
                if top and nxt == len(self.p):
                    self.anchored_end = True
                    self.i += 1
                    return segs
                raise RegexUnsupported("spans: inner $")
            if c == "(":
                segs.extend(self._group())
            else:
                segs.append(self._unit_with_quant())
                self._segs_emitted += 1

    def _unit_src(self) -> str:
        """One class/escape/char/dot unit; returns its source slice."""
        start = self.i
        c = self.p[self.i]
        self.i += 1
        if c == "\\":
            if self.i >= len(self.p):
                raise RegexUnsupported("spans: trailing backslash")
            self.i += 1
        elif c == "[":
            self.i -= 1
            self._skip_class()
        elif c in "*+?{}()|^$":
            raise RegexUnsupported(f"spans: unexpected metachar {c!r}")
        return self.p[start:self.i]

    def _quant_src(self) -> str:
        c = self._peek()
        if c in ("*", "+", "?"):
            self.i += 1
            if self._peek() == "?":
                raise RegexUnsupported("lazy quantifiers")
            return c
        if c == "{":
            start = self.i
            while self._peek() not in (None, "}"):
                self.i += 1
            if self._peek() != "}":
                raise RegexUnsupported("spans: malformed {m,n}")
            self.i += 1
            if self._peek() == "?":
                raise RegexUnsupported("lazy quantifiers")
            return self.p[start:self.i]
        return ""

    def _unit_with_quant(self) -> str:
        u = self._unit_src()
        return u + self._quant_src()

    def _fixed_body(self, body: str) -> bool:
        """True if body is a plain unit sequence (no quantifiers, groups,
        alternation): safe under an outer quantifier."""
        sub = _SegmentParser(body)
        try:
            segs = sub._concat(top=False)
        except RegexUnsupported:
            return False
        if sub.i < len(body) or sub.group_bounds:
            return False
        return all(not s or s[-1] not in "*+?}" for s in segs)

    def _group(self) -> List[str]:
        self.i += 1                      # consume '('
        capturing = True
        if self._peek() == "?":
            self.i += 1
            if self._peek() != ":":
                raise RegexUnsupported("lookaround / named groups")
            self.i += 1
            capturing = False
        gidx = 0
        if capturing:
            self.n_groups += 1
            gidx = self.n_groups
        body_start = self.i
        depth = 1
        while depth:
            c = self._peek()
            if c is None:
                raise RegexUnsupported("spans: unbalanced group")
            if c == "\\":
                self.i += 2
                continue
            if c == "[":
                self._skip_class()
                continue
            if c == "(":
                depth += 1
            elif c == ")":
                depth -= 1
            self.i += 1
        body = self.p[body_start:self.i - 1]
        quant = self._quant_src()
        if quant:
            if capturing:
                # Java binds a quantified capture group to its LAST
                # iteration; a segment span covers all of them
                raise RegexUnsupported(
                    "spans: quantified capturing group binds the last "
                    "iteration in Java")
            if not self._fixed_body(body):
                raise RegexUnsupported(
                    "spans: quantified group with variable-shape body")
            self._segs_emitted += 1
            return [f"(?:{body}){quant}"]
        # unquantified group: flatten its body into segments
        sub = _SegmentParser(body)
        inner = sub._concat(top=False)
        if sub.i < len(body):
            raise RegexUnsupported("spans: bad group body")
        first = self._segs_emitted
        # renumber nested groups relative to ours
        for g, (a, b) in sub.group_bounds.items():
            self.group_bounds[self.n_groups + g] = (first + a, first + b)
        self.n_groups += sub.n_groups
        if capturing:
            self.group_bounds[gidx] = (first, first + len(inner))
        self._segs_emitted += len(inner)
        return inner

    def _skip_class(self):
        self.i += 1                      # consume '['
        if self._peek() == "^":
            self.i += 1
        first = True
        while True:
            c = self._peek()
            if c is None:
                raise RegexUnsupported("spans: unterminated class")
            if c == "]" and not first:
                self.i += 1
                return
            first = False
            if c == "\\":
                self.i += 1
            self.i += 1


def compile_spans(pattern: str) -> SpanProgram:
    """Compile for span/group queries; RegexUnsupported -> CPU fallback."""
    sp = _SegmentParser(pattern)
    seg_srcs = sp.parse()
    if not seg_srcs:
        raise RegexUnsupported("spans: empty pattern")
    segments = [_Segment(s, _compile_anchored(s)) for s in seg_srcs]
    suffixes = []
    for i in range(len(seg_srcs) + 1):
        rest = "".join(seg_srcs[i:])
        suffixes.append(_compile_anchored(rest) if rest else None)
    return SpanProgram(segments, suffixes, sp.group_bounds, sp.n_groups,
                       sp.anchored_start, sp.anchored_end)


def _try_compile_spans(pattern: str):
    try:
        return compile_spans(pattern), None
    except RegexUnsupported as ex:
        return None, str(ex)


# ---- the scans: a Python loop of torch ops over the byte positions, with
# no host read, so a fused stage can capture them. Machines that have not
# started yet sit in the start state; a byte past a row's length never
# counts, so the state it leaves is never read.

def _classes(col: DeviceColumn, rx: CompiledRegex):
    """(step, hits, the byte class of every byte [n, ml], in_str [n, ml])
    in ``CompiledRegex.scan_tables``' layout."""
    data = col.data
    step, bclass, hits = rx.scan_tables(data.device)
    cls = bclass[data.long()]
    return step, hits, cls, _positions(col, data.shape[1]) \
        < col.lengths[:, None]


def _positions(col: DeviceColumn, count: int) -> torch.Tensor:
    return torch.arange(count, dtype=torch.int32,
                        device=col.data.device)[None, :]


def feasible_starts(col: DeviceColumn, rx: Optional[CompiledRegex],
                    anchored_end: bool) -> torch.Tensor:
    """bool [n, ml+1]: can ``rx`` (anchored at q) match starting at byte
    position q? One parallel-machine scan: machine q sits in the start
    state until step q, then consumes; step j advances machines 0..j only
    (the grid's lower triangle). ``rx=None`` is the empty suffix."""
    n, ml = col.data.shape
    lengths = col.lengths
    q_idx = _positions(col, ml + 1)
    live = q_idx <= lengths[:, None]
    at_len = q_idx == lengths[:, None]
    if rx is None:
        return live & at_len if anchored_end else live
    step, hits, cls, in_str = _classes(col, rx)
    # byte j may end a match: inside the row, and its last byte under $
    ends = in_str & at_len[:, 1:] if anchored_end else in_str
    if bool(rx.accepting[rx.start_state]):
        ever = live & at_len if anchored_end else live.clone()
    else:
        ever = torch.zeros((n, ml + 1), dtype=torch.bool,
                           device=col.data.device)
    state = torch.full((n, ml + 1), rx.start_state * rx.table.shape[1],
                       dtype=torch.int32, device=col.data.device)
    for j in range(ml):
        idx = state[:, :j + 1] + cls[:, j:j + 1]
        state[:, :j + 1] = step[idx]
        ever[:, :j + 1] |= hits[idx] & ends[:, j:j + 1]
    return ever


def greedy_seg_ends(col: DeviceColumn, seg: CompiledRegex, p: torch.Tensor,
                    feas_next: torch.Tensor,
                    triangular: bool = False) -> torch.Tensor:
    """Greedy end per machine: max q such that ``seg`` matches [p, q) AND
    the remaining pattern is feasible at q. ``p`` is int32 [n, S] (S start
    hypotheses; S = 1 for first-match queries); returns int32 [n, S], -1
    if the segment cannot match under feasibility. ``triangular``: column
    s never starts before position s (every start of ``all_match_spans``),
    so step j advances columns 0..j only."""
    n, ml = col.data.shape
    step, hits, cls, in_str = _classes(col, seg)
    S = p.shape[1]
    alive = p >= 0
    safe_p = p.clamp(0, ml)
    # empty-segment match at p itself
    empty = alive & feas_next.gather(1, safe_p.long())
    if not bool(seg.accepting[seg.start_state]):
        empty = torch.zeros_like(empty)
    best = torch.where(empty, safe_p, torch.full_like(safe_p, -1))
    # the step each machine starts at; never (ml + 1) for a dead one
    begin = torch.where(alive, safe_p, torch.full_like(safe_p, ml + 1))
    state = torch.full((n, S), seg.start_state * seg.table.shape[1],
                       dtype=torch.int32, device=col.data.device)
    for j in range(ml):
        w = min(j + 1, S) if triangular else S
        st = state[:, :w]
        can = (begin[:, :w] <= j) & in_str[:, j:j + 1]
        idx = st + cls[:, j:j + 1]
        state[:, :w] = torch.where(can, step[idx], st)
        best[:, :w].masked_fill_(hits[idx] & can & feas_next[:, j + 1:j + 2],
                                 j + 1)
    return best


def _feasible(col: DeviceColumn, prog: SpanProgram) -> List[torch.Tensor]:
    return [feasible_starts(col, prog.suffixes[i], prog.anchored_end)
            for i in range(len(prog.segments) + 1)]


def first_match_bounds(col: DeviceColumn, prog: SpanProgram
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-most match, Java-greedy. Returns (matched: bool[n], bounds:
    int32[n, k+1]); bounds[:, i] is the byte position where segment i
    starts (bounds[:, k] = match end)."""
    n = col.data.shape[0]
    feas = _feasible(col, prog)
    f0 = feas[0]
    if prog.anchored_start:
        matched = f0[:, 0]
        start = torch.zeros(n, dtype=torch.int32, device=col.data.device)
    else:
        matched = f0.any(dim=1)
        start = _first_true(f0).to(torch.int32)
    p = torch.where(matched, start, torch.full_like(start, -1))[:, None]
    bounds = [p]
    for i, seg in enumerate(prog.segments):
        p = greedy_seg_ends(col, seg.compiled, p, feas[i + 1])
        bounds.append(p)
    return matched, torch.cat(bounds, dim=1)


def all_match_spans(col: DeviceColumn, prog: SpanProgram
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All non-overlapping Java-greedy matches (replaceAll order). Returns
    (sel_start: bool[n, ml+1], match_end: int32[n, ml+1])."""
    n, ml = col.data.shape
    feas = _feasible(col, prog)
    q_idx = _positions(col, ml + 1)
    p = torch.where(feas[0], q_idx, torch.full_like(q_idx, -1))
    for i, seg in enumerate(prog.segments):
        p = greedy_seg_ends(col, seg.compiled, p, feas[i + 1],
                            triangular=True)
    end_q = p                                    # [n, ml+1]; -1: no match
    if prog.anchored_start:
        end_q[:, 1:] = -1
    # leftmost non-overlapping selection (Matcher.find's loop): the next
    # search resumes at the match end, +1 after a zero-length match
    nxt = torch.zeros(n, dtype=torch.int32, device=col.data.device)
    sels = []
    for s in range(ml + 1):
        e = end_q[:, s]
        can = (e >= 0) & (nxt <= s) & (col.lengths >= s)
        nxt = torch.where(can, torch.where(e > s, e, s + 1), nxt)
        sels.append(can)
    return torch.stack(sels, dim=1), end_q


def extract_group_device(col: DeviceColumn, prog: SpanProgram, idx: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bytes [n, ml], lengths [n]) of capture group ``idx`` of the first
    match (idx 0 = the whole match); no match -> the empty string
    (Spark)."""
    ml = col.data.shape[1]
    matched, bounds = first_match_bounds(col, prog)
    if idx == 0:
        a, b = 0, bounds.shape[1] - 1
    else:
        a, b = prog.group_bounds[idx]
    zero = torch.zeros_like(bounds[:, a])
    s = torch.where(matched, bounds[:, a], zero)
    e = torch.where(matched, bounds[:, b], zero)
    glen = (e - s).clamp(min=0)
    pos = _positions(col, ml)
    data = col.data.gather(1, (s[:, None] + pos).clamp(0, ml - 1).long())
    keep = pos < glen[:, None]
    return torch.where(keep, data, torch.zeros_like(data)), glen


def replace_all_device(col: DeviceColumn, prog: SpanProgram, repl: bytes
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Java replaceAll with a literal replacement. Returns (bytes [n,
    out_ml], lengths [n]), out_ml = ml + R * (ml + 1).

    Each position q in [0, ml] emits the replacement if a match is
    selected there, then byte q if no nonzero-length match covers it. The
    output is a row-wise ``searchsorted`` gather over the running count of
    emitted bytes (one reader per output byte), where the JAX package
    scatters into a drop slot."""
    n, ml = col.data.shape
    dev = col.data.device
    R = len(repl)
    out_ml = ml + R * (ml + 1)
    sel, end_q = all_match_spans(col, prog)       # [n, ml+1]
    pos = _positions(col, ml + 1)
    nonzero = sel & (end_q > pos)
    # the selected matches do not overlap, so the latest one to start at
    # or before byte j has the largest end: j is covered iff it is past j
    reach = torch.where(nonzero, end_q, torch.zeros_like(end_q)
                        ).cummax(dim=1).values[:, :ml]
    keep = (pos[:, :ml] < col.lengths[:, None]) & ~(reach > pos[:, :ml])
    unit = R * sel.to(torch.int32)
    unit[:, :ml] += keep.to(torch.int32)
    upto = unit.cumsum(dim=1, dtype=torch.int32)
    offs = upto - unit
    t = _positions(col, out_ml).expand(n, out_ml).contiguous()
    src = torch.searchsorted(upto, t, right=True).clamp(max=ml)
    k = t - offs.gather(1, src)
    from_rep = sel.gather(1, src) & (k < R)
    copied = F.pad(col.data, (0, 1)).gather(1, src)
    if R:
        rep = _device_row(repl, R, dev)[k.clamp(0, R - 1).long()]
        copied = torch.where(from_rep, rep, copied)
    total = upto[:, -1]
    out = torch.where(t < total[:, None], copied, torch.zeros_like(copied))
    return out, total


@dataclass(frozen=True, eq=False)
class RegexpExtract(Expression):
    """regexp_extract(str, pattern, idx): capture group of the first
    Java-greedy match; '' when there is no match (Spark semantics)."""

    child: Expression = None
    pattern: str = ""
    idx: int = 1

    def __post_init__(self):
        prog, reason = _try_compile_spans(self.pattern)
        if prog is not None and self.idx > prog.n_groups:
            prog, reason = None, (f"group {self.idx} > "
                                  f"{prog.n_groups} groups")
        object.__setattr__(self, "_prog", prog)
        object.__setattr__(self, "_reason", reason)

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return RegexpExtract(c[0], self.pattern, self.idx)

    @property
    def dtype(self):
        return self.child.dtype

    def device_unsupported_reason(self):
        return self._reason and f"regexp_extract: {self._reason}"

    def eval(self, batch, ctx=EvalContext()):
        if self._prog is None:
            raise RegexUnsupported(self._reason)
        c = self.child.eval(batch, ctx)
        data, lengths = extract_group_device(c, self._prog, self.idx)
        return _string_column(data, lengths, c.validity,
                              self.child.dtype.max_len)


@dataclass(frozen=True, eq=False)
class RegexpReplace(Expression):
    """regexp_replace(str, pattern, replacement): Java replaceAll with a
    LITERAL replacement ($n backrefs -> CPU fallback)."""

    child: Expression = None
    pattern: str = ""
    replacement: str = ""

    def __post_init__(self):
        prog, reason = _try_compile_spans(self.pattern)
        if "$" in self.replacement or "\\" in self.replacement:
            prog, reason = None, "replacement backrefs"
        try:
            self.replacement.encode("ascii")
        except UnicodeEncodeError:
            prog, reason = None, "non-ASCII replacement"
        object.__setattr__(self, "_prog", prog)
        object.__setattr__(self, "_reason", reason)

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return RegexpReplace(c[0], self.pattern, self.replacement)

    @property
    def dtype(self):
        ml = self.child.dtype.max_len
        return T.string(ml + len(self.replacement) * (ml + 1))

    def device_unsupported_reason(self):
        return self._reason and f"regexp_replace: {self._reason}"

    def eval(self, batch, ctx=EvalContext()):
        if self._prog is None:
            raise RegexUnsupported(self._reason)
        c = self.child.eval(batch, ctx)
        data, lengths = replace_all_device(c, self._prog,
                                           self.replacement.encode())
        return _string_column(data, lengths, c.validity,
                              self.dtype.max_len)


def split_device(col: DeviceColumn, prog: SpanProgram, limit: int,
                 max_elems: int):
    """Java ``String.split`` on the span program: (pieces ``uint8[n, me,
    ml]``, piece byte lengths ``int32[n, me]``, piece counts ``int32[n]``,
    overflow ``bool[n]``: rows with more pieces than the budget, whose
    count is clamped to it). Empty-matching patterns are refused when the
    expression is built."""
    n, ml = col.data.shape
    me = max_elems
    dev = col.data.device
    sel, endq = all_match_spans(col, prog)           # [n, ml + 1]
    isel = sel.to(torch.int32)
    if limit > 0:
        # only the first limit - 1 separators split
        sel = sel & (torch.cumsum(isel, dim=1) <= limit - 1)
        isel = sel.to(torch.int32)
    rank = torch.cumsum(isel, dim=1, dtype=torch.int32) - isel
    q_pos = torch.arange(ml + 1, dtype=torch.int32, device=dev)[None, :]
    # separator k's (start, end) into [n, me] tables; rank past me - 2
    # and unselected positions land in a dropped column
    slot = torch.where(sel & (rank < me - 1), rank, me).to(torch.int64)

    def table(values):
        out = torch.full((n, me + 1), ml + 1, dtype=torch.int32,
                         device=dev)
        return out.scatter_(1, slot, torch.where(sel, values, 0)
                            .to(torch.int32))[:, :me]

    starts = table(q_pos.expand(n, -1))
    ends = table(endq)
    n_sep_true = isel.sum(dim=1, dtype=torch.int32)
    n_sep = n_sep_true.clamp(max=me - 1)
    counts = n_sep + 1
    piece_start = torch.cat([torch.zeros((n, 1), dtype=torch.int32,
                                         device=dev), ends[:, :me - 1]],
                            dim=1)
    elem = torch.arange(me, dtype=torch.int32, device=dev)[None, :]
    piece_end = torch.where(elem < n_sep[:, None], starts,
                            col.lengths[:, None])
    plen = (piece_end - piece_start).clamp(min=0)
    plen = torch.where(elem < counts[:, None], plen, 0)
    byte = torch.arange(ml, dtype=torch.int64, device=dev)
    src = (piece_start.to(torch.int64)[:, :, None]
           + byte[None, None, :]).clamp(0, ml - 1)
    pieces = col.data.gather(1, src.reshape(n, me * ml)).reshape(n, me, ml)
    pieces = torch.where(byte[None, None, :] < plen[:, :, None], pieces, 0)
    return pieces, plen, counts, n_sep_true > (me - 1)


@dataclass(frozen=True, eq=False)
class StringSplit(Expression):
    """split(str, pattern, limit): ``array<string>``, on the device the
    3D byte tensor ``[cap, max_elems, max_len]`` with element lengths in
    ``data2``. ``limit == 0`` (trailing empties dropped) and
    empty-matching patterns run on the CPU. A row of more pieces than
    ``max_elems`` raises ``CAPACITY_split_max_elems`` in every mode: a
    consumer would otherwise read a truncated array."""

    child: Expression = None
    pattern: str = ""
    limit: int = -1
    max_elems: int = 16

    def __post_init__(self):
        prog, reason = _try_compile_spans(self.pattern)
        if prog is not None:
            # empty-matching separators hit Java's zero-width corner cases
            first = prog.suffixes[0]
            if bool(first.accepting[first.start_state]):
                prog, reason = None, "empty-matching split pattern"
        if self.limit == 0:
            prog, reason = None, "split limit 0 trims trailing empties"
        object.__setattr__(self, "_prog", prog)
        object.__setattr__(self, "_reason", reason)

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return StringSplit(c[0], self.pattern, self.limit, self.max_elems)

    @property
    def dtype(self):
        return T.array(self.child.dtype, self.max_elems)

    def device_unsupported_reason(self):
        return self._reason and f"split: {self._reason}"

    def eval(self, batch, ctx=EvalContext()):
        if self._prog is None:
            raise RegexUnsupported(self._reason)
        c = self.child.eval(batch, ctx)
        pieces, plen, counts, overflow = split_device(
            c, self._prog, self.limit, self.max_elems)
        ctx.report(overflow & c.validity, "CAPACITY_split_max_elems",
                   always=True)
        counts = torch.where(c.validity, counts, 0)
        return DeviceColumn(pieces, c.validity, self.dtype, counts,
                            data2=plen)
