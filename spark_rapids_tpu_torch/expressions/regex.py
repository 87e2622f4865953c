"""Regular expressions on the device: a plan-time DFA and a table-driven
scan over byte positions.

Port of ``RegexUnsupported``, the parser, ``CompiledRegex`` /
``compile_regex``, ``rlike_device``, ``RLike``, ``like_to_regex`` and
``Like`` of ``spark_rapids_tpu/expressions/regex.py`` (reference:
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
submachine, so counting characters holds over multi-byte text. The span
programs (regexp_extract, regexp_replace, split) come with a later slice
(ROADMAP item 7).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np
import torch

from .. import types as T
from ..batch import ColumnarBatch, DeviceColumn
from .base import EvalContext, Expression, numeric_column


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
    _on: Dict[torch.device, Tuple[torch.Tensor, ...]] = field(
        default_factory=dict, repr=False, compare=False)

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
