"""JSON expressions: get_json_object, from_json of a flat struct, and
json_tuple.

Port of ``spark_rapids_tpu/expressions/json.py`` (reference:
GpuOverrides.scala's GetJsonObject, GpuJsonToStructs.scala, where cudf's
JSON kernels do the work). The documents are the padded byte matrices of
a string column, parsed with vectorized masks, one path step at a time:

- escapes: the parity of the backslash run before each byte (a running
  max of the last non-backslash position, ``torch.cummax``);
- strings: the parity of the unescaped quotes before each byte;
- depth: the running sum of the braces and brackets outside strings;
- a field step: the window match of ``"key"`` (the hand-written
  ``window_match`` kernel on CUDA, at every pattern length), kept where
  its quote opens a string at depth 1 and the next non-blank byte is
  ``:``; the next non-blank byte at or after each position is a reversed
  running min (``torch.cummin``), where the JAX package builds both
  running extremes as shift ladders;
- the value: up to its closing quote, its matching bracket, or the next
  delimiter at its depth, moved to the row's start by a gather; then the
  escapes of a string value are decoded by a row-wise compaction.

The subset (the planner's notes gate the rest): literal ``$.a.b[i]`` and
``$['a.b']`` paths. A ``\\uXXXX`` escape in an extracted string nulls the
row, as on the JAX device (no device decoder); a nested value comes back
as its input span, blanks included, as on the JAX device, where the row
interpreter gives compact JSON (Jackson's output).
"""

from __future__ import annotations

import re as _re
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .. import types as T
from .base import EvalContext, Expression, Literal, lit
from .strings import _compact_bytes, _string_column, _window_match


class JsonPathUnsupported(ValueError):
    """A path outside the device subset (the planner's CPU signal)."""


_STEP_RE = _re.compile(r"\.([A-Za-z_][A-Za-z0-9_\- ]*)|\[(\d+)\]|\['([^']+)'\]")


def parse_json_path(path: str) -> List[Union[str, int]]:
    """The steps of a ``$``-rooted path: field names and array indices."""
    if not path.startswith("$"):
        raise JsonPathUnsupported(f"path must start with $: {path!r}")
    steps: List[Union[str, int]] = []
    i = 1
    while i < len(path):
        m = _STEP_RE.match(path, i)
        if not m:
            raise JsonPathUnsupported(f"unsupported path syntax: {path!r}")
        if m.group(1) is not None:
            steps.append(m.group(1))
        elif m.group(2) is not None:
            steps.append(int(m.group(2)))
        else:
            steps.append(m.group(3))
        i = m.end()
    return steps


_WS = b" \t\n\r"


def _is_ws(b: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(b.shape, dtype=torch.bool, device=b.device)
    for w in _WS:
        out = out | (b == w)
    return out


def _positions(data: torch.Tensor) -> torch.Tensor:
    return torch.arange(data.shape[1], dtype=torch.int32,
                        device=data.device)[None, :]


def _escaped(data: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Whether each byte follows an odd run of backslashes."""
    n = data.shape[0]
    idx = _positions(data)
    bs = (data == ord("\\")) & live
    last_nb = torch.cummax(torch.where(bs, -1, idx), dim=1).values
    prev_last = torch.cat([torch.full((n, 1), -1, dtype=last_nb.dtype,
                                      device=data.device),
                           last_nb[:, :-1]], dim=1)
    return ((idx - 1 - prev_last) % 2) == 1


def _scan_masks(data: torch.Tensor, lengths: torch.Tensor):
    """(escaped, unescaped quote, outside a string (true at an opening
    quote), strictly outside, depth, live) per byte."""
    idx = _positions(data)
    live = idx < lengths[:, None]
    escaped = _escaped(data, live)
    q = (data == ord('"')) & ~escaped & live
    qi = q.to(torch.int32)
    outside = ((qi.cumsum(dim=1, dtype=torch.int32) - qi) % 2) == 0
    content_outside = outside & ~q
    opens = content_outside & ((data == ord("{")) | (data == ord("[")))
    closes = content_outside & ((data == ord("}")) | (data == ord("]")))
    depth = (opens.to(torch.int32) - closes.to(torch.int32)).cumsum(
        dim=1, dtype=torch.int32)
    return escaped, q, outside, content_outside, depth, live


def _next_nonws_table(data: torch.Tensor) -> torch.Tensor:
    """t[row, i]: the least j >= i holding a non-blank byte (ml if
    none), exactly: a running min from the right."""
    ml = data.shape[1]
    x = torch.where(_is_ws(data), ml, _positions(data))
    return torch.cummin(x.flip(1), dim=1).values.flip(1)


def _first_true(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the first true position of each row, whether there is one)."""
    return (mask.to(torch.uint8).argmax(dim=1).to(torch.int32),
            mask.any(dim=1))


def _last_true(mask: torch.Tensor) -> torch.Tensor:
    ml = mask.shape[1]
    return (ml - 1) - mask.flip(1).to(torch.uint8).argmax(dim=1).to(
        torch.int32)


def _shift_left(data, start, count):
    """Each row's bytes [start, start + count) at the row's start."""
    ml = data.shape[1]
    idx = _positions(data)
    gidx = (idx + start[:, None]).clamp(0, ml - 1).to(torch.int64)
    out = data.gather(1, gidx)
    out = torch.where(idx < count[:, None], out, 0)
    return out, count.clamp(0, ml).to(torch.int32)


def _at(x: torch.Tensor, pos: torch.Tensor, fill) -> torch.Tensor:
    """x[row, pos[row, ...]], with a column of ``fill`` past the end."""
    n, ml = x.shape
    padded = F.pad(x, (0, 1), value=fill)
    pos = pos.clamp(0, ml).to(torch.int64).expand(n, -1)
    return padded.gather(1, pos)


def _extract_step(data, lengths, valid, step) -> Tuple:
    """One path step over the current JSON text: (data', lengths',
    valid', is_string_value)."""
    ml = data.shape[1]
    escaped, q, outside, content_outside, depth, live = _scan_masks(
        data, lengths)
    idx = _positions(data)

    if isinstance(step, int):
        # an array index: the elements of a root array split at its
        # depth-1 commas
        root_ok = valid & (lengths > 0) & (data[:, 0] == ord("["))
        commas = content_outside & (data == ord(",")) & (depth == 1)
        ci = commas.to(torch.int32)
        elem_id = ci.cumsum(dim=1, dtype=torch.int32) - ci
        mine = elem_id == step
        in_elem = (idx >= 1) & (idx < (lengths - 1)[:, None]) & mine \
            & ~(commas & mine)
        has = root_ok & in_elem.any(dim=1)
        start, _ = _first_true(in_elem)
        count = torch.where(has, _last_true(in_elem) - start + 1, 0)
        out, cnt = _shift_left(data, start, count)
        out, cnt = _trim_ws(out, cnt)
        return _finish_value(out, cnt, has & valid)

    # a field step: '"key"' opening a string at depth 1, then ':'
    pat = b'"' + step.encode("utf-8") + b'"'
    m = _window_match(data, lengths, pat)
    nnw = _next_nonws_table(data)
    pos = _at(nnw, idx + len(pat), ml)
    cand = m & q & outside & (depth == 1) & (_at(data, pos, 0) == ord(":"))
    first, has = _first_true(cand)
    vs = (pos.gather(1, first[:, None].to(torch.int64)) + 1)
    vs = _at(nnw, vs, ml)               # the blanks after the colon
    vchar = _at(data, vs, 0)[:, 0]
    vdepth = _at(depth, vs, 0)[:, 0]
    vs = vs[:, 0]
    valid = valid & has & (vs < lengths)
    is_str = vchar == ord('"')
    is_nest = (vchar == ord("{")) | (vchar == ord("["))
    after_vs = idx > vs[:, None]
    # a string: up to the next unescaped quote
    qpos, has_q = _first_true(q & after_vs)
    s_count = torch.where(has_q, qpos - (vs + 1), 0)
    # a nested value: up to the closer that leaves its depth
    closing = (data == ord("}")) | (data == ord("]"))
    cpos, has_c = _first_true(content_outside & after_vs & closing
                              & (depth == (vdepth - 1)[:, None]))
    n_count = torch.where(has_c, cpos - vs + 1, 0)
    # a scalar: up to the next delimiter at its depth
    delim = content_outside & after_vs & (
        ((data == ord(",")) & (depth == vdepth[:, None]))
        | (closing & (depth == (vdepth - 1)[:, None])))
    dpos, has_d = _first_true(delim)
    sc_count = torch.where(has_d, dpos - vs, lengths - vs)
    start = torch.where(is_str, vs + 1, vs)
    count = torch.where(is_str, s_count,
                        torch.where(is_nest, n_count, sc_count))
    valid = valid & (has_q | ~is_str)
    out, cnt = _shift_left(data, start, count)
    # blanks around a scalar or nested value go; a string's stay
    out2, cnt2 = _trim_ws(out, cnt)
    out = torch.where(is_str[:, None], out, out2)
    cnt = torch.where(is_str, cnt, cnt2)
    return _finish_value(out, cnt, valid, is_str)


def _trim_ws(data, lengths):
    idx = _positions(data)
    nonws = (idx < lengths[:, None]) & ~_is_ws(data)
    lead, any_ = _first_true(nonws)
    lead = torch.where(any_, lead, 0)
    count = torch.where(any_, _last_true(nonws) - lead + 1, 0)
    return _shift_left(data, lead, count)


def _finish_value(data, lengths, valid, is_str=None):
    """An unquoted ``null`` is a null; the string flag rides along for the
    escape decoding."""
    n, ml = data.shape
    if is_str is None:
        is_str = torch.zeros(n, dtype=torch.bool, device=data.device)
    nul = lengths == 4
    for j, ch in enumerate(b"null"):
        nul = nul & ((data[:, j] == ch) if j < ml else False)
    return data, lengths, valid & ~(nul & ~is_str), is_str


_ESCAPES = ((ord("n"), ord("\n")), (ord("t"), ord("\t")),
            (ord("r"), ord("\r")), (ord("b"), ord("\b")),
            (ord("f"), ord("\f")))


def _decode_escapes(data, lengths, is_str):
    """Decode \\" \\\\ \\/ \\b \\f \\n \\r \\t in string values; a row
    with a \\uXXXX escape is flagged (no device decoder)."""
    live = _positions(data) < lengths[:, None]
    escaped = _escaped(data, live)
    escaper = (data == ord("\\")) & live & ~escaped
    has_unicode = (escaped & (data == ord("u")) & live).any(dim=1) & is_str
    mapped = data
    for src, dst in _ESCAPES:
        mapped = torch.where(escaped & (data == src), dst, mapped).to(
            data.dtype)
    keep = live & ~(escaper & is_str[:, None])
    out, ln = _compact_bytes(torch.where(is_str[:, None], mapped, data),
                             keep)
    return out, ln, has_unicode


@dataclass(frozen=True, eq=False)
class GetJsonObject(Expression):
    """get_json_object(json, '$.path'): a literal path."""

    child: Expression
    path: Expression

    @property
    def children(self):
        return (self.child, self.path)

    def with_children(self, c):
        return GetJsonObject(c[0], c[1])

    def _steps(self):
        if not isinstance(self.path, Literal):
            raise JsonPathUnsupported("json path must be a literal")
        return parse_json_path(str(self.path.value))

    def device_unsupported_reason(self):
        try:
            self._steps()
        except JsonPathUnsupported as e:
            return str(e)
        return None

    @property
    def dtype(self):
        return T.string(self.child.dtype.max_len)

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        data, lengths, valid = c.data, c.lengths, c.validity
        is_str = torch.zeros(batch.capacity, dtype=torch.bool,
                             device=data.device)
        steps = self._steps()
        if not steps:
            # "$" is the document itself, trimmed
            data, lengths = _trim_ws(data, lengths)
        for step in steps:
            data, lengths, valid, is_str = _extract_step(
                data, lengths, valid, step)
        data, lengths, has_unicode = _decode_escapes(data, lengths, is_str)
        valid = valid & ~has_unicode
        return _string_column(data, lengths, valid, data.shape[1])


@dataclass(frozen=True, eq=False)
class JsonToStructs(Expression):
    """from_json of a FLAT struct of primitive fields. It runs on the
    device only under a ``GetStructField``, which binds to
    ``get_json_object`` plus a cast (the reference too reads only the
    projected fields); a struct result alone has no device storage: the
    CPU."""

    child: Optional[Expression] = None
    schema: Optional[T.SqlType] = None
    field_names: Tuple[str, ...] = ()

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return JsonToStructs(c[0], self.schema, self.field_names)

    @property
    def dtype(self):
        return self.schema

    def device_unsupported_reason(self):
        return ("from_json produces a struct column (no device storage); "
                "project individual fields so the planner can rewrite to "
                "get_json_object")

    def eval(self, batch, ctx=EvalContext()):
        raise JsonPathUnsupported("JsonToStructs has no direct device eval")


def json_tuple(e, *fields):
    """json_tuple(json, f1, ..., fk): k extraction columns c0..c{k-1}, each
    a top-level key lookup (reference: GpuJsonTuple, which also lowers to
    path extraction). Names go in brackets, so that a name with '.', '['
    or '*' stays one literal key, as in Spark's JsonTuple."""
    for f in fields:
        if "'" in f:
            raise ValueError(
                f"json_tuple field {f!r}: quote characters are outside "
                f"the supported path subset")
    return [GetJsonObject(e, lit(f"$['{f}']")).alias(f"c{i}")
            for i, f in enumerate(fields)]
