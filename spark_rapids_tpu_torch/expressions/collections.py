"""Array, struct and map expressions.

Port of the first half of ``spark_rapids_tpu/expressions/collections.py``
(reference: collectionOperations.scala, complexTypeExtractors.scala):
``CreateArray``, ``Size``, ``ArrayContains``, ``ElementAt`` /
``GetArrayItem``, ``SortArray``, ``ArrayMin`` / ``ArrayMax``,
``CreateStruct``, ``GetStructField``, ``MapKeys`` / ``MapValues``,
``GetMapValue``, ``MapContainsKey`` and ``MapFromArrays``. The lambdas and
higher-order functions, the set operations and ``ArrayRemove`` through
``ReplicateRows`` are the next slice (ROADMAP item 7).

The layout is the JAX package's fixed-budget matrix: ``data[cap,
max_elems]`` plus ``lengths[cap]`` (``batch.py``), so every operation is a
rectangular tensor operation over the element axis: element access is a
``gather`` along it, contains/min/max a masked row reduction, sort_array
one ``torch.sort`` along it. An ``array<string>`` is ``uint8[cap,
max_elems, max_len]`` with element byte lengths in ``data2``; a
``map<string,string>`` from ``StringToMap`` keeps zero-padded keys and
values, a null value marked by 0xFF in its first byte. Elements are never
null (the upload refuses them); ``PivotFirst``'s scalar arrays carry a
per-element validity in a bool ``data2``, which element access reads.

Where the JAX device departs from Spark over NaN, the port follows Spark,
as its comparisons and Min/Max do: ``sort_array`` orders NaN above every
value (last ascending, first descending), ``array_min`` skips NaN unless
every element is NaN, ``array_max`` is NaN if any element is, and
``array_contains`` finds NaN. The JAX device sorts a descending NaN past
the array's end and reduces with a NaN that wins both ways.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import types as T
from ..batch import DeviceColumn, Schema
from ..types import SqlType, TypeKind
from .base import EvalContext, Expression


class CollectionUnsupported(ValueError):
    """Array construct outside the device subset (CPU fallback signal)."""


def _require_array(e: Expression, who: str) -> SqlType:
    if e.dtype.kind is not TypeKind.ARRAY:
        raise TypeError(f"{who} expects an array, got {e.dtype}")
    return e.dtype.children[0]


def _scalar_elems_reason(e: Expression, who: str):
    """The reason of an operation with no kernel over string elements
    (only size, element access and explode read ``array<string>``)."""
    if e is not None and e.resolved and \
            e.dtype.kind is TypeKind.ARRAY and \
            e.dtype.children[0].kind is TypeKind.STRING:
        return f"{who} over array<string> has no device kernel"
    return None


def elem_mask(col: DeviceColumn) -> torch.Tensor:
    """bool[cap, me]: the slots that hold an element."""
    me = col.data.shape[1]
    slot = torch.arange(me, device=col.validity.device)
    return (slot[None, :] < col.lengths[:, None]) & col.validity[:, None]


def _widen_last(x: torch.Tensor, width: int) -> torch.Tensor:
    pad = width - x.shape[-1]
    return F.pad(x, (0, pad)) if pad > 0 else x


def _elem_equals_value(a: DeviceColumn, v: DeviceColumn) -> torch.Tensor:
    """bool[cap, me]: each element of ``a`` against the row's ``v``.
    String elements compare their width-aligned zero-padded bytes and
    their lengths; doubles equal when both are NaN (Spark's ordering
    equality)."""
    if a.data.dim() == 3:
        w = max(a.data.shape[2], v.data.shape[1])
        same = (_widen_last(a.data, w)
                == _widen_last(v.data, w)[:, None, :]).all(dim=2)
        return same & (a.data2 == v.lengths[:, None])
    eq = a.data == v.data[:, None]
    if a.data.is_floating_point():
        eq = eq | (torch.isnan(a.data) & torch.isnan(v.data)[:, None])
    return eq


def _strings_compatible(value_t: SqlType, elem_t: SqlType) -> bool:
    """Two string types differing only in their device width are one SQL
    type."""
    return value_t.kind is TypeKind.STRING and \
        elem_t.kind is TypeKind.STRING


def _ones(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones(n, dtype=torch.bool, device=like.device)


# ---------------------------------------------------------------------------
# Arrays
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class CreateArray(Expression):
    """array(e1, e2, ...): the children share a type; the result's budget
    is their count."""

    elems: Tuple[Expression, ...] = ()

    @property
    def children(self):
        return self.elems

    def with_children(self, c):
        return CreateArray(tuple(c))

    @property
    def dtype(self):
        if not self.elems:
            raise CollectionUnsupported("empty array() literal")
        t = self.elems[0].dtype
        for e in self.elems[1:]:
            if e.dtype != t:
                raise TypeError(f"array() element types differ: {t} vs "
                                f"{e.dtype}")
        return T.array(t, max(len(self.elems), 1))

    @property
    def nullable(self):
        return False

    def device_unsupported_reason(self):
        if self.elems and self.elems[0].resolved:
            if self.dtype.children[0].kind is TypeKind.STRING:
                return "array() over strings has no device layout"
            if any(e.nullable for e in self.elems):
                return ("array() with nullable elements: fixed-budget "
                        "arrays hold non-null elements only")
        return None

    def eval(self, batch, ctx=EvalContext()):
        cols = [e.eval(batch, ctx) for e in self.elems]
        if any(c.lengths is not None for c in cols):
            raise CollectionUnsupported("array() over strings")
        if any(e.nullable for e in self.elems):
            raise CollectionUnsupported("array() with nullable elements")
        data = torch.stack([c.data for c in cols], dim=1)
        cap, dev = batch.capacity, batch.device
        lengths = torch.full((cap,), len(cols), dtype=torch.int32,
                             device=dev)
        return DeviceColumn(data, _ones(cap, data), self.dtype, lengths)


@dataclass(frozen=True, eq=False)
class Size(Expression):
    """size(arr or map): the element count; size(null) = -1 (Spark's
    legacy default)."""

    child: Optional[Expression] = None

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return Size(c[0])

    @property
    def dtype(self):
        if self.child.dtype.kind not in (TypeKind.ARRAY, TypeKind.MAP):
            raise TypeError(f"size expects array/map, got {self.child.dtype}")
        return T.INT32

    @property
    def nullable(self):
        return False

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        data = torch.where(c.validity, c.lengths, -1).to(torch.int32)
        return DeviceColumn(data, _ones(batch.capacity, data), T.INT32)


@dataclass(frozen=True, eq=False)
class ArrayContains(Expression):
    """array_contains(arr, value): null iff arr or value is null."""

    arr: Optional[Expression] = None
    value: Optional[Expression] = None

    @property
    def children(self):
        return (self.arr, self.value)

    def with_children(self, c):
        return ArrayContains(c[0], c[1])

    @property
    def dtype(self):
        et = _require_array(self.arr, "array_contains")
        if self.value.dtype != et and \
                not _strings_compatible(self.value.dtype, et):
            raise TypeError(f"array_contains value {self.value.dtype} vs "
                            f"element {et}")
        return T.BOOLEAN

    def eval(self, batch, ctx=EvalContext()):
        a = self.arr.eval(batch, ctx)
        v = self.value.eval(batch, ctx)
        hit = (elem_mask(a) & _elem_equals_value(a, v)).any(dim=1)
        return DeviceColumn(hit, a.validity & v.validity, T.BOOLEAN)


@dataclass(frozen=True, eq=False)
class ElementAt(Expression):
    """element_at(arr, i): 1-based, negative from the end; out of bounds
    -> null."""

    arr: Optional[Expression] = None
    index: Optional[Expression] = None

    @property
    def children(self):
        return (self.arr, self.index)

    def with_children(self, c):
        return type(self)(c[0], c[1])   # GetArrayItem subclasses this

    @property
    def dtype(self):
        return _require_array(self.arr, "element_at")

    @property
    def nullable(self):
        return True     # out-of-bounds access yields null

    def _take_elem(self, a: DeviceColumn, pos: torch.Tensor,
                   ok: torch.Tensor) -> DeviceColumn:
        """The element at ``pos`` of each row: string elements from the
        3D byte tensor and ``data2``'s lengths, scalars from the matrix
        (and ``data2``'s per-element validity where it is bool)."""
        safe = pos.clamp(0, a.data.shape[1] - 1).to(torch.int64)
        if a.data.dim() == 3:
            ml = a.data.shape[2]
            data = a.data.gather(
                1, safe[:, None, None].expand(-1, 1, ml))[:, 0]
            lens = a.data2.gather(1, safe[:, None])[:, 0]
            lens = torch.where(ok, lens, 0)
            keep = (torch.arange(ml, device=data.device)[None, :]
                    < lens[:, None]) & ok[:, None]
            return DeviceColumn(torch.where(keep, data, 0), ok, self.dtype,
                                lens)
        data = a.data.gather(1, safe[:, None])[:, 0]
        if a.data2 is not None and a.data2.dtype == torch.bool:
            ok = ok & a.data2.gather(1, safe[:, None])[:, 0]
        return DeviceColumn(torch.where(ok, data, torch.zeros(
            (), dtype=data.dtype, device=data.device)), ok, self.dtype)

    def eval(self, batch, ctx=EvalContext()):
        a = self.arr.eval(batch, ctx)
        i = self.index.eval(batch, ctx)
        idx = i.data.to(torch.int32)
        n = a.lengths
        pos = torch.where(idx > 0, idx - 1, n + idx)    # 1-based / from end
        ok = a.validity & i.validity & (pos >= 0) & (pos < n)
        return self._take_elem(a, pos, ok)


@dataclass(frozen=True, eq=False)
class GetArrayItem(ElementAt):
    """arr[i]: Spark's 0-based subscript; out of bounds -> null."""

    def eval(self, batch, ctx=EvalContext()):
        a = self.arr.eval(batch, ctx)
        i = self.index.eval(batch, ctx)
        pos = i.data.to(torch.int32)
        ok = a.validity & i.validity & (pos >= 0) & (pos < a.lengths)
        return self._take_elem(a, pos, ok)


def _sorted_elems(a: DeviceColumn, descending: bool) -> torch.Tensor:
    """Each row's elements sorted along the element axis, dead slots last
    and zero. ``torch.sort`` orders NaN above every value, so NaN ends an
    ascending row and starts a descending one; a second stable sort moves
    the dead slots behind the live ones."""
    live = elem_mask(a)
    vals, idx = torch.sort(a.data, dim=1, descending=descending,
                           stable=True)
    dead_first = (~live.gather(1, idx)).to(torch.uint8)
    order = torch.sort(dead_first, dim=1, stable=True).indices
    s = vals.gather(1, order)
    return torch.where(live, s, torch.zeros((), dtype=s.dtype,
                                            device=s.device))


@dataclass(frozen=True, eq=False)
class SortArray(Expression):
    """sort_array(arr, asc): one sort along the element axis."""

    child: Optional[Expression] = None
    ascending: bool = True

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return SortArray(c[0], self.ascending)

    @property
    def dtype(self):
        _require_array(self.child, "sort_array")
        return self.child.dtype

    def device_unsupported_reason(self):
        return _scalar_elems_reason(self.child, "sort_array")

    def eval(self, batch, ctx=EvalContext()):
        a = self.child.eval(batch, ctx)
        return a.replace(data=_sorted_elems(a, not self.ascending))


class _MinMaxArray(Expression):
    _how = "amin"

    @property
    def children(self):
        return (self.child,)

    @property
    def dtype(self):
        return _require_array(self.child, type(self).__name__)

    @property
    def nullable(self):
        return True     # an empty array yields null

    def device_unsupported_reason(self):
        return _scalar_elems_reason(self.child, type(self).__name__)

    def eval(self, batch, ctx=EvalContext()):
        a = self.child.eval(batch, ctx)
        live = elem_mask(a)
        ok = a.validity & (a.lengths > 0)
        x = a.data
        if x.is_floating_point():
            # NaN ranks above every value: min skips it unless every
            # element is NaN, max is NaN if any element is
            nan = torch.isnan(x) & live
            num = live & ~nan
            if self._how == "amin":
                v = torch.where(num, x, float("inf")).amin(dim=1)
                v = torch.where(num.any(dim=1), v, float("nan"))
            else:
                v = torch.where(num, x, float("-inf")).amax(dim=1)
                v = torch.where(nan.any(dim=1), float("nan"), v)
        else:
            info = torch.iinfo(x.dtype)
            fill = info.max if self._how == "amin" else info.min
            v = getattr(torch.where(live, x, fill), self._how)(dim=1)
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        return DeviceColumn(torch.where(ok, v, zero), ok, self.dtype)


@dataclass(frozen=True, eq=False)
class ArrayMin(_MinMaxArray):
    child: Optional[Expression] = None
    _how = "amin"

    def with_children(self, c):
        return ArrayMin(c[0])


@dataclass(frozen=True, eq=False)
class ArrayMax(_MinMaxArray):
    child: Optional[Expression] = None
    _how = "amax"

    def with_children(self, c):
        return ArrayMax(c[0])


# ---------------------------------------------------------------------------
# Structs: one set of lanes per field (batch.py's struct layout)
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class CreateStruct(Expression):
    """named_struct(...): a struct column whose children are the element
    columns. ``GetStructField`` over a ``CreateStruct`` folds away at
    bind time."""

    elems: Tuple[Expression, ...] = ()
    names: Tuple[str, ...] = ()

    @property
    def children(self):
        return self.elems

    def with_children(self, c):
        return CreateStruct(tuple(c), self.names)

    @property
    def dtype(self):
        names = self.names or tuple(f"col{i + 1}"
                                    for i in range(len(self.elems)))
        return T.struct(*(e.dtype for e in self.elems), names=names)

    @property
    def nullable(self):
        return False      # Spark's CreateNamedStruct is never null itself

    def eval(self, batch, ctx=EvalContext()):
        kids = tuple(e.eval(batch, ctx) for e in self.elems)
        return DeviceColumn(kids, batch.row_mask(), self.dtype)


@dataclass(frozen=True, eq=False)
class GetStructField(Expression):
    """struct.field; folds to the child expression over a
    ``CreateStruct``. A field of a null struct is null."""

    child: Optional[Expression] = None
    ordinal: int = 0

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return GetStructField(c[0], self.ordinal)

    def bind(self, schema: Schema) -> Expression:
        bound = self.child.bind(schema)
        if isinstance(bound, CreateStruct):
            return bound.elems[self.ordinal]
        return GetStructField(bound, self.ordinal)

    @property
    def dtype(self):
        if self.child.dtype.kind is not TypeKind.STRUCT:
            raise TypeError(f"GetStructField over {self.child.dtype}")
        return self.child.dtype.children[self.ordinal]

    def eval(self, batch, ctx=EvalContext()):
        s = self.child.eval(batch, ctx)
        f = s.data[self.ordinal]
        return f.replace(validity=f.validity & s.validity)


# ---------------------------------------------------------------------------
# Maps: keys in ``data``, values in ``data2``, one ``lengths``
# ---------------------------------------------------------------------------

def _require_map(e: Expression, who: str):
    if e.dtype.kind is not TypeKind.MAP:
        raise TypeError(f"{who} expects a map, got {e.dtype}")
    return e.dtype.children


def _clear_null_marker(vals: torch.Tensor) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """``StringToMap``'s values with the 0xFF null marker cleared, and
    where it was."""
    null = vals[..., 0] == 0xFF
    first = torch.where(null, 0, vals[..., 0]).to(vals.dtype)
    return torch.cat([first.unsqueeze(-1), vals[..., 1:]], dim=-1), null


@dataclass(frozen=True, eq=False)
class MapKeys(Expression):
    """map_keys(m): the keys matrix is an array column as it stands."""

    child: Optional[Expression] = None

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return MapKeys(c[0])

    @property
    def dtype(self):
        k, _ = _require_map(self.child, "map_keys")
        return T.array(k, self.child.dtype.max_len)

    def eval(self, batch, ctx=EvalContext()):
        m = self.child.eval(batch, ctx)
        if m.data.dim() == 3:       # string keys: lengths from the padding
            from .strings import string_elem_lengths
            return DeviceColumn(m.data, m.validity, self.dtype, m.lengths,
                                data2=string_elem_lengths(m.data))
        return DeviceColumn(m.data, m.validity, self.dtype, m.lengths)


@dataclass(frozen=True, eq=False)
class MapValues(MapKeys):
    """map_values(m): the values matrix as an array column. A null string
    value (``StringToMap``'s marker) reads as "": the array layout has no
    per-element validity."""

    def with_children(self, c):
        return MapValues(c[0])

    @property
    def dtype(self):
        _, v = _require_map(self.child, "map_values")
        return T.array(v, self.child.dtype.max_len)

    def eval(self, batch, ctx=EvalContext()):
        m = self.child.eval(batch, ctx)
        if m.data2.dim() == 3:
            from .strings import string_elem_lengths
            d, _ = _clear_null_marker(m.data2)
            return DeviceColumn(d, m.validity, self.dtype, m.lengths,
                                data2=string_elem_lengths(d))
        return DeviceColumn(m.data2, m.validity, self.dtype, m.lengths)


def _string_elem_eq(elems3: torch.Tensor, probe: DeviceColumn
                    ) -> torch.Tensor:
    """[n, E] equality of zero-padded string elements with a probe string
    column (canonical padding: whole-row byte equality is string
    equality)."""
    ml = elems3.shape[-1]
    pml = probe.data.shape[1]
    p = _widen_last(probe.data, ml)[:, :ml]
    eq = (elems3 == p[:, None, :]).all(dim=2)
    if pml > ml:
        # a probe wider than the elements: equal only if its tail is empty
        eq = eq & (probe.data[:, ml:] == 0).all(dim=1)[:, None]
    return eq


def _key_hits(m: DeviceColumn, k: DeviceColumn) -> torch.Tensor:
    live = elem_mask(m)
    if m.data.dim() == 3:
        return live & _string_elem_eq(m.data, k)
    return live & (m.data == k.data[:, None])


@dataclass(frozen=True, eq=False)
class GetMapValue(Expression):
    """m[key] / element_at(m, key): the LAST matching entry wins (Spark's
    LAST_WIN read of duplicate keys); a missing key gives null."""

    map: Optional[Expression] = None
    key: Optional[Expression] = None

    @property
    def children(self):
        return (self.map, self.key)

    def with_children(self, c):
        return GetMapValue(c[0], c[1])

    @property
    def dtype(self):
        k, v = _require_map(self.map, "GetMapValue")
        if self.key.dtype != k and not _strings_compatible(self.key.dtype,
                                                           k):
            raise TypeError(f"map key {self.key.dtype} vs {k}")
        return v

    @property
    def nullable(self):
        return True     # a missing key yields null

    def eval(self, batch, ctx=EvalContext()):
        m = self.map.eval(batch, ctx)
        k = self.key.eval(batch, ctx)
        me = m.data.shape[1]
        hit = _key_hits(m, k)
        slot = torch.arange(me, dtype=torch.int32, device=hit.device)
        best = torch.where(hit, slot[None, :], -1).amax(dim=1)
        found = best >= 0
        safe = best.clamp(0, me - 1).to(torch.int64)
        ok = m.validity & k.validity & found
        if m.data.dim() == 3:
            from .strings import string_elem_lengths
            ml = m.data2.shape[2]
            row = m.data2.gather(
                1, safe[:, None, None].expand(-1, 1, ml))[:, 0]
            row, null_v = _clear_null_marker(row)
            ln = string_elem_lengths(row[:, None, :])[:, 0]
            ok = ok & ~null_v
            return DeviceColumn(torch.where(ok[:, None], row, 0), ok,
                                self.dtype, torch.where(ok, ln, 0))
        data = m.data2.gather(1, safe[:, None])[:, 0]
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        return DeviceColumn(torch.where(ok, data, zero), ok, self.dtype)


@dataclass(frozen=True, eq=False)
class MapContainsKey(Expression):
    """map_contains_key(m, key)."""

    map: Optional[Expression] = None
    key: Optional[Expression] = None

    @property
    def children(self):
        return (self.map, self.key)

    def with_children(self, c):
        return MapContainsKey(c[0], c[1])

    @property
    def dtype(self):
        _require_map(self.map, "map_contains_key")
        return T.BOOLEAN

    def eval(self, batch, ctx=EvalContext()):
        m = self.map.eval(batch, ctx)
        k = self.key.eval(batch, ctx)
        hit = _key_hits(m, k).any(dim=1)
        return DeviceColumn(hit, m.validity & k.validity, T.BOOLEAN)


@dataclass(frozen=True, eq=False)
class MapFromArrays(Expression):
    """map_from_arrays(keys, values). Spark's EXCEPTION policy for
    duplicate keys cannot raise per row inside a kernel: duplicates stay
    and reads resolve them LAST_WIN (``GetMapValue``). A length mismatch
    reports through the ANSI error channel and nulls the row."""

    keys: Optional[Expression] = None
    values: Optional[Expression] = None

    @property
    def children(self):
        return (self.keys, self.values)

    def with_children(self, c):
        return MapFromArrays(c[0], c[1])

    @property
    def dtype(self):
        kt = _require_array(self.keys, "map_from_arrays keys")
        vt = _require_array(self.values, "map_from_arrays values")
        return T.map_(kt, vt, max(self.keys.dtype.max_len,
                                  self.values.dtype.max_len))

    def eval(self, batch, ctx=EvalContext()):
        ka = self.keys.eval(batch, ctx)
        va = self.values.eval(batch, ctx)
        me = self.dtype.max_len

        def widen(x):
            pad = me - x.shape[1]
            return x if pad == 0 else F.pad(x, (0, pad))

        mismatch = ka.validity & va.validity & (ka.lengths != va.lengths)
        ctx.report(mismatch, "MAP_KEY_VALUE_LENGTH_MISMATCH")
        ok = ka.validity & va.validity & ~mismatch
        return DeviceColumn(widen(ka.data), ok, self.dtype,
                            torch.where(ok, ka.lengths, 0),
                            data2=widen(va.data))
