"""Array, struct and map expressions, and the higher-order functions.

Port of ``spark_rapids_tpu/expressions/collections.py`` (reference:
collectionOperations.scala, higherOrderFunctions.scala,
complexTypeExtractors.scala): array construction, access, sort and
min/max; structs (``GetStructField`` over ``from_json`` binds to
``get_json_object`` plus a cast, ``expressions/json.py``); maps; the
lambdas (``transform``, ``filter``, ``exists``, ``forall``,
``aggregate``, ``transform_keys``/``transform_values``, ``map_filter``,
``zip_with``), whose body evaluates once over the flattened ``cap x
max_elems`` element slots with the outer columns it reads gathered per
slot; the set operations over equality matrices; remove, position,
repeat, slice, sequence, flatten and ``replicaterows``.

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
``array_contains``, ``array_position``, ``array_remove`` and the set
operations count NaN as one value (SPARK-36702, SPARK-36741). The JAX
device sorts a descending NaN past the array's end, reduces with a NaN
that wins both ways and keeps every NaN apart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

import torch
import torch.nn.functional as F

from .. import types as T
from ..batch import ColumnarBatch, DeviceColumn, Schema, rows_scalar
from ..types import SqlType, TypeKind
from .base import (BoundReference, EvalContext, Expression, Literal,
                   numeric_column)


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
        from .json import GetJsonObject, JsonToStructs
        if isinstance(bound, JsonToStructs) and bound.field_names:
            # from_json(j, schema).f -> cast(get_json_object(j, '$.f')):
            # the reference too reads only the projected fields
            from .base import lit
            from .cast import Cast
            inner = GetJsonObject(bound.child,
                                  lit("$." + bound.field_names[self.ordinal]))
            ft = bound.schema.children[self.ordinal]
            return inner if ft.kind is TypeKind.STRING else Cast(inner, ft)
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


# ---------------------------------------------------------------------------
# Lambdas and higher-order functions
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class LambdaVariable(Expression):
    """A lambda's variable. The enclosing function puts its column in the
    cell just before the body evaluates and clears it after, so the body
    is one straight run of torch ops (a CUDA graph captures it as any
    other expression)."""

    name: str = "x"
    elem_type: Optional[SqlType] = None

    _cell: List = None   # type: ignore  # [DeviceColumn] set by the HOF

    def __post_init__(self):
        object.__setattr__(self, "_cell", [None])

    @property
    def resolved(self):
        return self.elem_type is not None

    @property
    def dtype(self):
        return self.elem_type

    @property
    def nullable(self):
        return False   # device arrays hold non-null elements only

    def eval(self, batch, ctx=EvalContext()):
        col = self._cell[0]
        assert col is not None, "LambdaVariable outside its HOF"
        return col


def hof_var(elem_type: SqlType, name: str = "x") -> LambdaVariable:
    return LambdaVariable(name, elem_type)


def _column_refs(e: Expression, out: Set[int]) -> Set[int]:
    """The input ordinals ``e`` reads, lambda bodies included (a body is
    not among its function's children)."""
    if isinstance(e, BoundReference):
        out.add(e.ordinal)
    for c in e.children:
        _column_refs(c, out)
    for b in getattr(e, "lambda_bodies", ()):
        _column_refs(b, out)
    return out


def _flat_elem_batch(batch: ColumnarBatch, live: torch.Tensor,
                     body: Expression) -> ColumnarBatch:
    """The batch expanded to one row per (row, element slot), for the
    body to read the outer columns at each element. Only the columns the
    body reads are gathered; every other column is a zero-stride
    placeholder of the new capacity that nothing reads. The JAX package
    gathers every column, which at cap x budget rows is the larger part
    of a wide batch."""
    from ..exec.common import gather_column
    cap, me = live.shape
    n = cap * me
    row = torch.arange(n, device=live.device) // me
    refs = _column_refs(body, set())
    hole = torch.zeros((), dtype=torch.bool, device=live.device).expand(n)
    cols = tuple(gather_column(c, row) if i in refs
                 else DeviceColumn(hole, hole, T.BOOLEAN)
                 for i, c in enumerate(batch.columns))
    return ColumnarBatch(cols, rows_scalar(n, live.device))


class _HofBase(Expression):
    """transform/filter/exists/forall: the body over the flattened
    element slots."""

    @property
    def children(self):
        return (self.arr,)

    @property
    def lambda_bodies(self):
        return (self.body,)

    def device_unsupported_reason(self):
        return _scalar_elems_reason(self.arr, type(self).__name__)

    def _check(self):
        et = _require_array(self.arr, type(self).__name__)
        if self.var.elem_type != et:
            raise TypeError(f"lambda var {self.var.elem_type} vs element "
                            f"{et}")
        return et

    def _eval_body(self, batch, ctx):
        a = self.arr.eval(batch, ctx)
        live = elem_mask(a)
        flat = _flat_elem_batch(batch, live, self.body)
        self.var._cell[0] = DeviceColumn(a.data.reshape(-1),
                                         live.reshape(-1),
                                         a.dtype.children[0])
        try:
            out = self.body.eval(flat, ctx)
        finally:
            self.var._cell[0] = None
        return a, out, live


@dataclass(frozen=True, eq=False)
class TransformArray(_HofBase):
    """transform(arr, x -> body): element-wise map. The body must be
    provably non-null over non-null inputs (a nullable body: the CPU)."""

    arr: Optional[Expression] = None
    var: Optional[LambdaVariable] = None
    body: Optional[Expression] = None

    def with_children(self, c):
        return TransformArray(c[0], self.var, self.body)

    def bind(self, schema):
        bound = TransformArray(self.arr.bind(schema), self.var,
                               self.body.bind(schema))
        bound._check()
        return bound

    def device_unsupported_reason(self):
        if self.body.resolved and self.body.nullable:
            return ("transform body may produce null elements; "
                    "fixed-budget arrays cannot store them")
        return None

    @property
    def dtype(self):
        return T.array(self.body.dtype, self.arr.dtype.max_len)

    @property
    def nullable(self):
        return self.arr.nullable

    def eval(self, batch, ctx=EvalContext()):
        a, out, live = self._eval_body(batch, ctx)
        data = out.data.reshape(live.shape)
        data = torch.where(live, data, torch.zeros(
            (), dtype=data.dtype, device=data.device))
        return DeviceColumn(data, a.validity, self.dtype, a.lengths)


@dataclass(frozen=True, eq=False)
class FilterArray(_HofBase):
    """filter(arr, x -> pred): the kept elements of each row, in order
    (one row-wise compaction)."""

    arr: Optional[Expression] = None
    var: Optional[LambdaVariable] = None
    body: Optional[Expression] = None

    def with_children(self, c):
        return FilterArray(c[0], self.var, self.body)

    def bind(self, schema):
        bound = FilterArray(self.arr.bind(schema), self.var,
                            self.body.bind(schema))
        bound._check()
        if bound.body.dtype.kind is not TypeKind.BOOLEAN:
            raise TypeError("filter predicate must be boolean")
        return bound

    @property
    def dtype(self):
        return self.arr.dtype

    @property
    def nullable(self):
        return self.arr.nullable

    def eval(self, batch, ctx=EvalContext()):
        a, out, live = self._eval_body(batch, ctx)
        keep = live & (out.data & out.validity).reshape(live.shape)
        data, n = _compact_elems(a.data, keep)
        return DeviceColumn(data, a.validity, self.dtype, n)


@dataclass(frozen=True, eq=False)
class ExistsArray(_HofBase):
    """exists(arr, x -> pred)."""

    arr: Optional[Expression] = None
    var: Optional[LambdaVariable] = None
    body: Optional[Expression] = None
    _forall = False

    def with_children(self, c):
        return type(self)(c[0], self.var, self.body)

    def bind(self, schema):
        bound = type(self)(self.arr.bind(schema), self.var,
                           self.body.bind(schema))
        bound._check()
        return bound

    @property
    def dtype(self):
        return T.BOOLEAN

    @property
    def nullable(self):
        return self.arr.nullable

    def eval(self, batch, ctx=EvalContext()):
        a, out, live = self._eval_body(batch, ctx)
        hit = live & (out.data & out.validity).reshape(live.shape)
        if self._forall:
            v = (~live | hit).all(dim=1)
        else:
            v = hit.any(dim=1)
        return DeviceColumn(v, a.validity, T.BOOLEAN)


@dataclass(frozen=True, eq=False)
class ForallArray(ExistsArray):
    """forall(arr, x -> pred)."""

    arr: Optional[Expression] = None
    var: Optional[LambdaVariable] = None
    body: Optional[Expression] = None
    _forall = True


@dataclass(frozen=True, eq=False)
class AggregateArray(Expression):
    """aggregate(arr, zero, (acc, x) -> merge): a left fold, unrolled over
    the element budget (at most 64 on the device)."""

    arr: Optional[Expression] = None
    zero: Optional[Expression] = None
    acc_var: Optional[LambdaVariable] = None
    elem_var: Optional[LambdaVariable] = None
    merge: Optional[Expression] = None

    @property
    def children(self):
        return (self.arr, self.zero)

    @property
    def lambda_bodies(self):
        return (self.merge,)

    def with_children(self, c):
        return AggregateArray(c[0], c[1], self.acc_var, self.elem_var,
                              self.merge)

    def bind(self, schema):
        bound = AggregateArray(self.arr.bind(schema), self.zero.bind(schema),
                               self.acc_var, self.elem_var,
                               self.merge.bind(schema))
        _require_array(bound.arr, "aggregate")
        return bound

    def device_unsupported_reason(self):
        me = self.arr.dtype.max_len if self.arr.resolved else 0
        if me > 64:
            return f"aggregate() unrolls the element budget; {me} > 64"
        return None

    @property
    def dtype(self):
        return self.zero.dtype

    @property
    def nullable(self):
        return True

    def eval(self, batch, ctx=EvalContext()):
        a = self.arr.eval(batch, ctx)
        acc = self.zero.eval(batch, ctx)
        live = elem_mask(a)
        et = a.dtype.children[0]
        for j in range(a.data.shape[1]):
            self.acc_var._cell[0] = acc
            self.elem_var._cell[0] = DeviceColumn(a.data[:, j], live[:, j],
                                                  et)
            try:
                step = self.merge.eval(batch, ctx)
            finally:
                self.acc_var._cell[0] = None
                self.elem_var._cell[0] = None
            on = live[:, j]
            acc = DeviceColumn(torch.where(on, step.data, acc.data),
                               torch.where(on, step.validity, acc.validity),
                               acc.dtype)
        return DeviceColumn(acc.data, acc.validity & a.validity, self.dtype)


# ---------------------------------------------------------------------------
# Set operations (scalar elements, equality matrices). Over doubles NaN
# equals NaN, as in Spark 3.3 and later (SPARK-36702, SPARK-36741); the
# JAX device's == keeps every NaN apart.
# ---------------------------------------------------------------------------

def _same(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    eq = x == y
    if x.is_floating_point():
        eq = eq | (torch.isnan(x) & torch.isnan(y))
    return eq


def _slots_below(n: torch.Tensor, me: int) -> torch.Tensor:
    return torch.arange(me, device=n.device)[None, :] < n[:, None]


def _elem_eq_matrix(a: DeviceColumn, b: DeviceColumn, la: torch.Tensor,
                    lb: torch.Tensor) -> torch.Tensor:
    """eq[row, i, j]: a's element i equals b's element j, both live."""
    eq = _same(a.data[:, :, None], b.data[:, None, :])
    return eq & _slots_below(la, a.data.shape[1])[:, :, None] \
        & _slots_below(lb, b.data.shape[1])[:, None, :]


def _compact_elems(data: torch.Tensor, keep: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kept elements of each row left-packed in order, and their
    count (the string compaction's row-wise searchsorted gather)."""
    from .strings import _compact_bytes
    return _compact_bytes(data, keep)


def _first_occurrence(data: torch.Tensor, live: torch.Tensor
                      ) -> torch.Tensor:
    """keep[row, i]: element i is live and no earlier live one equals
    it."""
    me = data.shape[1]
    eq = _same(data[:, :, None], data[:, None, :]) \
        & live[:, :, None] & live[:, None, :]
    earlier = torch.ones((me, me), dtype=torch.bool,
                         device=data.device).tril(-1)
    return live & ~(eq & earlier).any(dim=2)


class _ArraySetBase(Expression):
    """Binary array operations over scalar elements."""

    @property
    def children(self):
        return (self.left, self.right)

    def device_unsupported_reason(self):
        return (_scalar_elems_reason(self.left, type(self).__name__)
                or _scalar_elems_reason(self.right, type(self).__name__))

    def _eval_sides(self, batch, ctx):
        a = self.left.eval(batch, ctx)
        b = self.right.eval(batch, ctx)
        la = torch.where(a.validity, a.lengths, 0)
        lb = torch.where(b.validity, b.lengths, 0)
        return a, b, la, lb


def _array_of(data, n, validity, dtype) -> DeviceColumn:
    return DeviceColumn(data, validity, dtype, torch.where(validity, n, 0))


@dataclass(frozen=True, eq=False)
class ArrayDistinct(Expression):
    """array_distinct(a): first occurrences, in order (Spark)."""

    child: Optional[Expression] = None

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return ArrayDistinct(c[0])

    def device_unsupported_reason(self):
        return _scalar_elems_reason(self.child, "array_distinct")

    @property
    def dtype(self):
        _require_array(self.child, "array_distinct")
        return self.child.dtype

    def eval(self, batch, ctx=EvalContext()):
        a = self.child.eval(batch, ctx)
        live = _slots_below(a.lengths, a.data.shape[1])
        out, n = _compact_elems(a.data, _first_occurrence(a.data, live))
        return _array_of(out, n, a.validity, self.dtype)


@dataclass(frozen=True, eq=False)
class ArrayUnion(_ArraySetBase):
    """array_union(a, b): the distinct elements of a then b, first
    occurrences in order."""

    left: Optional[Expression] = None
    right: Optional[Expression] = None

    def with_children(self, c):
        return ArrayUnion(c[0], c[1])

    @property
    def dtype(self):
        et = _require_array(self.left, "array_union")
        _require_array(self.right, "array_union")
        return T.array(et, self.left.dtype.max_len
                       + self.right.dtype.max_len)

    @property
    def nullable(self):
        return self.left.nullable or self.right.nullable

    def eval(self, batch, ctx=EvalContext()):
        a, b, la, lb = self._eval_sides(batch, ctx)
        both = torch.cat([a.data, b.data.to(a.data.dtype)], dim=1)
        live = torch.cat([_slots_below(la, a.data.shape[1]),
                          _slots_below(lb, b.data.shape[1])], dim=1)
        packed, total = _compact_elems(both, live)
        keep = _first_occurrence(packed,
                                 _slots_below(total, packed.shape[1]))
        out, n = _compact_elems(packed, keep)
        return _array_of(out, n, a.validity & b.validity, self.dtype)


@dataclass(frozen=True, eq=False)
class ArrayIntersect(_ArraySetBase):
    """array_intersect(a, b): the distinct elements of a found in b."""

    left: Optional[Expression] = None
    right: Optional[Expression] = None
    _in_b = True

    def with_children(self, c):
        return type(self)(c[0], c[1])

    @property
    def dtype(self):
        _require_array(self.right, type(self).__name__)
        return self.left.dtype

    @property
    def nullable(self):
        return self.left.nullable or self.right.nullable

    def eval(self, batch, ctx=EvalContext()):
        a, b, la, lb = self._eval_sides(batch, ctx)
        live = _slots_below(la, a.data.shape[1])
        in_b = _elem_eq_matrix(a, b, la, lb).any(dim=2)
        keep = _first_occurrence(a.data, live) & (in_b if self._in_b
                                                  else ~in_b)
        out, n = _compact_elems(a.data, keep)
        return _array_of(out, n, a.validity & b.validity, self.dtype)


@dataclass(frozen=True, eq=False)
class ArrayExcept(ArrayIntersect):
    """array_except(a, b): the distinct elements of a not in b."""

    _in_b = False


@dataclass(frozen=True, eq=False)
class ArraysOverlap(_ArraySetBase):
    """arrays_overlap(a, b): whether any element is common."""

    left: Optional[Expression] = None
    right: Optional[Expression] = None

    def with_children(self, c):
        return ArraysOverlap(c[0], c[1])

    @property
    def dtype(self):
        return T.BOOLEAN

    def eval(self, batch, ctx=EvalContext()):
        a, b, la, lb = self._eval_sides(batch, ctx)
        common = _elem_eq_matrix(a, b, la, lb).flatten(1).any(dim=1)
        return numeric_column(common, a.validity & b.validity, T.BOOLEAN)


# ---------------------------------------------------------------------------
# Shaping: remove, position, repeat, slice, sequence, flatten
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class ArrayRemove(Expression):
    """array_remove(a, v): every element equal to v dropped."""

    child: Optional[Expression] = None
    value: Optional[Expression] = None

    @property
    def children(self):
        return (self.child, self.value)

    def with_children(self, c):
        return ArrayRemove(c[0], c[1])

    @property
    def dtype(self):
        return self.child.dtype

    def eval(self, batch, ctx=EvalContext()):
        a = self.child.eval(batch, ctx)
        v = self.value.eval(batch, ctx)
        me = a.data.shape[1]
        keep = _slots_below(a.lengths, me) & ~_elem_equals_value(a, v)
        validity = a.validity & v.validity
        if a.data.dim() == 3:
            # string elements: move whole elements and their lengths
            from .strings import _compact_index
            src, n = _compact_index(keep)
            src = src.to(torch.int64)
            live = _slots_below(n, me)
            ml = a.data.shape[2]
            data = a.data.gather(1, src[:, :, None].expand(-1, -1, ml))
            data = torch.where(live[:, :, None], data, 0)
            lens = torch.where(live, a.data2.gather(1, src), 0)
            return DeviceColumn(data, validity, self.dtype,
                                torch.where(validity, n, 0), data2=lens)
        out, n = _compact_elems(a.data, keep)
        return _array_of(out, n, validity, self.dtype)


@dataclass(frozen=True, eq=False)
class ArrayPosition(Expression):
    """array_position(a, v): the 1-based index of the first equal element,
    0 where there is none (bigint)."""

    child: Optional[Expression] = None
    value: Optional[Expression] = None

    @property
    def children(self):
        return (self.child, self.value)

    def with_children(self, c):
        return ArrayPosition(c[0], c[1])

    @property
    def dtype(self):
        return T.INT64

    def eval(self, batch, ctx=EvalContext()):
        a = self.child.eval(batch, ctx)
        v = self.value.eval(batch, ctx)
        hit = _slots_below(a.lengths, a.data.shape[1]) \
            & _elem_equals_value(a, v)
        first = hit.to(torch.uint8).argmax(dim=1) + 1
        pos = torch.where(hit.any(dim=1), first, 0)
        return numeric_column(pos, a.validity & v.validity, T.INT64)


@dataclass(frozen=True, eq=False)
class ArrayRepeat(Expression):
    """array_repeat(v, n): a LITERAL count (it is the static budget)."""

    value: Optional[Expression] = None
    count: Optional[Expression] = None

    @property
    def children(self):
        return (self.value, self.count)

    def with_children(self, c):
        return ArrayRepeat(c[0], c[1])

    def _n(self) -> int:
        if not isinstance(self.count, Literal):
            raise CollectionUnsupported(
                "array_repeat count must be a literal (static budget)")
        return max(int(self.count.value), 0)

    def device_unsupported_reason(self):
        if not isinstance(self.count, Literal):
            return "array_repeat with non-literal count has no static budget"
        if self.value is not None and self.value.resolved and \
                self.value.dtype.kind is TypeKind.STRING:
            return "array_repeat over strings has no device kernel"
        return None

    @property
    def dtype(self):
        return T.array(self.value.dtype, max(self._n(), 1))

    def eval(self, batch, ctx=EvalContext()):
        v = self.value.eval(batch, ctx)
        n = self._n()
        data = v.data[:, None].expand(-1, max(n, 1)).contiguous()
        ln = torch.full((batch.capacity,), n, dtype=torch.int32,
                        device=data.device)
        return _array_of(data, ln, v.validity, self.dtype)


@dataclass(frozen=True, eq=False)
class ArraySlice(Expression):
    """slice(a, start, length): a 1-based start, negative from the end.
    A start of 0 or a negative length fails in every mode, as in Spark."""

    child: Optional[Expression] = None
    start: Optional[Expression] = None
    length: Optional[Expression] = None

    @property
    def children(self):
        return (self.child, self.start, self.length)

    def with_children(self, c):
        return ArraySlice(c[0], c[1], c[2])

    @property
    def dtype(self):
        return self.child.dtype

    def eval(self, batch, ctx=EvalContext()):
        a = self.child.eval(batch, ctx)
        s = self.start.eval(batch, ctx)
        ln = self.length.eval(batch, ctx)
        me = a.data.shape[1]
        st = s.data.to(torch.int32)
        want = ln.data.to(torch.int32)
        validity = a.validity & s.validity & ln.validity
        ctx.report(validity & (st == 0), "SLICE_START_ZERO", always=True)
        ctx.report(validity & (want < 0), "SLICE_NEGATIVE_LENGTH",
                   always=True)
        begin = torch.where(st > 0, st - 1, a.lengths + st)
        take = torch.where(
            begin >= 0,
            torch.minimum(want.clamp(0, me), a.lengths - begin).clamp(0, me),
            0)
        slot = torch.arange(me, device=a.data.device)[None, :]
        idx = (slot + begin.clamp(0, me - 1)[:, None]).clamp(max=me - 1)
        data = a.data.gather(1, idx.to(torch.int64))
        data = torch.where(slot < take[:, None], data, 0)
        return _array_of(data, take, validity, self.dtype)


@dataclass(frozen=True, eq=False)
class Sequence(Expression):
    """sequence(start, stop[, step]) over integers. A row that needs more
    than ``max_elems`` slots fails in every mode
    (``CAPACITY_sequence_max_elems``); a step against the direction gives
    an empty array and a step of 0 null, as on the JAX device (Spark
    raises for both)."""

    start: Optional[Expression] = None
    stop: Optional[Expression] = None
    step: Optional[Expression] = None
    max_elems: int = 256

    @property
    def children(self):
        return (self.start, self.stop) + \
            ((self.step,) if self.step is not None else ())

    def with_children(self, c):
        return Sequence(c[0], c[1], c[2] if len(c) > 2 else None,
                        self.max_elems)

    @property
    def dtype(self):
        return T.array(self.start.dtype, self.max_elems)

    def eval(self, batch, ctx=EvalContext()):
        a = self.start.eval(batch, ctx)
        b = self.stop.eval(batch, ctx)
        lo = a.data.to(torch.int64)
        hi = b.data.to(torch.int64)
        if self.step is not None:
            st = self.step.eval(batch, ctx)
            step, sv = st.data.to(torch.int64), st.validity
        else:
            step = torch.where(hi >= lo, 1, -1)
            sv = _ones(batch.capacity, lo)
        ok_dir = torch.where(step > 0, hi >= lo,
                             torch.where(step < 0, hi <= lo, False))
        safe = torch.where(step == 0, 1, step)
        count = torch.where(ok_dir, torch.div(hi - lo, safe,
                                              rounding_mode="floor") + 1, 0)
        validity = a.validity & b.validity & sv & (step != 0)
        me = self.max_elems
        ctx.report(validity & (count > me), "CAPACITY_sequence_max_elems",
                   always=True)
        n = count.clamp(0, me).to(torch.int32)
        vals = lo[:, None] + torch.arange(me, device=lo.device)[None, :] \
            * step[:, None]
        data = torch.where(_slots_below(n, me), vals, 0).to(a.data.dtype)
        return _array_of(data, n, validity, self.dtype)


@dataclass(frozen=True, eq=False)
class Flatten(Expression):
    """flatten(array(a1, a2, ...)): the device lowers only this form (an
    array-of-arrays column has no device layout; anything else is a CPU
    island)."""

    child: Optional[Expression] = None

    @property
    def children(self):
        # over array(a, b, ...) the arrays themselves: the array of them is
        # never stored, so tagging types (and gates) a and b, where the
        # JAX check types the array of arrays and refuses the one form
        # this expression lowers
        if isinstance(self.child, CreateArray):
            return self.child.elems
        return (self.child,)

    def with_children(self, c):
        if isinstance(self.child, CreateArray):
            return Flatten(CreateArray(tuple(c)))
        return Flatten(c[0])

    def bind(self, schema):
        return Flatten(self.child.bind(schema))

    def device_unsupported_reason(self):
        if not isinstance(self.child, CreateArray):
            return ("flatten over a nested-array column has no device "
                    "layout (only flatten(array(...)) lowers)")
        return None

    @property
    def dtype(self):
        if isinstance(self.child, CreateArray):
            inner = [e.dtype for e in self.child.elems]
            return T.array(inner[0].children[0],
                           max(sum(t.max_len for t in inner), 1))
        return self.child.dtype.children[0]

    def eval(self, batch, ctx=EvalContext()):
        if not isinstance(self.child, CreateArray):
            raise CollectionUnsupported("flatten needs CreateArray input")
        arrs = [e.eval(batch, ctx) for e in self.child.elems]
        data = torch.cat([x.data for x in arrs], dim=1)
        live = torch.cat([_slots_below(x.lengths, x.data.shape[1])
                          for x in arrs], dim=1)
        out, n = _compact_elems(data, live)
        validity = batch.row_mask()
        for x in arrs:
            validity = validity & x.validity
        return _array_of(out, n, validity, self.dtype)


# ---------------------------------------------------------------------------
# Map higher-order functions and zip_with (two-variable lambdas over the
# keys/values matrices). The JAX row interpreter has none of them, so
# tagging never sends one to the CPU: a refused one raises there.
# ---------------------------------------------------------------------------

class _MapHofBase(Expression):
    @property
    def children(self):
        return (self.m,)

    @property
    def lambda_bodies(self):
        return (self.body,)

    def _check(self):
        kt, vt = _require_map(self.m, type(self).__name__)
        if self.kvar.elem_type != kt or self.vvar.elem_type != vt:
            raise TypeError("lambda variable types must match map entry "
                            f"types ({kt}, {vt})")
        return kt, vt

    def _eval_body(self, batch, ctx):
        m = self.m.eval(batch, ctx)
        live = elem_mask(m)
        flat = _flat_elem_batch(batch, live, self.body)
        kt, vt = _require_map(self.m, type(self).__name__)
        flat_live = live.reshape(-1)
        self.kvar._cell[0] = DeviceColumn(m.data.reshape(-1), flat_live, kt)
        self.vvar._cell[0] = DeviceColumn(m.data2.reshape(-1), flat_live,
                                          vt)
        try:
            out = self.body.eval(flat, ctx)
        finally:
            self.kvar._cell[0] = None
            self.vvar._cell[0] = None
        return m, out, live


@dataclass(frozen=True, eq=False)
class TransformKeys(_MapHofBase):
    """transform_keys(m, (k, v) -> body)."""

    m: Optional[Expression] = None
    kvar: Optional[LambdaVariable] = None
    vvar: Optional[LambdaVariable] = None
    body: Optional[Expression] = None

    def with_children(self, c):
        return type(self)(c[0], self.kvar, self.vvar, self.body)

    def bind(self, schema):
        b = type(self)(self.m.bind(schema), self.kvar, self.vvar,
                       self.body.bind(schema))
        b._check()
        return b

    def device_unsupported_reason(self):
        if self.body.resolved and self.body.nullable:
            return "map HOF body may produce nulls (no device storage)"
        return None

    @property
    def dtype(self):
        _, vt = _require_map(self.m, "transform_keys")
        return T.map_(self.body.dtype, vt, self.m.dtype.max_len)

    @property
    def nullable(self):
        return self.m.nullable

    def _entries(self, batch, ctx):
        m, out, live = self._eval_body(batch, ctx)
        new = out.data.reshape(live.shape)
        return m, torch.where(live, new, torch.zeros(
            (), dtype=new.dtype, device=new.device))

    def eval(self, batch, ctx=EvalContext()):
        m, keys = self._entries(batch, ctx)
        return DeviceColumn(keys, m.validity, self.dtype, m.lengths,
                            data2=m.data2)


@dataclass(frozen=True, eq=False)
class TransformValues(TransformKeys):
    """transform_values(m, (k, v) -> body)."""

    @property
    def dtype(self):
        kt, _ = _require_map(self.m, "transform_values")
        return T.map_(kt, self.body.dtype, self.m.dtype.max_len)

    def eval(self, batch, ctx=EvalContext()):
        m, vals = self._entries(batch, ctx)
        return DeviceColumn(m.data, m.validity, self.dtype, m.lengths,
                            data2=vals)


@dataclass(frozen=True, eq=False)
class MapFilter(TransformKeys):
    """map_filter(m, (k, v) -> pred): the entries where pred holds."""

    def bind(self, schema):
        b = super().bind(schema)
        if b.body.dtype.kind is not TypeKind.BOOLEAN:
            raise TypeError("map_filter predicate must be boolean")
        return b

    def device_unsupported_reason(self):
        return None     # dropping entries is always storable

    @property
    def dtype(self):
        return self.m.dtype

    def eval(self, batch, ctx=EvalContext()):
        m, out, live = self._eval_body(batch, ctx)
        keep = live & (out.data & out.validity).reshape(live.shape)
        keys, n = _compact_elems(m.data, keep)
        vals, _ = _compact_elems(m.data2, keep)
        return DeviceColumn(keys, m.validity, self.dtype,
                            torch.where(m.validity, n, 0), data2=vals)


@dataclass(frozen=True, eq=False)
class ZipWith(Expression):
    """zip_with(a, b, (x, y) -> body). The result has max(len(a),
    len(b)) elements, the shorter side's variable null past its end, so
    the body must be provably non-null over nullable inputs (coalesce-
    style bodies); a live slot whose body is null fails in every mode
    (``CAPACITY_zip_with_null_element``)."""

    left: Optional[Expression] = None
    right: Optional[Expression] = None
    xvar: Optional[LambdaVariable] = None
    yvar: Optional[LambdaVariable] = None
    body: Optional[Expression] = None

    @property
    def children(self):
        return (self.left, self.right)

    @property
    def lambda_bodies(self):
        return (self.body,)

    def with_children(self, c):
        return ZipWith(c[0], c[1], self.xvar, self.yvar, self.body)

    def bind(self, schema):
        b = ZipWith(self.left.bind(schema), self.right.bind(schema),
                    self.xvar, self.yvar, self.body.bind(schema))
        _require_array(b.left, "zip_with")
        _require_array(b.right, "zip_with")
        return b

    def device_unsupported_reason(self):
        r = (_scalar_elems_reason(self.left, "zip_with")
             or _scalar_elems_reason(self.right, "zip_with"))
        if r:
            return r
        if self.body.resolved and self.body.nullable:
            return ("zip_with body may produce null elements over the "
                    "shorter side's padding (no device storage)")
        return None

    @property
    def dtype(self):
        me = max(self.left.dtype.max_len, self.right.dtype.max_len)
        return T.array(self.body.dtype, me)

    @property
    def nullable(self):
        return self.left.nullable or self.right.nullable

    def eval(self, batch, ctx=EvalContext()):
        a = self.left.eval(batch, ctx)
        b = self.right.eval(batch, ctx)
        me = max(a.data.shape[1], b.data.shape[1])
        live_a = _slots_below(a.lengths, me)
        live_b = _slots_below(b.lengths, me)
        validity = a.validity & b.validity
        live = (live_a | live_b) & validity[:, None]
        flat = _flat_elem_batch(batch, live, self.body)
        self.xvar._cell[0] = DeviceColumn(
            _widen_last(a.data, me).reshape(-1), (live_a & live).reshape(-1),
            self.left.dtype.children[0])
        self.yvar._cell[0] = DeviceColumn(
            _widen_last(b.data, me).reshape(-1), (live_b & live).reshape(-1),
            self.right.dtype.children[0])
        try:
            out = self.body.eval(flat, ctx)
        finally:
            self.xvar._cell[0] = None
            self.yvar._cell[0] = None
        ok = out.validity.reshape(live.shape)
        ctx.report((live & ~ok).any(dim=1) & validity,
                   "CAPACITY_zip_with_null_element", always=True)
        data = out.data.reshape(live.shape)
        data = torch.where(live, data, torch.zeros(
            (), dtype=data.dtype, device=data.device))
        return _array_of(data, torch.maximum(a.lengths, b.lengths),
                         validity, self.dtype)


@dataclass(frozen=True, eq=False)
class ReplicateRows(Expression):
    """replicaterows(n): the index array [0, n), whose explode repeats
    the row n times (reference: GpuReplicateRows). The planner sets
    ``max_repeat`` from ``spark.rapids.tpu.sql.generate.maxRepeat``; a
    row past it fails in every mode (``CAPACITY_replicate_rows``)."""

    n: Expression = None
    max_repeat: int = 64

    @property
    def children(self):
        return (self.n,)

    def with_children(self, c):
        return ReplicateRows(c[0], self.max_repeat)

    @property
    def dtype(self):
        return T.array(T.INT32, self.max_repeat)

    def eval(self, batch, ctx=EvalContext()):
        c = self.n.eval(batch, ctx)
        n = c.data.to(torch.int32)
        ctx.report((n > self.max_repeat) & c.validity,
                   "CAPACITY_replicate_rows", always=True)
        data = torch.arange(self.max_repeat, dtype=torch.int32,
                            device=n.device)[None, :].expand(
            batch.capacity, -1).contiguous()
        lengths = torch.where(c.validity, n, 0).clamp(0, self.max_repeat)
        return DeviceColumn(data, c.validity, self.dtype, lengths)
