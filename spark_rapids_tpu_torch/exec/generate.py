"""Generate (explode / posexplode): the lateral view over an array or map
column.

Port of ``spark_rapids_tpu/exec/generate.py`` (reference:
GpuGenerateExec.scala: explode, posexplode and their outer forms). The
array layout is already rectangular (``data[cap, max_elems]`` plus
``lengths``), so an explode is a compaction of the ``cap * max_elems``
element slots:

1. the keep mask: a slot below its row's length (with ``outer``, slot 0 of
   a null or empty array too, with a null element);
2. one stable compaction of the flattened slots, which gives each output
   row its slot, and so its input row (``slot // max_elems``) and its
   position (``slot % max_elems``);
3. one gather of every carried column at those input rows, and of the
   elements at those slots.

The JAX package broadcasts every carried column to ``[cap * max_elems]``
before it compacts; gathering after the compaction gives the same batch
without building the broadcast copies. The output capacity is the static
bound ``cap * max_elems``. Dictionary strings are decoded first, as the
JAX package decodes them. A map generator emits its key and its value.
"""

from __future__ import annotations

from typing import Iterator, Optional

import torch

from .. import types as T
from ..batch import ColumnarBatch, DeviceColumn, Field, Schema
from ..dictenc import decode_batch
from ..expressions.base import EvalContext, Expression
from ..types import TypeKind
from .base import Exec, UnaryExec
from .basic import _raise_ansi, _sum_errors
from .common import compaction_indices, gather_columns


class GenerateExec(UnaryExec):
    """explode/posexplode of one array or map generator expression.

    ``outer=True`` keeps a row whose array is null or empty, with one null
    element (Spark's EXPLODE_OUTER); ``pos=True`` adds the element
    position column before the element (posexplode), null on such a
    row."""

    def __init__(self, generator: Expression, child: Exec,
                 outer: bool = False, pos: bool = False,
                 elem_name: str = "col", pos_name: str = "pos",
                 value_name: str = "value",
                 ctx: Optional[EvalContext] = None):
        super().__init__(child, ctx)
        self.generator = generator.bind(child.output_schema)
        self.outer = outer
        self.pos = pos
        gt = self.generator.dtype
        if gt.kind not in (TypeKind.ARRAY, TypeKind.MAP):
            raise TypeError(f"explode expects an array or map, got {gt}")
        self.is_map = gt.kind is TypeKind.MAP
        fields = list(child.output_schema.fields)
        if pos:
            fields.append(Field(pos_name, T.INT32, outer))
        fields.append(Field(elem_name, gt.children[0], outer))
        if self.is_map:
            fields.append(Field(value_name, gt.children[1], outer))
        self._schema = Schema(fields)

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def _explode(self, batch: ColumnarBatch,
                 ctx: EvalContext) -> ColumnarBatch:
        batch = decode_batch(batch)
        arr = self.generator.eval(batch, ctx)
        cap, me = arr.data.shape[:2]
        out_cap = cap * me
        dev = batch.device
        slot = torch.arange(me, device=dev)[None, :]
        elem_valid = (slot < arr.lengths[:, None]) & arr.validity[:, None]
        keep = elem_valid
        if self.outer:
            has_elem = arr.validity & (arr.lengths > 0)
            keep = keep | ((slot == 0) & ~has_elem[:, None])
        keep = keep & batch.row_mask()[:, None]
        idx, count = compaction_indices(keep.reshape(out_cap))
        live = torch.arange(out_cap, device=dev) < count
        cols = gather_columns(batch.columns, idx // me, live)
        ev = elem_valid.reshape(out_cap)[idx] & live
        if self.pos:
            cols.append(DeviceColumn(
                torch.where(ev, idx % me, 0).to(torch.int32), ev, T.INT32))
        gt = self.generator.dtype

        def elements(data: torch.Tensor, dtype) -> DeviceColumn:
            flat = data.reshape((out_cap,) + tuple(data.shape[2:]))[idx]
            row = ev.view((-1,) + (1,) * (flat.dim() - 1))
            flat = torch.where(row, flat, torch.zeros(
                (), dtype=flat.dtype, device=dev))
            if dtype.kind is TypeKind.STRING:
                # array<string>: element lengths from data2
                lens = torch.where(ev, arr.data2.reshape(out_cap)[idx], 0)
                return DeviceColumn(flat, ev, dtype, lens)
            return DeviceColumn(flat, ev, dtype)

        cols.append(elements(arr.data, gt.children[0]))
        if self.is_map:
            cols.append(elements(arr.data2, gt.children[1]))
        return ColumnarBatch(tuple(cols), count)

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        for batch in self.child.execute_partition(p):
            ctx = EvalContext(self.ctx.ansi, {})
            out = self._explode(batch, ctx)
            _raise_ansi(_sum_errors(ctx))
            yield out
