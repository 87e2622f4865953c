"""Planner to mesh lowering: a planned physical query as one stage over the
shards of a mesh.

Port of ``spark_rapids_tpu/parallel/lowering.py``. The planner's output is
matched bottom up and each supported operator chain becomes one program
over the mesh's shards (``MeshStageExec``):

    scan partitions          -> per-shard inputs (sliced on the host side)
    Project / Filter         -> per-shard kernels
    ShuffleExchangeExec      -> ``mesh_exchange`` (the all_to_all)
    BroadcastExchangeExec    -> ``mesh_broadcast`` (the all_gather)
    HashAggregateExec P / F  -> update / merge kernels, keys routed by murmur3
    HashJoinExec             -> the sort-based join at a static capacity
    SortExec (global)        -> splitter-routed range exchange, local sort
    TakeOrderedAndProjectExec-> local top-N, gathered, top-N on shard 0

The JAX package traces the stage into one SPMD XLA program. Here each
operator runs its kernels shard by shard (one after another on one card),
and each exchange moves rows between the shards. The static capacities and
overflow flags are the JAX package's, so ``lowered``, the retries and the
answers are too: the join writes into ``join_expansion x`` its stream's
capacity, a chained hash exchange into ``exchange_factor x`` its input's, a
partial aggregate is cut to ``agg_bucket`` rows before it is routed; each
records a flag when its rows do not fit, the stage reads every flag once
at its end, and a flagged run is dropped and run again with every factor
grown (``MeshStageExec._run``). The join's data-dependent branches (a dense
build, a 1:1 probe) are read on the host, as the iterator join reads them.

A plan shape outside this set raises ``MeshUnsupported``, and
``try_lower_to_mesh`` then returns None: the plan keeps its host
exchanges. Lowering is an optimization, never a correctness gate; it adds
no shape the JAX lowering lacks, and refuses every one it refuses.

``MeshStageExec.time_split()`` runs the stage with each part of the run
timed (the input staging, each shard's local kernels, the exchanges): on
CUDA events on each shard's own card, or on the host clock for CPU
shards. A collect times nothing and opens no clock.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

from ..batch import ColumnarBatch, Schema, bucket_capacity, empty_batch
from ..dictenc import decode_batch
from ..exec.aggregate import AggregateMode, HashAggregateExec
from ..exec.base import Exec, LeafExec
from ..exec.basic import FilterExec, InMemoryScanExec, ProjectExec
from ..exec.coalesce import CoalesceBatchesExec
from ..exec.common import compact, concat_batches, slice_batch
from ..exec.join import HashJoinExec, JoinType
from ..expressions.base import raw_eval
from ..expressions.hashing import murmur3_batch, partition_ids
from ..shuffle.exchange import BroadcastExchangeExec, ShuffleExchangeExec
from ..shuffle.partitioning import HashPartitioning, SinglePartitioning
from .mesh import (Mesh, batch_to, mesh_broadcast, mesh_exchange, on_device,
                   overflowed)


class MeshUnsupported(Exception):
    """Plan shape outside the mesh-fusable subset (the host path runs it)."""


class MeshCapacityError(RuntimeError):
    """Join expansion overflowed even after retries."""


_MESH_JOIN_TYPES = (JoinType.INNER, JoinType.LEFT_OUTER, JoinType.LEFT_SEMI,
                    JoinType.LEFT_ANTI, JoinType.EXISTENCE)
_SEMI_TYPES = (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI, JoinType.EXISTENCE)

#: samples per shard from which a global sort's splitters are cut
SORT_SAMPLES = 32

Shards = List[ColumnarBatch]


class _Clock:
    """Time per named part of a run, on CUDA events recorded on the
    part's card (host time on the CPU). An exchange or a broadcast is
    timed on the first shard's card: exact when the shards share it."""

    def __init__(self):
        self.marks: List = []

    @contextlib.contextmanager
    def part(self, name: str, device: torch.device):
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            yield
            end.record(stream)
            self.marks.append((name, start, end))
        else:
            t0 = time.perf_counter()
            yield
            self.marks.append((name, t0, time.perf_counter()))

    def totals(self) -> Dict[str, float]:
        """ms per part name (waits for the device)."""
        out: Dict[str, float] = {}
        for name, a, b in self.marks:
            if isinstance(a, torch.cuda.Event):
                b.synchronize()
                ms = a.elapsed_time(b)
            else:
                ms = (b - a) * 1e3
            out[name] = out.get(name, 0.0) + ms
        return out


class MeshLowering:
    """Bottom-up pattern matcher producing the stage's program."""

    def __init__(self, mesh: Mesh, axis: str = "data",
                 join_expansion: int = 1):
        # join_expansion starts lean (output slots = stream capacity): a
        # fan-out join overflows its flag and the stage runs again at
        # twice the factor (_run's retry loop)
        self.mesh = mesh
        self.axis = axis
        self.n_dev = mesh.n_dev
        self.join_expansion = join_expansion
        # chained hash exchanges must not compound capacity by n_dev each:
        # balanced routing receives ~cap rows, so the output is bounded at
        # exchange_factor * cap with an overflow flag (SinglePartitioning
        # keeps the lossless n_dev * cap: all rows land on one shard)
        self.exchange_factor = 2
        # partial-aggregate outputs keep their input capacity but hold only
        # distinct-key rows: cut them to this bucket before routing; the
        # flag and the retry (x4) cover high-cardinality keys
        self.agg_bucket = 1 << 16
        self.inputs: List[Exec] = []
        self.lowered_names: List[str] = []
        self._flags: List[torch.Tensor] = []
        #: set only while ``MeshStageExec.time_split`` runs the stage
        self._clock: Optional[_Clock] = None

    # ------------------------------------------------------------------

    def lower(self, plan: Exec) -> "MeshStageExec":
        self.inputs = []
        self.lowered_names = []
        self._lower_node(plan)
        return MeshStageExec(self, plan)

    def build_program(self, plan: Exec) -> Callable:
        """(Re)build the program: ``program(inputs) -> (shards out, flags)``
        with ``inputs[i]`` the per-shard batches of ``self.inputs[i]``."""
        self.inputs = []
        self.lowered_names = []
        top = self._lower_node(plan)

        def program(args):
            self._flags = []
            with torch.profiler.record_function("MeshStageExec"):
                out = top(args)
            return out, list(self._flags)
        return program

    # ---- helpers -----------------------------------------------------

    def _flag(self, overflow: torch.Tensor) -> None:
        self._flags.append(overflow)

    def _part(self, name: str, device: torch.device):
        """The clock's part ``name`` when the run is timed, else nothing."""
        if self._clock is None:
            return contextlib.nullcontext()
        return self._clock.part(name, device)

    def _local(self, fn: Callable, *per_shard) -> list:
        """``fn(*args of shard d)`` for each shard d, on its device."""
        out = []
        for d, args in enumerate(zip(*per_shard)):
            dev = self.mesh.devices[d]
            with on_device(dev):
                if self._clock is None:
                    out.append(fn(*args))
                else:
                    with self._clock.part(f"shard {d}", dev):
                        out.append(fn(*args))
        return out

    def _exchange(self, bs: Shards, pids, out_capacity=None) -> Shards:
        with self._part("exchange", self.mesh.devices[0]):
            return mesh_exchange(bs, pids, self.mesh, out_capacity)

    def _broadcast(self, bs: Shards, to=None) -> Shards:
        with self._part("broadcast", self.mesh.devices[0]):
            return mesh_broadcast(bs, self.mesh, to)

    def _bounded_exchange(self, bs: Shards, pids, lossless: bool) -> Shards:
        if lossless or self.exchange_factor >= self.n_dev:
            return self._exchange(bs, pids)
        out_cap = bucket_capacity(self.exchange_factor
                                  * max(b.capacity for b in bs))
        routed = self._exchange(bs, pids, out_cap)
        out = []
        for b in routed:
            self._flag(overflowed(b))
            # a flagged run is dropped: go on with a well-formed batch
            out.append(ColumnarBatch(b.columns, torch.clamp(
                b.num_rows, max=b.capacity)))
        return out

    def _zero_pids(self, bs: Shards) -> list:
        return [torch.zeros(b.capacity, dtype=torch.int32, device=b.device)
                for b in bs]

    # ------------------------------------------------------------------

    def _lower_node(self, node: Exec) -> Callable:
        self.lowered_names.append(node.name)
        if isinstance(node, (InMemoryScanExec, LeafExec)):
            from ..plan.overrides import CpuFallbackExec
            if isinstance(node, CpuFallbackExec):
                raise MeshUnsupported("CPU fallback island in plan")
            idx = len(self.inputs)
            self.inputs.append(node)
            return lambda args: args[idx]

        if isinstance(node, FilterExec):
            if node.ctx.ansi:
                raise MeshUnsupported("ANSI error channels need host sync")
            child = self._lower_node(node.child)
            cond = node.condition

            def filt(args):
                def one(b):
                    c = cond.eval(b, node.ctx)
                    return compact(b, c.data & c.validity)
                return self._local(one, child(args))
            return filt

        if isinstance(node, ProjectExec):
            if node.ctx.ansi:
                raise MeshUnsupported("ANSI error channels need host sync")
            child = self._lower_node(node.child)
            exprs = node.exprs

            def proj(args):
                return self._local(lambda b: ColumnarBatch(
                    tuple(raw_eval(e, b, node.ctx) for e in exprs),
                    b.num_rows), child(args))
            return proj

        if isinstance(node, CoalesceBatchesExec):
            # batch-size discipline is a host-path concern: a shard holds
            # its partition as one batch already
            return self._lower_node(node.child)

        if isinstance(node, HashAggregateExec):
            return self._lower_aggregate(node)

        if isinstance(node, HashJoinExec):
            return self._lower_join(node)

        if isinstance(node, ShuffleExchangeExec):
            return self._lower_exchange(node)

        from ..exec.sort import SortExec, TakeOrderedAndProjectExec
        if isinstance(node, SortExec):
            return self._lower_sort(node)
        if isinstance(node, TakeOrderedAndProjectExec):
            return self._lower_topn(node)

        raise MeshUnsupported(f"{node.name} has no mesh lowering")

    # ------------------------------------------------------------------

    def _lower_exchange(self, ex: ShuffleExchangeExec) -> Callable:
        """A hash or single exchange, the block that lets several
        exchanges chain in one stage (shuffled joins, join -> aggregate).
        Routing is mesh-wide (hash % n_dev), not the conf's shuffle
        partitions: in the stage the shard is the partition."""
        part = ex.partitioning
        if not isinstance(part, (HashPartitioning, SinglePartitioning)):
            raise MeshUnsupported(f"{type(part).__name__} exchange")
        self.lowered_names.append("mesh_exchange(all_to_all)")
        child = self._lower_node(ex.child)
        n_dev = self.n_dev

        def exch(args):
            bs = child(args)
            if isinstance(part, SinglePartitioning):
                return self._bounded_exchange(bs, self._zero_pids(bs),
                                              lossless=True)
            pids = self._local(lambda b: partition_ids(
                [raw_eval(e, b) for e in part.exprs], n_dev), bs)
            return self._bounded_exchange(bs, pids, lossless=False)
        return exch

    def _lower_sort(self, node) -> Callable:
        """Global sort = splitter-routed range exchange + local sort.
        Splitters come from strided samples of each shard's first-key sort
        operands (dead flag, null rank, orderable words), gathered and
        sorted, so every shard routes by the same bounds; rows equal on
        the first key route together, so the order across shards is total
        for any trailing keys (Spark's sampled range bounds)."""
        from ..exec.common import lexsort, sort_operands
        from ..exec.sort import sort_batch
        if not node.global_sort or self.n_dev == 1:
            child = self._lower_node(node.child)
            return lambda args: self._local(
                lambda b: sort_batch(b, node.orders, node.ctx), child(args))
        self.lowered_names.append("mesh_exchange(all_to_all)")
        child = self._lower_node(node.child)
        n_dev = self.n_dev
        o0 = node.orders[0]
        dev0 = self.mesh.devices[0]

        def lanes_and_samples(b):
            k0 = o0.child.eval(b, node.ctx)
            lanes = sort_operands([k0], [o0.descending],
                                  [o0.effective_nulls_first], b.row_mask())
            # the dead-row flag is lanes[0]: dead rows sort greatest, so a
            # shard with no rows adds samples that sort last
            n_live = torch.clamp(b.num_rows.to(torch.int64), min=1)
            pos = (torch.arange(SORT_SAMPLES, device=b.device)
                   * n_live) // SORT_SAMPLES
            pos = pos.clamp(0, b.capacity - 1)
            return lanes, [lane[pos] for lane in lanes]

        def route(lanes, split):
            # pid = how many splitters are lexicographically <= the row
            cap = lanes[0].shape[0]
            dev = lanes[0].device
            pid = torch.zeros(cap, dtype=torch.int32, device=dev)
            for d in range(n_dev - 1):
                gt = torch.zeros(cap, dtype=torch.bool, device=dev)
                eq = torch.ones(cap, dtype=torch.bool, device=dev)
                for lane, sv in zip(lanes, split):
                    v = sv[d]
                    gt = gt | (eq & (v < lane))
                    eq = eq & (lane == v)
                pid = pid + (gt | eq).to(torch.int32)
            return pid

        def srt(args):
            bs = child(args)
            got = self._local(lanes_and_samples, bs)
            with on_device(dev0), self._part("splitters", dev0):
                pool = [torch.cat([s[i].to(dev0) for _, s in got])
                        for i in range(len(got[0][1]))]
                perm = lexsort(pool)
                total = n_dev * SORT_SAMPLES
                cut = torch.tensor([(d + 1) * total // n_dev
                                    for d in range(n_dev - 1)], device=dev0)
                split = [lane[perm][cut] for lane in pool]
            pids = self._local(
                lambda b, g: route(g[0], [s.to(b.device) for s in split]),
                bs, got)
            del got
            routed = self._bounded_exchange(bs, pids, lossless=False)
            return self._local(lambda b: sort_batch(b, node.orders,
                                                    node.ctx), routed)
        return srt

    def _lower_topn(self, node) -> Callable:
        """TopN: local top-limit, gathered, and the global top-limit
        emitted once, by shard 0 (Spark's TakeOrderedAndProject)."""
        self.lowered_names.append("mesh_broadcast(all_gather)")
        child = self._lower_node(node.child)

        def topn(args):
            best = self._local(node._top, child(args))
            gathered = self._broadcast(best, to=[0])[0]
            dev0 = self.mesh.devices[0]
            with on_device(dev0), self._part("shard 0", dev0):
                out = node._top(gathered)
                if node.project:
                    out = ColumnarBatch(tuple(raw_eval(e, out, node.ctx)
                                              for e in node.project),
                                        out.num_rows)
            return [out] + [empty_batch(node.output_schema, b.device,
                                        out.capacity) for b in best[1:]]
        return topn

    # ------------------------------------------------------------------

    def _lower_aggregate(self, final: HashAggregateExec) -> Callable:
        if final.mode is not AggregateMode.FINAL:
            raise MeshUnsupported(f"aggregate mode {final.mode}")
        # two planner shapes: FINAL(exchange(PARTIAL)) for multi-partition
        # children, FINAL(PARTIAL) when the host plan was single-partition.
        # On the mesh the input is always sharded, so both lower to
        # partial -> exchange -> final.
        ex = final.child
        part_kind = None
        if isinstance(ex, ShuffleExchangeExec):
            part_kind = ex.partitioning
            if not isinstance(part_kind,
                              (HashPartitioning, SinglePartitioning)):
                raise MeshUnsupported(f"{type(part_kind).__name__} exchange")
            self.lowered_names.append(ex.name)
            partial = ex.child
        else:
            partial = ex
        if not isinstance(partial, HashAggregateExec) or \
                partial.mode is not AggregateMode.PARTIAL or \
                partial.sort_sensitive:
            raise MeshUnsupported("FINAL child is not a PARTIAL agg")
        self.lowered_names.append(partial.name)
        self.lowered_names.append("mesh_exchange(all_to_all)")
        # join -> aggregate mask fusion: an INNER join right below the
        # partial aggregate hands over its pair slots uncompacted with a
        # live mask; the aggregate's key sort sends the dead slots last
        inner = partial.child
        while isinstance(inner, CoalesceBatchesExec):
            inner = inner.child
        masked_join = child = None
        if isinstance(inner, HashJoinExec) and \
                inner.join_type is JoinType.INNER:
            masked_join = self._lower_join(inner, masked=True)
        else:
            child = self._lower_node(partial.child)
        nk = len(partial.key_fields)
        n_dev = self.n_dev
        single = nk == 0 or isinstance(part_kind, SinglePartitioning)

        def update(b, mask=None):
            part = partial._update_kernel(b, mask)
            shrink = bucket_capacity(min(part.capacity, self.agg_bucket))
            if shrink < part.capacity:
                self._flag(part.num_rows > shrink)
                part = slice_batch(part, 0, part.num_rows, shrink)
            if single:
                pids = torch.zeros(part.capacity, dtype=torch.int32,
                                   device=part.device)
            else:
                # the planner's structure, mesh-wide routing: a key lands
                # on pmod(murmur3(key), n_dev) whatever the conf's
                # shuffle partitions
                pids = torch.remainder(
                    murmur3_batch(list(part.columns[:nk])), n_dev)
            return part, pids

        def merge(d, b):
            if nk == 0 and d != 0:
                # keyless: only shard 0 owns the single global group
                return empty_batch(final.output_schema, b.device,
                                   b.capacity)
            return final._merge_kernel(b, final=True)

        def agg(args):
            if masked_join is not None:
                got = self._local(update, *zip(*masked_join(args)))
            else:
                got = self._local(update, child(args))
            routed = self._exchange([p for p, _ in got],
                                    [i for _, i in got])
            del got
            return self._local(merge, range(n_dev), routed)
        return agg

    def _lower_join(self, join: HashJoinExec, masked: bool = False
                    ) -> Callable:
        if masked:
            self.lowered_names.append(join.name + "(masked)")
        if join.broadcast_build:
            if not isinstance(join.right, BroadcastExchangeExec):
                raise MeshUnsupported("broadcast join without broadcast "
                                      "exchange child")
            if join.join_type not in _MESH_JOIN_TYPES:
                raise MeshUnsupported(
                    f"{join.join_type} needs global matched-build state "
                    f"under a replicated build")
            self.lowered_names.append(join.right.name)
            self.lowered_names.append("mesh_broadcast(all_gather)")
            stream = self._lower_node(join.left)
            build = self._lower_node(join.right.child)

            def jn(args):
                ss = stream(args)
                full = self._broadcast(build(args))
                return self._local(lambda s, b: self._join(join, s, b,
                                                           masked), ss, full)
            return jn

        # co-partitioned (shuffled) hash join: both children carry their
        # own hash exchanges on the join keys, so equal keys share a shard
        # and every join type is right per shard, RIGHT and FULL outer
        # tails included (each build row lives on one shard)
        def _hash_exchanged(side: Exec) -> bool:
            return (isinstance(side, ShuffleExchangeExec)
                    and isinstance(side.partitioning, HashPartitioning))
        if not (_hash_exchanged(join.left) and _hash_exchanged(join.right)):
            raise MeshUnsupported(
                "shuffled join children must both be hash exchanges")
        stream = self._lower_node(join.left)
        build = self._lower_node(join.right)

        def jn_shuffled(args):
            return self._local(lambda s, b: self._join(join, s, b, masked),
                               stream(args), build(args))
        return jn_shuffled

    def _join(self, join: HashJoinExec, s: ColumnarBatch,
              build: ColumnarBatch, masked: bool):
        """One shard's probe at the static output capacity, with its
        overflow flag: (pairs, live mask) when ``masked`` (INNER, no pair
        compaction, for the aggregate's fused mask), else the joined rows
        with the outer tails."""
        table, sbuild = join._build_kernel(build)
        dense = table.dense is not None and bool(table.dense)
        lo, counts, offsets = join._count_kernel(s, table, dense)
        total = offsets[-1]
        out_cap = bucket_capacity(self.join_expansion * s.capacity)
        self._flag(total > out_cap)
        if join.join_type in _SEMI_TYPES:
            return join._semi_kernel(s, sbuild, lo, counts, offsets, total,
                                     out_cap)
        unique = out_cap >= s.capacity and bool(counts.max() <= 1)
        if masked:
            return join._expand_masked(s, sbuild, lo, counts, offsets,
                                       total, unique, out_cap)
        matched0 = torch.zeros(sbuild.capacity, dtype=torch.bool,
                               device=sbuild.device)
        out, matched = join._expand_kernel(s, sbuild, lo, counts, offsets,
                                           total, unique, matched0, out_cap)
        if join.join_type in (JoinType.RIGHT_OUTER, JoinType.FULL_OUTER):
            from ..exec.join import _append_rows, _null_gather
            unmatched = sbuild.row_mask() & ~matched
            tail = compact(ColumnarBatch(
                tuple(_null_gather(s, sbuild.capacity)) + sbuild.columns,
                sbuild.num_rows), unmatched)
            out = _append_rows(out, tail,
                               bucket_capacity(out.capacity
                                               + sbuild.capacity))
        return out


# ---------------------------------------------------------------------------
# The stage exec the planner hands the rest of the plan
# ---------------------------------------------------------------------------

class MeshStageExec(LeafExec):
    """One lowered stage; its partitions are the mesh's shards.

    Owns the input staging (each input's rows sliced into one batch per
    shard), the program's run, the overflow retries and the per-shard
    results. Inputs run through their own exec subtrees, so scans keep
    their semantics."""

    def __init__(self, lowering: MeshLowering, plan: Exec):
        super().__init__()
        self.lowering = lowering
        self.plan = plan
        self._schema = plan.output_schema
        self._results: Optional[List[ColumnarBatch]] = None
        self.lowered = list(lowering.lowered_names)
        #: runs of the program the last collect took (1: no retry)
        self.attempts = 0

    @property
    def name(self) -> str:
        return "MeshStageExec"

    @property
    def output_schema(self) -> Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return self.lowering.n_dev

    @property
    def device(self) -> torch.device:
        return self.lowering.mesh.devices[0]

    # ------------------------------------------------------------------

    def _stage_input(self, e: Exec) -> List[ColumnarBatch]:
        mesh = self.lowering.mesh
        n_dev = mesh.n_dev
        batches = [decode_batch(b) for p in range(e.num_partitions)
                   for b in e.execute_partition(p)]
        if not batches:
            return [empty_batch(e.output_schema, d) for d in mesh.devices]
        src = batches[0].device
        total = int(torch.stack([b.num_rows.to(src) for b in batches]).sum())
        big = batches[0] if len(batches) == 1 else concat_batches(
            batches, bucket_capacity(max(total, 1)))
        del batches
        per_dev = max(-(-total // n_dev), 1)
        cap = bucket_capacity(per_dev)
        with on_device(src):
            return [batch_to(slice_batch(big, d * per_dev, per_dev, cap), dev)
                    for d, dev in enumerate(mesh.devices)]

    def prepare(self):
        """(program, staged inputs) at the current capacity factors, so a
        caller can time the program's runs alone."""
        low = self.lowering
        program = low.build_program(self.plan)
        with low._part("input", low.mesh.devices[0]):
            staged = [self._stage_input(e) for e in low.inputs]
        return program, staged

    def _run(self, clock: Optional[_Clock] = None) -> List[ColumnarBatch]:
        if self._results is not None:
            return self._results
        low = self.lowering
        for attempt in range(5):
            if clock is not None:
                clock.marks.clear()
            low._clock = clock
            try:
                program, staged = self.prepare()
                out, flags = program(staged)
            finally:
                low._clock = None
            del staged
            self.attempts = attempt + 1
            if not any_flag(flags, low.mesh.devices[0]):
                self._results = out
                return out
            # the flags do not say which bucket lost; grow them all
            low.join_expansion *= 2
            low.exchange_factor *= 2
            low.agg_bucket *= 4
        raise MeshCapacityError(
            f"mesh join overflowed at expansion {low.join_expansion}")

    def time_split(self) -> Dict[str, float]:
        """Runs the stage (its retries too) with each part of the run it
        keeps timed, and returns ms per part: ``input``, ``shard d``,
        ``exchange``, ``broadcast``, ``splitters``. Waits for the device."""
        clock = _Clock()
        self._results = None
        self._run(clock)
        return clock.totals()

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        yield self._run()[p]

    def do_close(self) -> None:
        self._results = None
        for e in self.lowering.inputs:
            e.close()


def any_flag(flags: List[torch.Tensor], device: torch.device) -> bool:
    """True if any flag is set, in one host read."""
    if not flags:
        return False
    return bool(torch.stack([torch.as_tensor(f).to(device)
                             for f in flags]).any())


# ---------------------------------------------------------------------------
# The Session's hook
# ---------------------------------------------------------------------------

def try_lower_to_mesh(plan: Exec, mesh: Mesh,
                      join_expansion: int = 1) -> Optional[MeshStageExec]:
    """The lowered stage, or None when the plan's shape (or any node in
    it) is outside the lowerable set."""
    try:
        return MeshLowering(mesh, join_expansion=join_expansion).lower(plan)
    except MeshUnsupported:
        return None
