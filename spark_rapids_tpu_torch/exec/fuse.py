"""Whole-stage fusion: one program for a linear device-resident subplan,
captured in a CUDA graph.

Port of ``spark_rapids_tpu/exec/fuse.py``. Where the JAX package traces a
scan -> filter -> join -> aggregate/sort stage into one XLA program, the
port emits the same operators' kernels as one straight run of torch ops
with no host read, and on CUDA captures that run in a ``torch.cuda.CUDAGraph``
(on a side stream, the scan batches as its static inputs): a later
``run()`` is one graph replay and one read of the flags.

The join's output is sized optimistically, as in the JAX package: at the
stream side's capacity bucket times ``expand_factor``, with an overflow
flag and the needed/available ratio beside the result instead of a host
read mid-stage. ANSI and capacity error counts ride the same flag vector,
in a channel of their own. ``run()`` reads the flags once, at its
materialization point: it raises the ANSI errors (``basic._raise_ansi``),
and on an overflow it plans and captures the stage again at the factor the
ratio asks for (one retry, exactly sized).

A CUDA graph cannot branch on data where the JAX package uses ``lax.cond``
(the join's dense build and its 1:1 expansion). The stage's first run is
eager: it reads each such choice once and keeps it, and the graph is
captured from the next run of the same program, which takes the kept
branches and adds a guard flag for each, tripped if the choice stops
holding; a tripped guard sends the stage back to a new planning run. The
branches give the JAX package's rows. A capture that fails raises: there
is no eager substitute. On the CPU (asked for explicitly, as the tests
do) the program runs eagerly every time.

One difference from the JAX package: a ``CoalesceBatchesExec`` or a
``BroadcastExchangeExec`` inside the stage fuses as the batch it passes
through (every scan of a fused stage supplies one batch), so a join and
sort that the planner gives a broadcast build and a coalesced stream, as
``plan.Session`` does for the bench's join_sort shape, fuses where the JAX
package's fusion leaves it to the iterator path.

The kernel wrappers count host calls, so a replay adds nothing to their
counts: ``capture_launches`` holds the launches the capture recorded, and
``replays`` the replays since.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..batch import (ColumnarBatch, DeviceColumn, Schema, bucket_capacity,
                     map_lanes)
from ..expressions.base import EvalContext, raw_eval
from ..kernels import launch_counts
from .aggregate import AggregateMode, HashAggregateExec
from .base import Exec, LeafExec
from .basic import (FilterExec, InMemoryScanExec, LocalLimitExec,
                    ProjectExec, _raise_ansi)
from .coalesce import CoalesceBatchesExec
from .common import compact, slice_batch
from .join import _SEMI_TYPES, HashJoinExec, JoinType
from .sort import SortExec, TakeOrderedAndProjectExec, sort_batch

_FUSABLE_JOIN_TYPES = (JoinType.INNER, JoinType.LEFT_OUTER,
                       JoinType.LEFT_SEMI, JoinType.LEFT_ANTI,
                       JoinType.EXISTENCE)


class FusionUnsupported(Exception):
    pass


def _passes_through(node: Exec) -> bool:
    """A coalesce or a broadcast: over one batch, each passes it through."""
    from ..shuffle.exchange import BroadcastExchangeExec
    return isinstance(node, (CoalesceBatchesExec, BroadcastExchangeExec))


class _Planner:
    """Static walk: every node must be fusable, and every leaf scan must
    supply exactly one batch (uploaded here, once). A CPU fallback island
    (``plan.overrides.CpuFallbackExec``) is not fusable, as in the JAX
    package: a plan that holds one keeps the iterator path whole, and the
    device subtree under an island, which the island collects through
    Arrow, is not fused either."""

    def __init__(self):
        self.scans: List[InMemoryScanExec] = []
        self.batches: List[ColumnarBatch] = []

    def walk(self, node: Exec) -> None:
        if isinstance(node, InMemoryScanExec):
            batches = [b for p in range(node.num_partitions)
                       for b in node.execute_partition(p)]
            if len(batches) != 1:
                raise FusionUnsupported("scan must yield exactly one batch")
            self.scans.append(node)
            self.batches.append(batches[0])
            return
        if isinstance(node, (ProjectExec, FilterExec, SortExec,
                             TakeOrderedAndProjectExec, LocalLimitExec)) \
                or _passes_through(node):
            self.walk(node.children[0])
            return
        if isinstance(node, HashJoinExec):
            if node.join_type not in _FUSABLE_JOIN_TYPES:
                raise FusionUnsupported(
                    f"join type {node.join_type} needs cross-batch state")
            self.walk(node.left)
            self.walk(node.right)
            return
        if isinstance(node, HashAggregateExec):
            if node.mode not in (AggregateMode.COMPLETE,
                                 AggregateMode.PARTIAL):
                raise FusionUnsupported("merge-mode agg joins batches")
            if node.sort_sensitive:
                raise FusionUnsupported("sort-sensitive aggregate")
            self.walk(node.children[0])
            return
        raise FusionUnsupported(f"{type(node).__name__} not fusable")


@dataclass
class _Flags:
    """The channels of one program run, kept apart as in the JAX package:
    error counts by kind (raised as such), join overflow and needs (drive
    the exactly sized retry), and the guards of kept branches."""

    kinds: List[str] = field(default_factory=list)
    errors: List[torch.Tensor] = field(default_factory=list)
    over: List[torch.Tensor] = field(default_factory=list)
    needs: List[torch.Tensor] = field(default_factory=list)
    guards: List[torch.Tensor] = field(default_factory=list)

    def add_errors(self, ctx: EvalContext) -> None:
        for kind, counts in ctx.errors.items():
            self.kinds.append(kind)
            self.errors.append(torch.stack(counts).sum())

    def vector(self, device: torch.device) -> torch.Tensor:
        """Every flag in one int64 vector, read back in one transfer."""
        parts = [torch.stack(v).to(torch.int64)
                 for v in (self.errors, self.over, self.needs, self.guards)
                 if v]
        return (torch.cat(parts) if parts
                else torch.zeros(0, dtype=torch.int64, device=device))


#: one run of the program: the output batch, the flag vector and its layout
_Run = Tuple[ColumnarBatch, torch.Tensor, _Flags]


def _copy(batch: ColumnarBatch) -> ColumnarBatch:
    """A batch of fresh tensors, out of the graph's pool (the next replay
    overwrites the graph's own)."""
    def clone(t):
        return None if t is None else t.clone()
    return ColumnarBatch(tuple(
        map_lanes(c, clone).replace(dict_data=clone(c.dict_data),
                                    dict_lengths=clone(c.dict_lengths))
        for c in batch.columns), batch.num_rows.clone())


class FusedStage:
    """A linear subplan as one program over its staged scan batches,
    captured in a CUDA graph on CUDA."""

    def __init__(self, plan: Exec, expand_factor: int = 1):
        self.plan = plan
        self.expand_factor = expand_factor
        planner = _Planner()
        planner.walk(plan)
        self.scans = planner.scans
        self.inputs = planner.batches
        self.device = self.inputs[0].device
        #: (choice, node id) -> the branch the planning run took
        self._choices: Dict[Tuple[str, int], bool] = {}
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._captured: Optional[_Run] = None
        #: graph captures, replays since the last one, and re-plans
        self.captures = 0
        self.replays = 0
        self.retries = 0
        #: kernel name -> launches recorded by the last capture
        self.capture_launches: Dict[str, int] = {}

    # -- the program -----------------------------------------------------

    def _program(self) -> _Run:
        """Emit the whole stage once over the staged inputs."""
        by_scan = {id(s): b for s, b in zip(self.scans, self.inputs)}
        flags = _Flags()
        out = self._emit(self.plan, by_scan, flags)
        return out, flags.vector(self.device), flags

    def _choose(self, what: str, node: Exec, holds: torch.Tensor,
                flags: _Flags) -> bool:
        """The branch of a data-dependent choice. The first run reads
        ``holds`` (a device bool) and keeps it; later runs, the captured
        graph among them, take the kept branch and add a guard that trips
        when ``holds`` no longer says so."""
        key = (what, id(node))
        taken = self._choices.get(key)
        if taken is None:
            taken = self._choices[key] = bool(holds)
        else:
            flags.guards.append(holds != taken)
        return taken

    def _emit(self, node: Exec, by_scan, flags: _Flags) -> ColumnarBatch:
        # the operator's own profiler range, as its iterator opens one
        with torch.profiler.record_function(node.name):
            return self._emit_node(node, by_scan, flags)

    def _emit_node(self, node: Exec, by_scan, flags: _Flags
                   ) -> ColumnarBatch:
        if isinstance(node, InMemoryScanExec):
            return by_scan[id(node)]

        if _passes_through(node):
            return self._emit(node.children[0], by_scan, flags)

        if isinstance(node, ProjectExec):
            b = self._emit(node.children[0], by_scan, flags)
            ctx = EvalContext(node.ctx.ansi, {})
            cols = tuple(raw_eval(e, b, ctx) for e in node.exprs)
            flags.add_errors(ctx)
            return ColumnarBatch(cols, b.num_rows)

        if isinstance(node, FilterExec):
            b = self._emit(node.children[0], by_scan, flags)
            ctx = EvalContext(node.ctx.ansi, {})
            c = node.condition.eval(b, ctx)
            flags.add_errors(ctx)
            return compact(b, c.data & c.validity)

        if isinstance(node, HashJoinExec):
            return self._emit_join(node, by_scan, flags, masked=False)[0]

        if isinstance(node, SortExec):
            b = self._emit(node.children[0], by_scan, flags)
            return sort_batch(b, node.orders, node.ctx)

        if isinstance(node, TakeOrderedAndProjectExec):
            out = node._top(self._emit(node.children[0], by_scan, flags))
            if node.project:
                out = ColumnarBatch(tuple(raw_eval(e, out, node.ctx)
                                          for e in node.project),
                                    out.num_rows)
            return out

        if isinstance(node, LocalLimitExec):
            b = self._emit(node.children[0], by_scan, flags)
            return slice_batch(b, 0, node.limit)

        if isinstance(node, HashAggregateExec):
            child = node.children[0]
            if (isinstance(child, HashJoinExec)
                    and child.join_type is JoinType.INNER):
                # the aggregate key-sorts anyway: the join's pairs feed it
                # uncompacted, with their mask as dead rows
                b, mask = self._emit_join(child, by_scan, flags,
                                          masked=True)
            else:
                b, mask = self._emit(child, by_scan, flags), None
            part = node._update_kernel(b, mask, static=True)
            if node.mode is AggregateMode.COMPLETE:
                return node._merge_kernel(part, final=True, static=True)
            return part

        raise AssertionError(f"unplanned node {type(node).__name__}")

    def _emit_join(self, node: HashJoinExec, by_scan, flags: _Flags,
                   masked: bool
                   ) -> Tuple[ColumnarBatch, Optional[torch.Tensor]]:
        """(output, pair mask): the join at the optimistic static size,
        its overflow and needs on the flags. ``masked`` (INNER under an
        aggregate): the pairs uncompacted, with their mask."""
        stream = self._emit(node.left, by_scan, flags)
        build = self._emit(node.right, by_scan, flags)
        table, sbuild = node._build_kernel(build)
        dense = (table.dense is not None
                 and self._choose("dense", node, table.dense, flags))
        lo, counts, offsets = node._count_kernel(stream, table, dense)
        total = offsets[-1]
        out_cap = bucket_capacity(stream.capacity * self.expand_factor)
        # candidates that do not fit the optimistic bucket, and the
        # needed/available ratio that sizes the one exact retry
        flags.over.append(total > out_cap)
        flags.needs.append((total + out_cap - 1) // out_cap)
        if node.join_type in _SEMI_TYPES:
            return node._semi_kernel(stream, sbuild, lo, counts, offsets,
                                     total, out_cap), None
        one_to_one = out_cap >= stream.capacity and (masked or (
            node.condition is None
            and node.join_type in (JoinType.INNER, JoinType.LEFT_OUTER)))
        unique = one_to_one and self._choose("unique", node,
                                             counts.max() <= 1, flags)
        if masked:
            return node._expand_masked(stream, sbuild, lo, counts, offsets,
                                       total, unique, out_cap)
        matched = torch.zeros(sbuild.capacity, dtype=torch.bool,
                              device=sbuild.device)
        out, _ = node._expand_kernel(stream, sbuild, lo, counts, offsets,
                                     total, unique, matched, out_cap)
        return out, None

    # -- execution -------------------------------------------------------

    def _check(self, flags: torch.Tensor, layout: _Flags
               ) -> Tuple[bool, int, bool]:
        """Read the flag vector (the one host read of a run), raise the
        ANSI and capacity errors, and return (join overflowed, largest
        needed/available ratio, a kept branch no longer holds)."""
        vals = flags.tolist()
        ne, nj = len(layout.kinds), len(layout.over)
        errs: Dict[str, int] = {}
        for kind, count in zip(layout.kinds, vals[:ne]):
            errs[kind] = errs.get(kind, 0) + count
        _raise_ansi(errs)
        over, needs = vals[ne:ne + nj], vals[ne + nj:ne + 2 * nj]
        return any(over), max(needs, default=1), any(vals[ne + 2 * nj:])

    def _replan(self, factor: int) -> None:
        """Drop the graph and the kept branches: the next run plans anew,
        at ``factor``."""
        self.expand_factor = factor
        self._choices.clear()
        self._graph = self._captured = None
        self.retries += 1

    def _capture(self) -> None:
        """Capture the program in a CUDA graph on a side stream. A failed
        capture raises."""
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream(self.device)
            with torch.cuda.graph(graph, stream=side):
                captured = self._program()
        after = launch_counts()
        self.capture_launches = {k: after[k] - before[k] for k in after}
        self._graph, self._captured = graph, captured
        self.captures += 1
        self.replays = 0

    def _replay(self) -> _Run:
        self._graph.replay()
        self.replays += 1
        return self._captured

    def prepare(self) -> Tuple[Callable[[], _Run], List[ColumnarBatch]]:
        """(program, inputs), for steady-state timing and callers that
        check the flags themselves. ``program()`` runs the stage once and
        returns (output, flag vector, layout): on CUDA it replays the
        captured graph (planned and captured here by a first ``run()``),
        whose output tensors the next replay overwrites; on the CPU it is
        the eager program."""
        if self.device.type == "cuda":
            if self._graph is None:
                self.run()
            return self._replay, self.inputs
        return self._program, self.inputs

    def run(self, max_retries: int = 3, capture: bool = True
            ) -> ColumnarBatch:
        """Execute and check the flags at the single materialization
        point. On a join overflow the program's needed/available ratio
        sizes one exact retry (with headroom, for a bigger bucket that
        uncovers more candidates downstream). On CUDA, with ``capture``,
        the first clean run is followed by the capture, and later runs
        replay it and hand out a copy of its output; without ``capture``
        (or on the CPU) every run is the eager program."""
        graph = capture and self.device.type == "cuda"
        for _ in range(max_retries):
            if graph and self._graph is not None:
                out, flags, layout = self._replay()
            else:
                out, flags, layout = self._program()
            over, grow, tripped = self._check(flags, layout)
            if tripped:
                self._replan(self.expand_factor)
            elif over:
                self._replan(self.expand_factor * max(grow, 2))
            elif not graph:
                return out
            elif self._graph is None:
                self._capture()
                return out
            else:
                return _copy(out)
        raise RuntimeError("fused stage overflowed after retries; "
                           "join output exceeds retry buckets")


def try_fuse(plan: Exec, expand_factor: int = 1) -> Optional[FusedStage]:
    """The plan as one fused stage, or None if a node needs cross-batch
    state or host control flow."""
    try:
        return FusedStage(plan, expand_factor)
    except FusionUnsupported:
        return None


class FusedStageExec(LeafExec):
    """The fused stage as a one-partition operator, so a collect runs
    whole-stage programs transparently. Each execution yields a copy of
    the stage's output."""

    def __init__(self, stage: FusedStage):
        super().__init__()
        self.stage = stage

    @property
    def output_schema(self) -> Schema:
        return self.stage.plan.output_schema

    @property
    def num_partitions(self) -> int:
        return 1

    @property
    def device(self) -> torch.device:
        return self.stage.device

    def do_execute_partition(self, p: int):
        yield self.stage.run()


def try_fuse_exec(plan: Exec) -> Optional[FusedStageExec]:
    stage = try_fuse(plan)
    return FusedStageExec(stage) if stage is not None else None
