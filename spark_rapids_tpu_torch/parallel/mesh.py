"""The mesh data plane: row partitions on shards, and the exchanges between
them.

Port of ``spark_rapids_tpu/parallel/mesh.py``. The JAX package stacks one
row partition per device into ``[n_dev, cap, ...]`` arrays sharded over a
``jax.sharding.Mesh`` and repartitions inside ``shard_map`` with
``jax.lax.all_to_all``. The port keeps the partitions as a list of
per-shard batches:

- ``Mesh`` names one ``torch.device`` per shard. A device may repeat: 8
  shards may share one card, as the JAX tests put 8 virtual devices on one
  CPU. Shards on one card run one after another on its current stream.
- ``MeshPipeline`` runs a local function once per shard, on the shard's
  device, with the exchanges (``Route``) between the shards.
- ``mesh_exchange`` routes rows by a per-row shard id. Each source orders
  its live rows by destination, stably, once, and the counts of all
  sources come to the host in one read. Each (source, destination) piece
  is then a contiguous range of that order, copied into the destination's
  batch (``Tensor.copy_(non_blocking=True)``, a peer copy where the two
  shards sit on different cards). A destination holds its pieces in source
  order 0..n-1, as the all_to_all leaves them. The JAX layout of ``n_dev``
  send slots at full capacity per shard is not copied: the order and the
  split sizes hold the same rows. Across processes the same pieces ride
  ``torch.distributed.all_to_all_single`` (``parallel/multihost.py``).
- ``mesh_broadcast`` gives shards every shard's rows (the all_gather).

The capacities are JAX's. A one-shard exchange is the identity. By default
a destination holds ``n_dev x cap`` rows, which no routing can overflow. A
smaller ``out_capacity`` that a destination's rows exceed is never
truncated quietly: the batch keeps the rows it was sent in ``num_rows``,
above its capacity, and none of their data (``overflowed``); the caller
drops it and runs again at a larger capacity, as the JAX package's overflow
flag makes it do.

``distributed_aggregate_step`` is the one-program group-by: local partial,
routing by the keys' murmur3, local merge and final; without keys only
shard 0 owns the global group.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from ..batch import (ColumnarBatch, DeviceColumn, DeviceLike, Schema,
                     empty_batch, map_lanes, resolve_device, rows_scalar)
from ..dictenc import decode_batch
from ..exec.common import concat_columns
from ..expressions.base import Expression
from ..expressions.hashing import murmur3_batch


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Mesh:
    """One device per shard along one axis (``data``, the row partitions).
    ``shape`` is JAX's ``Mesh.shape``: axis name -> shard count."""

    devices: Tuple[torch.device, ...]
    axis: str = "data"

    def __init__(self, devices: Sequence[DeviceLike], axis: str = "data"):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one shard")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis", axis)

    @property
    def n_dev(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis: self.n_dev}

    @classmethod
    def round_robin(cls, n: int, device: DeviceLike = None,
                    axis: str = "data") -> "Mesh":
        """``n`` shards placed in turn on the visible devices of
        ``device``'s type, starting at ``device``: every shard on the CPU
        for a CPU device, several shards on one card where ``n`` exceeds
        the cards."""
        visible = visible_devices(device)
        return cls([visible[i % len(visible)] for i in range(n)], axis)


def visible_devices(device: DeviceLike = None) -> List[torch.device]:
    """The devices of ``device``'s type a mesh may use, ``device`` first:
    every visible card for CUDA (raising where there is none), the one CPU
    for the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    count = torch.cuda.device_count()
    first = dev.index if dev.index is not None else torch.cuda.current_device()
    return [torch.device("cuda", (first + i) % count) for i in range(count)]


@contextlib.contextmanager
def on_device(device: torch.device):
    """Run the body with ``device`` current (a no-op off CUDA)."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            yield
    else:
        yield


def batch_to(batch: ColumnarBatch, device: torch.device) -> ColumnarBatch:
    """The batch on ``device`` (itself if it is there already), with its
    dictionary columns decoded: shards carry no dictionary (each slice's
    card would differ), as in the JAX package's staging."""
    batch = decode_batch(batch)
    if batch.device == device:
        return batch
    cols = tuple(map_lanes(c, lambda t: t.to(device, non_blocking=True))
                 for c in batch.columns)
    return ColumnarBatch(cols, batch.num_rows.to(device))


def overflowed(batch: ColumnarBatch) -> torch.Tensor:
    """Device bool: ``batch`` was sent more rows than it holds."""
    return batch.num_rows > batch.capacity


def host_ints(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Each 1-D integer tensor as a list of ints, in one host read."""
    if not tensors:
        return []
    dev = tensors[0].device
    sizes = [t.numel() for t in tensors]
    flat = torch.cat([t.to(dev, torch.int64) for t in tensors]).tolist()
    out, off = [], 0
    for n in sizes:
        out.append(flat[off:off + n])
        off += n
    return out


# ---------------------------------------------------------------------------
# Shards in, shards out
# ---------------------------------------------------------------------------

def stack_batches(batches: Sequence[ColumnarBatch],
                  mesh: Optional[Mesh] = None,
                  axis: str = "data") -> List[ColumnarBatch]:
    """One batch per shard; with a mesh, each moved to its shard's device.
    The JAX package stacks them along a leading device axis; the port
    keeps the list."""
    batches = [decode_batch(b) for b in batches]
    if mesh is None:
        return batches
    if len(batches) != mesh.n_dev:
        raise ValueError(f"{len(batches)} batches for {mesh.n_dev} shards")
    return [batch_to(b, d) for b, d in zip(batches, mesh.devices)]


def unstack_batches(stacked: Sequence[ColumnarBatch]) -> List[ColumnarBatch]:
    return list(stacked)


# ---------------------------------------------------------------------------
# The exchanges
# ---------------------------------------------------------------------------

def route_order(batch: ColumnarBatch, pids: torch.Tensor, n: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, counts): the batch's live rows ordered by destination,
    stably, then its dead rows; and the live rows per destination."""
    key = torch.where(batch.row_mask(), pids.to(torch.int64), n)
    order = torch.sort(key, stable=True).indices
    return order, torch.bincount(key, minlength=n + 1)[:n]


def gather_live(batch: ColumnarBatch, order: torch.Tensor, live: int
                ) -> List[DeviceColumn]:
    """The batch's columns at the first ``live`` rows of ``order``
    (dictionary columns decoded)."""
    batch = decode_batch(batch)
    idx = order[:live]
    return [map_lanes(c, lambda t: t[idx]) for c in batch.columns]


def row_range(col: DeviceColumn, start: int, n: int) -> DeviceColumn:
    """Rows ``[start, start + n)`` of ``col`` (views)."""
    return map_lanes(col, lambda t: t[start:start + n])


def assemble(pieces: Sequence[Sequence[DeviceColumn]], counts, cap: int,
              device: torch.device) -> ColumnarBatch:
    """Per-source pieces (each a list of columns holding ``counts[s]``
    rows) as one batch of ``cap`` rows on ``device``, in source order; no
    rows where they exceed ``cap``, whose count ``num_rows`` keeps."""
    total = sum(counts)
    fits = total <= cap
    cols = tuple(concat_columns([p[i] for p in pieces],
                                counts if fits else [0] * len(counts), cap,
                                device)
                 for i in range(len(pieces[0])))
    return ColumnarBatch(cols, rows_scalar(total, device))


def mesh_exchange(batches: Sequence[ColumnarBatch],
                  pids: Sequence[torch.Tensor], mesh,
                  out_capacity: Optional[int] = None
                  ) -> List[ColumnarBatch]:
    """Route each shard's rows to the shard ``pids`` names (the all_to_all
    of the JAX package). ``batches[i]`` and ``pids[i]`` sit on shard i's
    device. Each destination gets its pieces in source order, in a batch
    of ``out_capacity`` rows (default ``n_dev x`` the largest input
    capacity: lossless); one whose rows exceed it keeps their count in
    ``num_rows`` and none of their data (``overflowed``). A mesh spanning
    processes (``multihost.DistributedMesh``) routes across them."""
    n_dev = mesh.n_dev
    if n_dev == 1:
        # every row already lives on its destination
        return list(batches)
    out_cap = out_capacity or n_dev * max(b.capacity for b in batches)
    with torch.profiler.record_function("mesh_exchange"):
        orders, counts = [], []
        for b, p in zip(batches, pids):
            with on_device(b.device):
                o, c = route_order(b, p, n_dev)
            orders.append(o)
            counts.append(c)
        if getattr(mesh, "n_proc", 1) > 1:
            from .multihost import exchange_across
            return exchange_across(batches, orders, counts, mesh, out_cap)
        host = host_ints(counts)
        sources = []
        for b, o, c in zip(batches, orders, host):
            with on_device(b.device):
                sources.append(gather_live(b, o, sum(c)))
        out = []
        for d, dev in enumerate(mesh.devices):
            pieces = [[row_range(col, sum(c[:d]), c[d]) for col in cols]
                      for cols, c in zip(sources, host)]
            with on_device(dev):
                out.append(assemble(pieces, [c[d] for c in host], out_cap,
                                     dev))
        return out


def mesh_broadcast(batches: Sequence[ColumnarBatch], mesh,
                   to: Optional[Sequence[int]] = None
                   ) -> List[ColumnarBatch]:
    """Every shard's live rows, in shard order, on each shard of ``to``
    (default: all of them), at ``n_dev x`` the largest capacity: the
    all_gather of the JAX package (a broadcast join's build; the top-N's
    candidates). Shards outside ``to`` get None."""
    n_dev = mesh.n_dev
    cap = n_dev * max(b.capacity for b in batches)
    targets = range(n_dev) if to is None else to
    with torch.profiler.record_function("mesh_broadcast"):
        rows = host_ints([torch.stack([b.num_rows.to(batches[0].device)
                                        for b in batches])])[0]
        out: List[Optional[ColumnarBatch]] = [None] * n_dev
        for d in targets:
            dev = mesh.devices[d]
            with on_device(dev):
                out[d] = assemble([b.columns for b in batches], rows, cap,
                                   dev)
        return out


# ---------------------------------------------------------------------------
# Pipelines over the shards
# ---------------------------------------------------------------------------

@dataclass
class Route:
    """An exchange step of a ``MeshPipeline``: ``pids(shard, batch)`` gives
    each row's destination shard."""

    pids: Callable[[int, ColumnarBatch], torch.Tensor]
    out_capacity: Optional[int] = None


Step = Union[Callable[[int, ColumnarBatch], ColumnarBatch], Route]


class MeshPipeline:
    """Programs over a one-axis row mesh. The SQL engine's parallelism is
    data-parallel over row partitions; the ``data`` axis is that
    parallelism. A local step runs once per shard, on the shard's device;
    a ``Route`` moves rows between shards."""

    def __init__(self, mesh: Mesh, axis: str = "data"):
        self.mesh = mesh
        self.axis = axis
        self.n_dev = mesh.n_dev

    def map(self, fn: Callable, batches: Sequence[ColumnarBatch]) -> list:
        """``fn(shard, batch)`` for each shard, on its device."""
        out = []
        for d, b in enumerate(batches):
            with on_device(self.mesh.devices[d]):
                out.append(fn(d, b))
        return out

    def spmd(self, *steps: Step
             ) -> Callable[[Sequence[ColumnarBatch]], List[ColumnarBatch]]:
        """The steps as one program: per-shard batches in, per-shard
        batches out."""
        def program(batches: Sequence[ColumnarBatch]) -> List[ColumnarBatch]:
            bs = list(batches)
            for step in steps:
                if isinstance(step, Route):
                    pids = self.map(step.pids, bs)
                    bs = mesh_exchange(bs, pids, self.mesh,
                                       out_capacity=step.out_capacity)
                else:
                    bs = self.map(step, bs)
            return bs
        return program


def hash_routing(n_dev: int, nk: int) -> Callable:
    """``pids(shard, batch)``: pmod(murmur3 of the first ``nk`` columns,
    ``n_dev``); every row to shard 0 without keys."""
    def pids(_, batch: ColumnarBatch) -> torch.Tensor:
        if nk == 0:
            return torch.zeros(batch.capacity, dtype=torch.int32,
                               device=batch.device)
        return torch.remainder(murmur3_batch(list(batch.columns[:nk])),
                               n_dev)
    return pids


def distributed_aggregate_step(mesh: Mesh, schema: Schema,
                               group_exprs: Sequence[Expression],
                               agg_exprs: Sequence[Expression],
                               axis: str = "data",
                               exchange_capacity: Optional[int] = None):
    """One program for a distributed group-by: local partial, routing by
    the keys' murmur3, local merge and final. Returns (program,
    out_schema); the program maps per-shard input batches to per-shard
    result groups. Every key lands on exactly one shard, so the shards'
    results together are the global aggregate."""
    from ..exec.aggregate import AggregateMode, HashAggregateExec
    from ..exec.basic import InMemoryScanExec

    dev0 = mesh.devices[0]
    placeholder = InMemoryScanExec([empty_batch(schema, dev0)],
                                   schema=schema)
    partial = HashAggregateExec(group_exprs, agg_exprs, placeholder,
                                AggregateMode.PARTIAL)
    # chaining through `partial` lets FINAL recover the bound functions
    final = HashAggregateExec(group_exprs, agg_exprs, partial,
                              AggregateMode.FINAL)
    nk = len(group_exprs)

    def merge(shard: int, batch: ColumnarBatch) -> ColumnarBatch:
        out = final._merge_kernel(batch, final=True)
        if nk == 0 and shard != 0:
            # keyless: only shard 0 owns the single global group
            return empty_batch(final.output_schema, batch.device,
                               out.capacity)
        return out

    pipe = MeshPipeline(mesh, axis)
    program = pipe.spmd(lambda _, b: partial._update_kernel(b),
                        Route(hash_routing(mesh.n_dev, nk),
                              exchange_capacity),
                        merge)
    return program, final.output_schema
