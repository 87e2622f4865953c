"""Multi-process bootstrap, the meshes that span processes, and the exchange
across them.

Port of ``spark_rapids_tpu/parallel/multihost.py``. The JAX package joins
``jax.distributed``'s coordination service and builds a global mesh whose
collectives cross hosts. The port joins a ``torch.distributed`` process
group: one engine process per host (or per card), each holding its own
shards, and ``mesh_exchange`` over a ``DistributedMesh`` moves rows
between every shard of every process:

1. each local source orders its live rows by global destination shard and
   counts them (``mesh.route_order``);
2. the counts cross first, in one ``all_to_all_single`` of an int64
   tensor, so each process knows what it will receive;
3. then each column's data, validity and string lengths cross in one
   ``all_to_all_single`` each, with per-process split sizes. The pieces a
   process keeps move by local copy.

Each destination holds its pieces in global source order, as within one
process. The backend is NCCL when the process's shards are CUDA devices
and gloo when they are CPU devices; gloo moves host tensors only, so a
gloo group with shards on a card (two ranks sharing one card, which NCCL
refuses) copies each buffer to the host and back explicitly. As in the
JAX package, only the exchange crosses processes: a Session's mesh stays
in one process.

Nothing tells a program of its cluster: ``init_distributed`` takes the
coordinator's ``host:port``, the process count and this process's rank,
or reads ``RAPIDS_TPU_COORDINATOR``, ``RAPIDS_TPU_NPROCS`` and
``RAPIDS_TPU_PROC_ID``::

    RAPIDS_TPU_COORDINATOR=host0:8476 RAPIDS_TPU_NPROCS=4 \\
    RAPIDS_TPU_PROC_ID=$SLURM_PROCID python my_query.py

``python -m spark_rapids_tpu_torch.parallel.multihost RANK WORLD PORT``
runs ``routing_check`` in one process of a local group (the two-process
test and the chip smoke run start one per rank).
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..batch import ColumnarBatch, DeviceColumn, DeviceLike, rows_scalar
from .mesh import (Mesh, assemble, gather_live, host_ints, on_device,
                   row_range, visible_devices)

#: bytes this process sent to and received from other processes, and its
#: transport calls (the counts' exchange included)
transport_stats: Dict[str, int] = {"bytes_sent": 0, "bytes_received": 0,
                                   "calls": 0}


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     devices: Optional[Sequence[DeviceLike]] = None,
                     backend: Optional[str] = None) -> str:
    """Join the process group (idempotent) at ``tcp://coordinator``;
    returns its backend. ``devices`` are this process's shards (default:
    the CPU): NCCL for CUDA shards, gloo for CPU shards, unless
    ``backend`` names one."""
    if dist.is_initialized():
        return dist.get_backend()
    coordinator = coordinator or os.environ.get("RAPIDS_TPU_COORDINATOR")
    num_processes = num_processes or _int_env("RAPIDS_TPU_NPROCS")
    process_id = (process_id if process_id is not None
                  else _int_env("RAPIDS_TPU_PROC_ID"))
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_distributed needs the coordinator's host:port, the "
            "process count and this process's rank (or "
            "RAPIDS_TPU_COORDINATOR, RAPIDS_TPU_NPROCS, RAPIDS_TPU_PROC_ID)")
    devs = [torch.device(d) for d in (devices or ["cpu"])]
    if backend is None:
        backend = "nccl" if devs[0].type == "cuda" else "gloo"
    if devs[0].type == "cuda":
        torch.cuda.set_device(devs[0])
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return backend


@dataclass(frozen=True)
class DistributedMesh:
    """Shards over every process of the group: ``local`` holds this
    process's (the same count in every process), global shard
    ``rank * n_local + i`` being local shard i. ``shape`` is one axis over
    every shard, or (processes, local shards) for the hierarchical mesh."""

    local: Mesh
    n_proc: int
    rank: int
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def n_local(self) -> int:
        return self.local.n_dev

    @property
    def n_dev(self) -> int:
        return self.n_proc * self.n_local

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """This process's shards' devices."""
        return self.local.devices

    @property
    def shape(self) -> dict:
        if len(self.axis_names) == 1:
            return {self.axis_names[0]: self.n_dev}
        return dict(zip(self.axis_names, (self.n_proc, self.n_local)))


def _local_mesh(local_devices: Optional[Sequence[DeviceLike]]) -> Mesh:
    return Mesh(local_devices if local_devices is not None
                else visible_devices("cuda" if torch.cuda.is_available()
                                     else "cpu"))


def global_row_mesh(local_devices: Optional[Sequence[DeviceLike]] = None,
                    axis: str = "data") -> DistributedMesh:
    """One axis over every shard of the job (processes x local shards);
    ``local_devices`` are this process's shards (default: its visible
    cards, else the CPU)."""
    return DistributedMesh(_local_mesh(local_devices), dist.get_world_size(),
                           dist.get_rank(), (axis,))


def hierarchical_mesh(local_devices: Optional[Sequence[DeviceLike]] = None,
                      axes: Tuple[str, str] = ("dcn", "ici")
                      ) -> DistributedMesh:
    """Two axes: the processes, then the shards within a process."""
    return DistributedMesh(_local_mesh(local_devices), dist.get_world_size(),
                           dist.get_rank(), tuple(axes))


def _all_to_all(t: torch.Tensor, send_splits: List[int],
                recv_splits: List[int]) -> torch.Tensor:
    """``all_to_all_single`` along dim 0; under gloo a tensor on a card
    crosses through host memory, copied there and back explicitly."""
    via_host = dist.get_backend() == "gloo" and t.device.type != "cpu"
    src = t.cpu() if via_host else t.contiguous()
    wire = src.view(torch.uint8) if src.dtype == torch.bool else src
    out = wire.new_empty((sum(recv_splits),) + tuple(wire.shape[1:]))
    dist.all_to_all_single(out, wire, recv_splits, send_splits)
    row = wire[0:1].numel() * wire.element_size()
    me = dist.get_rank()
    transport_stats["bytes_sent"] += row * sum(
        n for q, n in enumerate(send_splits) if q != me)
    transport_stats["bytes_received"] += row * sum(
        n for p, n in enumerate(recv_splits) if p != me)
    transport_stats["calls"] += 1
    if src.dtype == torch.bool:
        out = out.view(torch.bool)
    return out.to(t.device, non_blocking=True) if via_host else out


def exchange_across(batches: Sequence[ColumnarBatch],
                    orders: Sequence[torch.Tensor],
                    counts: Sequence[torch.Tensor], mesh: DistributedMesh,
                    out_cap: int) -> List[ColumnarBatch]:
    """``mesh_exchange``'s routing over processes, given each local
    source's destination order and counts over the global shards."""
    P, L, r = mesh.n_proc, mesh.n_local, mesh.rank
    dev0 = mesh.devices[0]
    host = host_ints(counts)                   # [L][P * L]
    # 1. counts: send[q, i, j] = rows of local source i for q's shard j
    send = torch.tensor([[[host[i][q * L + j] for j in range(L)]
                          for i in range(L)] for q in range(P)],
                        dtype=torch.int64, device=dev0)
    got = _all_to_all(send.reshape(P * L * L), [L * L] * P,
                      [L * L] * P).reshape(P, L, L).tolist()
    # got[p][i][j]: rows from process p's shard i for local shard j
    sources = []
    for b, o, c in zip(batches, orders, host):
        with on_device(b.device):
            sources.append(gather_live(b, o, sum(c)))

    def sent_to(q: int) -> int:
        return sum(host[i][q * L + j] for i in range(L) for j in range(L))

    def from_proc(p: int) -> int:
        return sum(got[p][i][j] for i in range(L) for j in range(L))

    send_splits = [0 if q == r else sent_to(q) for q in range(P)]
    recv_splits = [0 if p == r else from_proc(p) for p in range(P)]
    # 2. every lane of every column: process-major, then local source,
    # then destination shard (contiguous in each source's order)
    received = []
    for k, first in enumerate(sources[0]):
        lanes = []
        for name in ("data", "validity", "lengths"):
            if getattr(first, name) is None:
                lanes.append(None)
                continue
            parts = []
            for q in range(P):
                if q == r:
                    continue
                for i in range(L):
                    lo = sum(host[i][:q * L])
                    n = sum(host[i][q * L:(q + 1) * L])
                    parts.append(getattr(sources[i][k], name)[lo:lo + n]
                                 .to(dev0))
            buf = (torch.cat(parts) if parts else
                   getattr(first, name)[:0].to(dev0))
            lanes.append(_all_to_all(buf, send_splits, recv_splits))
        received.append(lanes)
    # 3. each local destination's pieces in global source order
    recv_cols = [_lane_column(sources[0][k], lanes)
                 for k, lanes in enumerate(received)]
    recv_base = [sum(recv_splits[:p]) for p in range(P)]
    out = []
    for j, dev in enumerate(mesh.devices):
        pieces, piece_rows = [], []
        for p in range(P):
            for i in range(L):
                if p == r:
                    start = sum(host[i][:r * L + j])
                    n = host[i][r * L + j]
                    cols = sources[i]
                else:
                    start = (recv_base[p]
                             + sum(sum(got[p][ii]) for ii in range(i))
                             + sum(got[p][i][:j]))
                    n = got[p][i][j]
                    cols = recv_cols
                pieces.append([row_range(c, start, n) for c in cols])
                piece_rows.append(n)
        with on_device(dev):
            out.append(assemble(pieces, piece_rows, out_cap, dev))
    return out


def _lane_column(like: DeviceColumn, lanes) -> DeviceColumn:
    """A received column: its (data, validity, lengths) lanes, typed like
    ``like``."""
    return DeviceColumn(lanes[0], lanes[1], like.dtype, lanes[2])


# ---------------------------------------------------------------------------
# The two-process routing check
# ---------------------------------------------------------------------------

def routing_check(rank: int, world: int, port: int,
                  devices: Sequence[DeviceLike],
                  backend: Optional[str] = None, rows: int = 4) -> dict:
    """Every global shard d holds ``rows`` int64 rows ``d * 10 + i``; each
    row goes to shard ``value % n_dev`` across the processes; each local
    shard must receive exactly the rows that name it, on its own device.
    Returns what this process saw and moved."""
    from .. import types as T
    from .mesh import mesh_exchange
    backend = init_distributed(f"localhost:{port}", world, rank, devices,
                               backend)
    try:
        mesh = global_row_mesh(devices)
        h = hierarchical_mesh(devices)
        n_dev = mesh.n_dev
        assert h.shape == {"dcn": world, "ici": len(devices)}, h.shape
        batches, pids = [], []
        for i, dev in enumerate(mesh.devices):
            d = rank * mesh.n_local + i
            vals = d * 10 + torch.arange(rows, dtype=torch.int64,
                                         device=dev)
            batches.append(ColumnarBatch(
                (DeviceColumn(vals, torch.ones(rows, dtype=torch.bool,
                                               device=dev), T.INT64),),
                rows_scalar(rows, dev)))
            pids.append(torch.remainder(vals, n_dev))
        out = mesh_exchange(batches, pids, mesh)
        for i, b in enumerate(out):
            d = rank * mesh.n_local + i
            n = int(b.num_rows)
            assert b.device == mesh.devices[i], (b.device, mesh.devices[i])
            got = sorted(b.columns[0].data[:n].tolist())
            want = sorted(s * 10 + k for s in range(n_dev)
                          for k in range(rows) if (s * 10 + k) % n_dev == d)
            assert got == want, (d, got, want)
            assert bool(b.columns[0].validity[:n].all())
        return {"rank": rank, "backend": backend, "shards": n_dev,
                "devices": [str(d) for d in mesh.devices],
                **transport_stats}
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one process of the "
                                 "multi-process routing check")
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--devices", default="cpu,cpu",
                    help="this process's shards, comma-separated")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    seen = routing_check(args.rank, args.world, args.port,
                         args.devices.split(","), args.backend)
    print(f"rank {args.rank}: cross-process mesh_exchange routed rows "
          f"correctly OK {seen}", flush=True)
    return 0


if __name__ == "__main__":
    # run as the package's module, whose counters the exchange updates
    from spark_rapids_tpu_torch.parallel.multihost import main as _main
    sys.exit(_main())
