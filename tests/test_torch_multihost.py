"""The port's exchange across processes on the CPU, mirroring
``test_multihost.py``: two engine processes join one ``torch.distributed``
group (gloo, at a local TCP address), 2 shards each, and route every row
to global shard ``value % 4`` through ``mesh_exchange`` over a
``DistributedMesh``; each process checks what its shards received
(``parallel.multihost.routing_check``). A worker that hangs (a peer died
in the group's rendezvous) is killed, so none outlives the test."""

import os
import pathlib
import socket
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_group_exchanges_rows():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "spark_rapids_tpu_torch.parallel.multihost",
         str(rank), "2", str(port), "--devices", "cpu,cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=str(ROOT), text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-2000:]}"
        assert "mesh_exchange routed rows correctly OK" in out, out
        assert "'backend': 'gloo'" in out and "'shards': 4" in out, out
        # to the other process: its 2 x 2 counts (int64), then 2 of each
        # local shard's 4 rows (int64 and a validity byte)
        assert "'bytes_sent': 68" in out, out
