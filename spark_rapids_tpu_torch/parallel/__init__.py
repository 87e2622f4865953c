"""The mesh data plane: row partitions on shards and the exchanges between
them.

Port of ``spark_rapids_tpu/parallel/``: ``mesh.py`` (the shards, the
exchange and broadcast, pipelines over the shards, the distributed
aggregate), ``lowering.py`` (a planned query as one stage over a mesh,
which the Session runs under ``shuffle.mode=ICI``) and ``multihost.py``
(the process group and the exchange across processes). Where the JAX
package compiles collectives over XLA devices, the port keeps one batch
per shard, each on its ``torch.device`` (several shards may share a card),
and moves rows between them by copies, or across processes with
``torch.distributed``.
"""

from .mesh import (Mesh, MeshPipeline, distributed_aggregate_step,
                   mesh_exchange, stack_batches, unstack_batches)

__all__ = [n for n in dir() if not n.startswith("_")]
