"""The port's mesh data plane (``spark_rapids_tpu_torch.parallel.mesh``) on
the CPU against the JAX package's: the three cases of ``test_mesh.py``
(routing, the distributed aggregate, the global aggregate) on 8 shards,
the JAX package on its 8 virtual CPU devices and the port with its 8
shards on the CPU, over the same seeded partitions. Each shard's rows
must equal the JAX device's, integers exactly (and in order where the
routing fixes it), averages within rel 1e-6. Then the exchange's own
contract: a one-shard mesh is the identity, the default capacity is
lossless, and a smaller one flags its overflow and keeps no row."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from spark_rapids_tpu.batch import to_arrow as jto_arrow
from spark_rapids_tpu.exec import InMemoryScanExec as JInMemoryScanExec
from spark_rapids_tpu.batch import empty_batch as jempty_batch
from spark_rapids_tpu.batch import schema_from_arrow as jschema_from_arrow
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions.aggregates import Average as JAverage
from spark_rapids_tpu.expressions.aggregates import Count as JCount
from spark_rapids_tpu.expressions.aggregates import Sum as JSum
from spark_rapids_tpu.parallel import MeshPipeline as JMeshPipeline
from spark_rapids_tpu.parallel import \
    distributed_aggregate_step as jdistributed_aggregate_step
from spark_rapids_tpu.parallel import mesh_exchange as jmesh_exchange
from spark_rapids_tpu.parallel import stack_batches as jstack_batches
from spark_rapids_tpu.parallel import unstack_batches as junstack_batches
from spark_rapids_tpu_torch.batch import (empty_batch, schema_from_arrow,
                                          to_arrow)
from spark_rapids_tpu_torch.exec import InMemoryScanExec
from spark_rapids_tpu_torch.expressions import col
from spark_rapids_tpu_torch.expressions.aggregates import (Average, Count,
                                                           Sum)
from spark_rapids_tpu_torch.parallel import (Mesh, MeshPipeline,
                                             distributed_aggregate_step,
                                             mesh_exchange, stack_batches,
                                             unstack_batches)
from spark_rapids_tpu_torch.parallel.mesh import Route, overflowed

from harness.asserts import assert_rows_equal, rows_of
from harness.data_gen import IntegerGen, LongGen, gen_table

N_DEV = 8


@pytest.fixture(scope="module")
def jmesh():
    return JMesh(np.array(jax.devices()[:N_DEV]), ("data",))


@pytest.fixture(scope="module")
def mesh():
    return Mesh.round_robin(N_DEV, "cpu")


def jax_partitions(t, cap):
    batches = list(JInMemoryScanExec(t, batch_rows=cap).execute())
    schema = jschema_from_arrow(t.schema)
    while len(batches) < N_DEV:
        batches.append(jempty_batch(schema, cap))
    return batches[:N_DEV], schema


def port_partitions(t, cap):
    """The JAX test's partitions: ``cap`` rows each, padded with empty
    batches of the same capacity."""
    batches = list(InMemoryScanExec(t, batch_rows=cap,
                                    device="cpu").execute())
    schema = schema_from_arrow(t.schema)
    while len(batches) < N_DEV:
        batches.append(empty_batch(schema, torch.device("cpu"), cap))
    return batches[:N_DEV], schema


def jax_shard_rows(result, schema):
    return [rows_of(jto_arrow(b, schema))
            for b in junstack_batches(jax.device_get(result))]


def port_shard_rows(result, schema):
    return [rows_of(to_arrow(b, schema)) for b in unstack_batches(result)]


def test_mesh_exchange_routes_rows_as_jax(jmesh, mesh):
    t = gen_table([("k", IntegerGen(min_val=0, max_val=7, nullable=False)),
                   ("v", IntegerGen(nullable=False))], n=512, seed=62)
    jparts, jschema = jax_partitions(t, 64)

    def jroute(batch):
        pids = batch.columns[0].data.astype(jnp.int32) % N_DEV
        return jmesh_exchange(batch, pids, N_DEV)

    want = jax_shard_rows(JMeshPipeline(jmesh).spmd(jroute)(
        jstack_batches(jparts, jmesh)), jschema)

    parts, schema = port_partitions(t, 64)
    route = Route(lambda _, b: torch.remainder(b.columns[0].data, N_DEV))
    got = port_shard_rows(MeshPipeline(mesh).spmd(route)(
        stack_batches(parts, mesh)), schema)
    total = 0
    for d, (g, w) in enumerate(zip(got, want)):
        assert all(k % N_DEV == d for k, _ in g), f"shard {d}: {g[:5]}"
        # pieces in source order, each in its source's row order
        assert g == w, f"shard {d}"
        total += len(g)
    assert total == 512


def test_distributed_aggregate_matches_jax(jmesh, mesh):
    t = gen_table([("k", IntegerGen(min_val=0, max_val=30)),
                   ("v", LongGen(min_val=-50, max_val=50))], n=1024, seed=60)
    jparts, jschema = jax_partitions(t, 128)
    jstep, jout = jdistributed_aggregate_step(
        jmesh, jschema, [jcol("k")],
        [JSum(jcol("v")).alias("s"), JCount(jcol("v")).alias("c"),
         JAverage(jcol("v")).alias("a")])
    want = jax_shard_rows(jstep(jstack_batches(jparts, jmesh)), jout)

    parts, schema = port_partitions(t, 128)
    step, out = distributed_aggregate_step(
        mesh, schema, [col("k")],
        [Sum(col("v")).alias("s"), Count(col("v")).alias("c"),
         Average(col("v")).alias("a")])
    assert out.names == jout.names
    got = port_shard_rows(step(stack_batches(parts, mesh)), out)
    # murmur3 routing is Spark's in both: each key on the same shard
    for d, (g, w) in enumerate(zip(got, want)):
        assert_rows_equal(g, w, ignore_order=True)
    groups = {}
    for k, v in zip(t.column("k").to_pylist(), t.column("v").to_pylist()):
        groups.setdefault(k, []).append(v)
    assert sum(len(g) for g in got) == len(groups)


def test_distributed_global_aggregate_on_shard_zero(jmesh, mesh):
    t = gen_table([("v", LongGen(min_val=-10, max_val=10))], n=512, seed=61)
    jparts, jschema = jax_partitions(t, 64)
    jstep, jout = jdistributed_aggregate_step(
        jmesh, jschema, [], [JSum(jcol("v")).alias("s"),
                             JCount(jcol("v")).alias("c")])
    want = jax_shard_rows(jstep(jstack_batches(jparts, jmesh)), jout)

    parts, schema = port_partitions(t, 64)
    step, out = distributed_aggregate_step(
        mesh, schema, [], [Sum(col("v")).alias("s"),
                           Count(col("v")).alias("c")])
    got = port_shard_rows(step(stack_batches(parts, mesh)), out)
    vs = [v for v in t.column("v").to_pylist() if v is not None]
    assert got == want
    # all partials route to shard 0; the others emit no group
    assert got == [[(sum(vs), len(vs))]] + [[]] * (N_DEV - 1)


def _keyed(n, cap):
    t = gen_table([("k", IntegerGen(min_val=0, max_val=7,
                                    nullable=False))], n=n, seed=63)
    parts, schema = port_partitions(t, cap)
    return parts, schema, [torch.remainder(b.columns[0].data, N_DEV)
                           for b in parts]


def test_exchange_capacity_contract(mesh):
    """One shard: the identity. The default capacity (n_dev x cap) holds
    any routing, even every row to one shard. A smaller capacity that a
    destination's rows exceed flags it and keeps none of their data."""
    parts, schema, pids = _keyed(256, 128)
    one = Mesh(["cpu"])
    assert mesh_exchange(parts[:1], pids[:1], one)[0] is parts[0]

    zeros = [torch.zeros_like(p) for p in pids]
    routed = mesh_exchange(parts, zeros, mesh)
    assert routed[0].capacity == N_DEV * 128
    assert int(routed[0].num_rows) == 256
    assert not any(bool(overflowed(b)) for b in routed)

    tight = mesh_exchange(parts, zeros, mesh, out_capacity=128)
    assert bool(overflowed(tight[0])) and int(tight[0].num_rows) == 256
    assert not tight[0].columns[0].validity.any()
    assert not any(bool(overflowed(b)) for b in tight[1:])
