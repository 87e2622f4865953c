"""DECIMAL128 in the port (``spark_rapids_tpu_torch/expressions/decimal128.py``
and every site that reads a limb lane) against the JAX package, on the CPU.

- The 14 cases of ``tests/test_decimal128.py`` but the MAP one, against the
  port's Session: over the same ``wide_table`` input each gives the JAX
  Session's rows, decimals exact, and its ``fell_back()``. Each JAX plan
  runs once.
- Each function of ``decimal128.py`` against the JAX function, on random
  limbs and the edges (0, +-1, +-2^63, +-10^37, 3 * 10^37, 10^38 - 1,
  -2^127); the Arrow buffer view against ``to_limbs_np``.
- ``_hash_dec128`` against the scalar oracle over the JAX test's edge list.
- The limb lanes across the wire, the spill tiers, the coalesce, a fused
  stage, the mesh and a Parquet scan.
- The pinned product departure: the port follows Spark where the JAX
  device wraps in int64 and the JAX interpreter rounds at 28 digits.
- TPC-H Q18 at SF 0.01 in the spec's DECIMAL types and over
  decimal(38, 0) keys, against the JAX Session and pyarrow.

The JAX package builds ``_hash_dec128``'s bit-length table on first use;
built inside a jit trace it keeps a leaked tracer that fails every later
hash in the process, so an autouse fixture hands it a concrete table."""

import decimal as d
import random

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import from_arrow as jfrom_arrow
from spark_rapids_tpu.exec.join import JoinType as JJoinType
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import decimal128 as JD
from spark_rapids_tpu.expressions import hashing as JH
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions.aggregates import Count as JCount
from spark_rapids_tpu.expressions.aggregates import Max as JMax
from spark_rapids_tpu.expressions.aggregates import Min as JMin
from spark_rapids_tpu.expressions.aggregates import Sum as JSum
from spark_rapids_tpu.expressions.comparison import \
    GreaterThan as JGreaterThan
from spark_rapids_tpu.exec.sort import asc as jasc
from spark_rapids_tpu.exec.sort import desc as jdesc
from spark_rapids_tpu.plan import Session as JSession
from spark_rapids_tpu.plan import table as jtable
from spark_rapids_tpu.shuffle import serializer as jser
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import DeviceColumn, from_arrow, to_arrow
from spark_rapids_tpu_torch.exec import (CoalesceBatchesExec, FilterExec,
                                         InMemoryScanExec, JoinType,
                                         ProjectExec, TargetSize, collect)
from spark_rapids_tpu_torch.exec.fuse import try_fuse
from spark_rapids_tpu_torch.expressions import XxHash64, col, lit
from spark_rapids_tpu_torch.expressions import decimal128 as D
from spark_rapids_tpu_torch.expressions.aggregates import (Average, Count,
                                                           Max, Min, Sum)
from spark_rapids_tpu_torch.expressions.hashing import (_hash_dec128,
                                                        _seeds,
                                                        murmur3_batch)
from spark_rapids_tpu_torch.kernels.murmur3 import hash_decimal
from spark_rapids_tpu_torch.memory import catalog as tcatalog
from spark_rapids_tpu_torch.plan import Session, table
from spark_rapids_tpu_torch.shuffle import serializer as tser

from harness.asserts import assert_tables_equal
from harness.murmur3_oracle import hash_decimal as oracle_hash_decimal
from test_decimal128 import wide_table


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each case on one torch thread: many small ops, which a pool of
    threads per test worker only slows when the workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def jax_bit_length_table(monkeypatch):
    monkeypatch.setattr(JH, "_BITLEN_TABLE", jnp.asarray(
        [x.bit_length() for x in range(256)], jnp.int32))


class _Api:
    def __init__(self, **kw):
        self.__dict__.update(kw)


JAX = _Api(table=jtable, col=jcol, lit=jlit, Sum=JSum, Count=JCount,
           Min=JMin, Max=JMax, T=JT, JoinType=JJoinType)
PORT = _Api(table=table, col=col, lit=lit, Sum=Sum, Count=Count, Min=Min,
            Max=Max, T=T, JoinType=JoinType)

ORACLE = {"spark.rapids.tpu.sql.enabled": False}


def _both(q, conf=None, ignore_order=True):
    """``q(api)`` through the port's Session and the JAX Session: the same
    rows and types, decimals exact, and the same islands. Returns the
    port's table and Session."""
    ses = Session(conf or {}, device="cpu")
    got = ses.collect(q(PORT))
    jses = JSession(conf or {})
    want = jses.collect(q(JAX))
    assert got.schema == want.schema
    assert_tables_equal(got, want, ignore_order=ignore_order,
                        approx_float=False)
    assert ses.fell_back() == jses.fell_back()
    return got, ses


# ---------------------------------------------------------------------------
# the 14 cases of tests/test_decimal128.py but the MAP one
# ---------------------------------------------------------------------------

def test_roundtrip():
    t = wide_table()
    batch, schema = from_arrow(t, device="cpu")
    jbatch, _ = jfrom_arrow(t)
    np.testing.assert_array_equal(batch.columns[1].data.numpy(),
                                  np.asarray(jbatch.columns[1].data))
    assert to_arrow(batch, schema).column("w").to_pylist() == \
        t.column("w").to_pylist()


def test_groupby_sum_min_max():
    _both(lambda a: a.table(wide_table()).group_by("k").agg(
        a.Sum(a.col("w")).alias("s"), a.Min(a.col("w")).alias("mn"),
        a.Max(a.col("w")).alias("mx"), a.Count(a.col("w")).alias("c")))


def test_groupby_runs_on_device():
    _, ses = _both(lambda a: a.table(wide_table()).group_by("k").agg(
        a.Sum(a.col("w")).alias("s")))
    assert ses.fell_back() == []


def test_filter_compare():
    bound = d.Decimal("1000000000000000000.0001")   # past int64
    got, _ = _both(lambda a: a.table(wide_table()).where(
        a.col("w") > a.lit(bound, a.T.decimal(38, 4))))
    assert 0 < got.num_rows < wide_table().num_rows


def test_sort():
    _both(lambda a: a.table(wide_table()).order_by("w"), ignore_order=False)


def test_dec64_sum_widens_on_device():
    rng = random.Random(3)
    t = pa.table({
        "k": pa.array([rng.randrange(3) for _ in range(300)], pa.int32()),
        "x": pa.array([d.Decimal(rng.randrange(-10**11, 10**11))
                       .scaleb(-2) for _ in range(300)],
                      pa.decimal128(12, 2))})
    got, ses = _both(lambda a: a.table(t).group_by("k").agg(
        a.Sum(a.col("x")).alias("s")))
    assert ses.fell_back() == []
    assert got.schema.field("s").type == pa.decimal128(22, 2)
    exp = Session(ORACLE, device="cpu").collect(
        table(t).group_by("k").agg(Sum(col("x")).alias("s")))
    assert_tables_equal(got, exp, ignore_order=True, approx_float=False)


def test_first_last():
    _both(lambda a: a.table(wide_table()).group_by("k").agg(
        a.Min(a.col("w")).alias("mn"), a.Max(a.col("w")).alias("mx"),
        a.Count().alias("c")))


MURMUR_EDGES = [0, 1, -1, 127, 128, -128, -129, 255, 256, -256,
                2**31 - 1, 2**31, -(2**31), 2**32 - 1, 2**32, -(2**32),
                2**63 - 1, 2**63, -(2**63), 10**37, -(10**37),
                3 * 10**37, -(3 * 10**37), 2**96 + 12345, -(2**96) - 99]


def _signed32(x):
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def test_dec128_murmur3_vs_oracle():
    """``_hash_dec128`` through ``murmur3_batch`` against the scalar
    oracle, across the byte-length edges, and equal to the JAX hash."""
    rng = random.Random(11)
    vals = MURMUR_EDGES + [rng.randrange(-(10**37), 10**37)
                           for _ in range(200)]
    with d.localcontext() as lctx:
        lctx.prec = 60
        decs = [d.Decimal(v).scaleb(-4) for v in vals]
    t = pa.table({"w": pa.array(decs, pa.decimal128(38, 4))})
    batch, _ = from_arrow(t, device="cpu")
    got = murmur3_batch([batch.columns[0]])[:t.num_rows].tolist()
    assert got == [_signed32(oracle_hash_decimal(v, 38, 42)) for v in vals]
    assert got == [hash_decimal(v, 38, 42) for v in vals]
    jbatch, _ = jfrom_arrow(t)
    assert got == np.asarray(JH.murmur3_batch(
        [jbatch.columns[0]])[:t.num_rows]).tolist()


def test_dec128_group_key_on_device():
    _, ses = _both(lambda a: a.table(wide_table()).group_by("w").agg(
        a.Count().alias("c")))
    assert ses.fell_back() == []


def test_dec128_join_key_on_device():
    def q(a):
        right = a.table(wide_table(seed=7)).group_by("w").agg(
            a.Count().alias("n"))
        return a.table(wide_table(seed=7)).join(
            right, [a.col("w")], [a.col("w")], a.JoinType.INNER)
    got, ses = _both(q)
    assert ses.fell_back() == [] and got.num_rows > 0


def test_dec128_key_through_exchange():
    """Three slices, so the group-by's hash exchange routes the limb key
    by ``_hash_dec128``."""
    _, ses = _both(lambda a: a.table(wide_table(), num_slices=3)
                   .group_by("w").agg(a.Count().alias("c"),
                                      a.Min(a.col("w")).alias("mn")))
    assert "ShuffleExchangeExec" in ses.executed_exec_names()
    assert ses.fell_back() == []


def test_dec128_arithmetic_falls_back():
    """``w + w`` over decimal(38,4) is an island in both packages. Its rows
    are a pinned departure: the port's interpreter adds exactly, as Spark
    does, where the JAX interpreter rounds to 28 significant digits
    (Python's default decimal context)."""
    def q(a):
        return a.table(wide_table()).select(
            (a.col("w") + a.col("w")).alias("twice"))
    ses, jses = Session({}, device="cpu"), JSession({})
    got = ses.collect(q(PORT)).column("twice").to_pylist()
    want = jses.collect(q(JAX)).column("twice").to_pylist()
    assert ses.fell_back() == jses.fell_back() == ["CpuFallback[Project]"]
    w = wide_table().column("w").to_pylist()
    with d.localcontext() as cx:
        cx.prec = 80
        exact = [None if v is None else v + v for v in w]
    assert got == exact
    assert want == [None if v is None else +(v + v) for v in w]
    assert got != want


def test_sum_overflow_nulls():
    """A sum past 38 digits nulls its group, device and interpreter."""
    big = d.Decimal(10 ** 37)
    t = pa.table({"k": pa.array([0] * 45 + [1], pa.int32()),
                  "w": pa.array([big] * 45 + [d.Decimal(7)],
                                pa.decimal128(38, 0))})
    got, ses = _both(lambda a: a.table(t).group_by("k").agg(
        a.Sum(a.col("w")).alias("s")))
    assert ses.fell_back() == []
    res = dict(zip(got.column("k").to_pylist(), got.column("s").to_pylist()))
    assert res == {0: None, 1: d.Decimal(7)}
    exp = Session(ORACLE, device="cpu").collect(
        table(t).group_by("k").agg(Sum(col("w")).alias("s")))
    assert dict(zip(exp.column("k").to_pylist(),
                    exp.column("s").to_pylist())) == res


def test_mixed_scale_compare():
    t = pa.table({
        "a": pa.array([d.Decimal("5.00"), d.Decimal("-1.25"),
                       d.Decimal("4.00")], pa.decimal128(10, 2)),
        "b": pa.array([d.Decimal("4.000"), d.Decimal("-1.250"),
                       d.Decimal("4.001")], pa.decimal128(25, 3))})
    got, _ = _both(lambda a: a.table(t).select(
        (a.col("a") > a.col("b")).alias("gt"),
        (a.col("a") == a.col("b")).alias("eq"),
        (a.col("a") <= a.col("b")).alias("le")), ignore_order=False)
    assert got.to_pylist() == [
        {"gt": True, "eq": False, "le": False},
        {"gt": False, "eq": True, "le": True},
        {"gt": False, "eq": False, "le": True}]


def test_dec64_mixed_scale_compare_aligns_scales():
    """Two DECIMAL64 columns of different scales compare their values,
    as in the JAX package (the port compared their unscaled ints before:
    5.00 > 4.001 came out false); a pair whose rescale would pass int64
    is refused by tagging with the JAX reason, and the interpreter
    answers."""
    t = pa.table({
        "a": pa.array([d.Decimal("5.00"), d.Decimal("-1.25"),
                       d.Decimal("4.00")], pa.decimal128(10, 2)),
        "b": pa.array([d.Decimal("4.001"), d.Decimal("-1.250"),
                       d.Decimal("4.001")], pa.decimal128(12, 3)),
        "c": pa.array([d.Decimal("0.000000000001")] * 3,
                      pa.decimal128(18, 12))})
    got, ses = _both(lambda a: a.table(t).select(
        (a.col("a") > a.col("b")).alias("gt"),
        (a.col("a") == a.col("b")).alias("eq"),
        (a.col("a") <= a.col("b")).alias("le")), ignore_order=False)
    assert ses.fell_back() == []
    assert got.to_pylist() == [
        {"gt": True, "eq": False, "le": False},
        {"gt": False, "eq": True, "le": True},
        {"gt": False, "eq": False, "le": True}]
    _, ses = _both(lambda a: a.table(t).select(
        (a.col("a") < a.col("c")).alias("lt")), ignore_order=False)
    assert ses.fell_back() == ["CpuFallback[Project]"]
    assert "rescales past the int64 unscaled range" in Session(
        device="cpu").explain(table(t).select(
            (col("a") < col("c")).alias("lt")))


# ---------------------------------------------------------------------------
# decimal128.py against the JAX module, function by function
# ---------------------------------------------------------------------------

EDGES = [0, 1, -1, 2**63, -(2**63), 10**37, -(10**37), 3 * 10**37,
         10**38 - 1, -(2**127)]


def _values(n=400, seed=5):
    rng = random.Random(seed)
    return EDGES + [rng.randrange(-(2**127), 2**127) for _ in range(n)]


def _limbs(vals):
    return D.to_limbs_np(vals)


def _port(a):
    return torch.from_numpy(np.asarray(a))


def _eq(port_out, jax_out):
    np.testing.assert_array_equal(np.asarray(port_out), np.asarray(jax_out))


def _case_to_from_limbs():
    vals = _values()
    _eq(D.to_limbs_np(vals), JD.to_limbs_np(vals))
    assert D.from_limbs_np(JD.to_limbs_np(vals)) == JD.from_limbs_np(
        JD.to_limbs_np(vals)) == vals
    # the Arrow buffer view: the same limbs, a null slot zero
    decs = [d.Decimal(v) if abs(v) < 10**38 else None for v in vals]
    arr = pa.array(decs, pa.decimal128(38, 0))
    want = JD.to_limbs_np([v if x is not None else 0
                           for v, x in zip(vals, decs)])
    valid = np.asarray(arr.is_valid())
    for lo, hi in ((0, len(vals)), (3, 53)):
        words = torch.from_numpy(D.arrow_words(arr.slice(lo, hi - lo)))
        _eq(D.widen_words(words, _port(valid[lo:hi])), want[lo:hi])
    assert D.limbs_to_arrow(want, T.decimal(38, 0), valid).equals(arr)


def _case_is_dec128():
    for p in (1, 18, 19, 25, 38):
        assert D.is_dec128(T.decimal(p, 0)) == \
            JD.is_dec128(JT.decimal(p, 0)) == (p > 18)
    assert not D.is_dec128(T.INT64) and not JD.is_dec128(JT.INT64)


def _case_normalize():
    rng = np.random.default_rng(3)
    raw = rng.integers(-(2**40), 2**40, (300, 4), dtype=np.int64)
    _eq(D.normalize(_port(raw)), JD.normalize(jnp.asarray(raw)))


def _case_order_key_pair():
    lim = _limbs(_values())
    for p, j in zip(D.order_key_pair(_port(lim)),
                    JD.order_key_pair(jnp.asarray(lim))):
        _eq(p, j)


def _case_orderable_words128():
    """The JAX words are uint64 with the sign bit flipped; the port's are
    the same bits as signed int64 words, unflipped."""
    lim = _limbs(_values())
    for p, j in zip(D.orderable_words128(_port(lim)),
                    JD.orderable_words128(jnp.asarray(lim))):
        _eq(p, np.asarray(j).view(np.int64) ^ np.int64(-(2**63)))
    hi, lo = (w.numpy() for w in D.orderable_words128(_port(lim)))
    order = np.lexsort((lo, hi))
    assert [_values()[i] for i in order] == sorted(_values())


def _case_compare():
    vals = _values()
    a, b = _limbs(vals), _limbs(vals[::-1])
    for p, j in zip(D.compare(_port(a), _port(b)),
                    JD.compare(jnp.asarray(a), jnp.asarray(b))):
        _eq(p, j)


def _groups(n, n_groups=7, seed=9):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, n_groups, n))
    live = rng.random(n) < 0.8
    return seg, live


def _case_seg_sum128():
    vals = _values() + [2**126] * 10
    lim = _limbs(vals)
    seg, live = _groups(len(vals))
    seg[-10:] = 7                      # a group that overflows
    live[-10:] = True
    p = D.seg_sum128(_port(lim), _port(live), _port(seg), 8)
    j = JD.seg_sum128(jnp.asarray(lim), jnp.asarray(live), jnp.asarray(seg),
                      8)
    _eq(p[0], j[0])
    _eq(p[1], j[1])
    assert bool(p[1][7])


def _case_seg_minmax128():
    lim = _limbs(_values())
    seg, live = _groups(len(lim))
    has = np.bincount(seg[live], minlength=7) > 0
    for take_min in (True, False):
        p = D.seg_minmax128(_port(lim), _port(live), _port(seg), 7, take_min)
        j = JD.seg_minmax128(jnp.asarray(lim), jnp.asarray(live),
                             jnp.asarray(seg), 7, take_min)
        _eq(p.numpy()[has], np.asarray(j)[has])


def _case_lift64():
    rng = np.random.default_rng(4)
    x = np.concatenate([[0, 1, -1, 2**63 - 1, -(2**63)],
                        rng.integers(-(2**63), 2**63 - 1, 300)]
                       ).astype(np.int64)
    _eq(D.lift64(_port(x)), JD.lift64(jnp.asarray(x)))


def _case_exceeds_digits():
    vals = _values() + [10**38, -(10**38), 10**25, 10**25 - 1, -(10**25)]
    lim = _limbs([v if -(2**127) <= v < 2**127 else 0 for v in vals])
    for digits in (38, 25, 19):
        _eq(D.exceeds_digits(_port(lim), digits),
            JD.exceeds_digits(jnp.asarray(lim), digits))


def _case_add128():
    vals = _values()
    a, b = _limbs(vals), _limbs(vals[::-1])
    _eq(D.add128(_port(a), _port(b)), JD.add128(jnp.asarray(a),
                                               jnp.asarray(b)))


def _case_neg128():
    lim = _limbs(_values())
    _eq(D.neg128(_port(lim)), JD.neg128(jnp.asarray(lim)))


def _case_abs128():
    lim = _limbs(_values())
    _eq(D.abs128(_port(lim)), JD.abs128(jnp.asarray(lim)))


def _case_rescale_up():
    lim = _limbs(_values())
    for f in (10, 1000, 10 ** 9):
        _eq(D.rescale_up(_port(lim), f), JD.rescale_up(jnp.asarray(lim), f))


FUNCTION_CASES = {name[len("_case_"):]: fn for name, fn in globals().items()
                  if name.startswith("_case_")}


@pytest.mark.parametrize("name", sorted(FUNCTION_CASES))
def test_function_matches_jax(name):
    FUNCTION_CASES[name]()


def test_sign_of_hi_at_the_edges():
    """hi wraps into the int64 sign bit exactly when the value is
    negative: at +-2^127 (-2^127 and 2^127 - 1) and at +-10^38."""
    vals = [-(2**127), 2**127 - 1, 10**38, -(10**38), -1, 0]
    hi, lo = D.order_key_pair(_port(_limbs(vals)))
    assert (hi < 0).tolist() == [v < 0 for v in vals]
    assert hi.tolist()[:2] == [-(2**63), 2**63 - 1]
    back = D.from_key_pair(hi, lo)
    _eq(back, _limbs(vals))


def test_limb_sums_do_not_depend_on_row_order():
    """Limb sums are integer adds, exact in any order: the card's atomic
    ``index_add_`` gives the CPU's limbs bit for bit. Here a permutation
    of the rows stands in for the atomics' order."""
    lim = _limbs(_values(2000, 8))
    seg, live = _groups(len(lim), 5, 2)
    base = D.seg_sum128(_port(lim), _port(live), _port(seg), 5)
    perm = np.random.default_rng(1).permutation(len(lim))
    again = D.seg_sum128(_port(lim[perm]), _port(live[perm]),
                         _port(seg[perm]), 5)
    _eq(base[0], again[0])
    _eq(base[1], again[1])


def test_hash_dec128_matches_the_oracle_at_every_byte_length():
    vals = MURMUR_EDGES + [-(2**127), 2**127 - 1, 10**38 - 1]
    lim = _port(_limbs(vals))
    c = DeviceColumn(lim, torch.ones(len(vals), dtype=torch.bool),
                     T.decimal(38, 0))
    got = _hash_dec128(c, _seeds(42, c.validity)).tolist()
    assert got == [_signed32(oracle_hash_decimal(v, 38, 42)) for v in vals]


# ---------------------------------------------------------------------------
# limb lanes through the plumbing
# ---------------------------------------------------------------------------

def test_limb_lanes_cross_the_wire_and_the_spill_tiers(tmp_path):
    t = wide_table(n=300)
    batch, schema = from_arrow(t, device="cpu")
    frame = tser.serialize_batch(batch, schema, "lz4")
    back = tser.deserialize_batch(frame, schema)
    assert torch.equal(back.columns[1].data, batch.columns[1].data)
    _, jschema = jfrom_arrow(t)
    jback = jser.deserialize_batch(frame, jschema)
    np.testing.assert_array_equal(np.asarray(jback.columns[1].data),
                                  batch.columns[1].data.numpy())
    size = batch.size_bytes()
    assert size == batch.capacity * (4 + 1 + 32 + 1)
    for host_limit in (1 << 30, size // 2):        # host, then disk
        cat = tcatalog.BufferCatalog(device_limit=size + 100,
                                     host_limit=host_limit,
                                     spill_dir=str(tmp_path))
        hid = cat.register(batch, schema)
        hid2 = cat.register(from_arrow(wide_table(seed=8, n=300),
                                       device="cpu")[0], schema)
        assert cat.tier_of(hid) is not tcatalog.StorageTier.DEVICE
        got = cat.acquire(hid)
        assert to_arrow(got, schema).equals(t)
        cat.release(hid)
        cat.remove(hid)
        cat.remove(hid2)
        assert cat.total_pinned() == 0


def test_coalesce_and_fused_stage_carry_limbs():
    t = wide_table(n=600)
    bound = lit(d.Decimal("-1000000.0000"), T.decimal(38, 4))

    def plan():
        scan = InMemoryScanExec(t, batch_rows=150, num_slices=4,
                                device="cpu")
        return ProjectExec([col("w"), col("k")], FilterExec(
            col("w") > bound, CoalesceBatchesExec(scan, TargetSize())))
    want = pa.table({"w": t.column("w"), "k": t.column("k")}).filter(
        pa.compute.greater(t.column("w"), pa.scalar(
            d.Decimal("-1000000.0000"), pa.decimal128(38, 4))))
    assert_tables_equal(collect(plan()), want, ignore_order=True)
    scan = InMemoryScanExec(t, device="cpu")
    stage = try_fuse(ProjectExec([col("w"), col("k")],
                                 FilterExec(col("w") > bound, scan)))
    assert stage is not None
    out = stage.run()
    assert tuple(out.columns[0].data.shape[1:]) == (4,)
    assert_tables_equal(to_arrow(out, stage.plan.output_schema), want,
                        ignore_order=True)


def test_mesh_stages_limb_lanes():
    conf = entry.session_conf(8, **entry.ici_conf(8))

    def q(a):
        return a.table(wide_table(n=400), num_slices=8).group_by("k").agg(
            a.Sum(a.col("w")).alias("s"), a.Min(a.col("w")).alias("mn"))
    ses = Session(conf, device="cpu")
    got = ses.collect(q(PORT))
    assert ses.executed_exec_names() == ["MeshStageExec"]
    jses = JSession(conf)
    jses.prepare(q(JAX))
    assert ses.last_plan.lowered == jses.last_plan.lowered
    host = Session(entry.session_conf(8), device="cpu").collect(q(PORT))
    assert_tables_equal(got, host, ignore_order=True, approx_float=False)


def test_parquet_scan_uploads_limbs(tmp_path):
    """A Parquet decimal(38, 4) column reads through pyarrow (outside the
    native decoder's subset, as in the JAX package) and uploads as limbs;
    min/max pruning stays off for decimals."""
    from spark_rapids_tpu.io import read_parquet as jread_parquet
    from spark_rapids_tpu_torch.io import read_parquet
    t = wide_table(n=500)
    path = str(tmp_path / "w.parquet")
    pq.write_table(t, path, row_group_size=128)
    bound = d.Decimal("1000.0000")
    ses = Session({}, device="cpu")
    got = ses.collect(read_parquet([path]).where(
        col("w") > lit(bound, T.decimal(38, 4))).group_by("k").agg(
            Sum(col("w")).alias("s")))
    want = JSession({}).collect(jread_parquet([path]).where(
        jcol("w") > jlit(bound, JT.decimal(38, 4))).group_by("k").agg(
            JSum(jcol("w")).alias("s")))
    assert ses.fell_back() == []
    assert_tables_equal(got, want, ignore_order=True, approx_float=False)


def test_average_and_xxhash64_over_limbs_stay_islands():
    """Average over a decimal and XxHash64 over limbs are refused by the
    JAX gates, so both packages run them on the interpreter; XxHash64 of
    a value past 18 digits raises OverflowError in both (a cause they
    share)."""
    _, ses = _both(lambda a: a.table(wide_table()).group_by("k").agg(
        a.Count().alias("c")))
    ses = Session({}, device="cpu")
    got = ses.collect(table(wide_table()).group_by("k").agg(
        Average(col("w")).alias("a")))
    assert ses.fell_back() == ["CpuFallback[Aggregate]"]
    assert got.schema.field("a").type == pa.decimal128(38, 8)
    with pytest.raises(OverflowError):
        Session({}, device="cpu").collect(table(wide_table()).select(
            XxHash64((col("w"),)).alias("h")))


# ---------------------------------------------------------------------------
# the product of two DECIMAL64 columns past 18 digits: a pinned departure
# ---------------------------------------------------------------------------

PRODUCT_TABLE = pa.table({
    "k": pa.array([0, 0], pa.int32()),
    "a": pa.array([d.Decimal("9999999999999.99"), d.Decimal("1.50")],
                  pa.decimal128(15, 2)),
    "b": pa.array([d.Decimal("9999999999999.99"), d.Decimal("2.00")],
                  pa.decimal128(15, 2))})


def test_wide_product_follows_spark():
    """decimal(15,2) * decimal(15,2) is decimal(31,4). The port refuses it
    on the device (an island) and its interpreter gives Spark's exact
    product and sum. The JAX device computes it in int64 and reports no
    fallback: the sum wraps and the select raises in ``from_limbs_np``;
    the JAX interpreter rounds the product at 28 digits (Python's default
    decimal context) and loses its last 0.0001."""
    def summed(a):
        return a.table(PRODUCT_TABLE).group_by("k").agg(
            a.Sum(a.col("a") * a.col("b")).alias("s"))

    def product(a):
        return a.table(PRODUCT_TABLE).select(
            (a.col("a") * a.col("b")).alias("p"))

    spark_sum = d.Decimal("99999999999999800000000003.0001")
    spark_product = [d.Decimal("99999999999999800000000000.0001"),
                     d.Decimal("3.0000")]
    ses = Session({}, device="cpu")
    assert ses.collect(summed(PORT)).column("s").to_pylist() == [spark_sum]
    assert ses.fell_back() == ["CpuFallback[Aggregate]"]
    assert ses.collect(product(PORT)).column("p").to_pylist() == \
        spark_product
    assert ses.fell_back() == ["CpuFallback[Project]"]
    oracle = Session(ORACLE, device="cpu")
    assert oracle.collect(summed(PORT)).column("s").to_pylist() == \
        [spark_sum]
    jses = JSession({})
    assert jses.collect(summed(JAX)).column("s").to_pylist() == \
        [d.Decimal("507494427030529.3617")]
    assert jses.fell_back() == []
    with pytest.raises(IndexError):
        JSession({}).collect(product(JAX))
    assert JSession(ORACLE).collect(summed(JAX)).column(
        "s").to_pylist() == [d.Decimal("99999999999999800000000003.0000")]


# ---------------------------------------------------------------------------
# TPC-H Q18 in decimals at SF 0.01
# ---------------------------------------------------------------------------

#: Q18's QUANTITY selects no order below about SF 0.1; 200 selects some
QUANTITY = 200


def _jax_q18_decimal_df(customer, orders, lineitem, num_slices):
    big = (jtable(lineitem, num_slices=num_slices).group_by("l_orderkey")
           .agg(JSum(jcol("l_quantity")).alias("sq"))
           .where(JGreaterThan(jcol("sq"), jlit(d.Decimal(QUANTITY),
                                                JT.decimal(3, 0)))))
    return (jtable(customer, num_slices=num_slices)
            .join(jtable(orders, num_slices=num_slices).join(
                big, ["o_orderkey"], ["l_orderkey"], JJoinType.LEFT_SEMI),
                  ["c_custkey"], ["o_custkey"])
            .join(jtable(lineitem, num_slices=num_slices), ["o_orderkey"],
                  ["l_orderkey"])
            .group_by(*entry.Q18_KEYS)
            .agg(JSum(jcol("l_quantity")).alias("sum_qty"))
            .order_by(jdesc(jcol("o_totalprice")), jasc(jcol("o_orderdate")))
            .limit(entry.Q18_LIMIT))


@pytest.mark.parametrize("wide_keys", [False, True], ids=["spec", "wide"])
def test_q18_decimal_matches_jax_and_pyarrow(wide_keys):
    tables = entry.tpch_q18_decimal_tables(0.01, wide_keys=wide_keys)
    key = tables[0].schema.field("c_custkey").type
    assert key == (pa.decimal128(38, 0) if wide_keys else pa.int64())
    assert tables[2].schema.field("l_quantity").type == \
        pa.decimal128(15, 2)
    conf = entry.session_conf(4)
    ses = Session(conf, device="cpu")
    got = ses.collect(entry.q18_decimal_df(*tables, 4, quantity=QUANTITY))
    assert ses.fell_back() == []
    assert got.schema.field("sum_qty").type == pa.decimal128(25, 2)
    want = entry.q18_decimal_reference(*tables, quantity=QUANTITY)
    assert got.num_rows == want.num_rows == entry.Q18_LIMIT
    assert got.schema == want.schema
    assert_tables_equal(got, want, ignore_order=True, approx_float=False)
    assert got.column("o_totalprice").to_pylist() == \
        want.column("o_totalprice").to_pylist()
    jses = JSession(conf)
    jgot = jses.collect(_jax_q18_decimal_df(*tables, 4))
    assert jses.fell_back() == []
    assert_tables_equal(got, jgot, ignore_order=True, approx_float=False)


def test_q18_decimal_tables_keep_the_draws():
    """The decimal tables hold tpch_q18_tables' values: quantities and
    keys exactly, totals rounded half up to the cent."""
    c, o, li = entry.tpch_q18_tables(0.01)
    dc, do, dli = entry.tpch_q18_decimal_tables(0.01, wide_keys=True)
    assert [float(x) for x in dli.column("l_quantity").to_pylist()] == \
        li.column("l_quantity").to_pylist()
    assert [int(x) for x in dc.column("c_custkey").to_pylist()] == \
        c.column("c_custkey").to_pylist()
    assert [int(x) for x in do.column("o_orderkey").to_pylist()] == \
        o.column("o_orderkey").to_pylist()
    cents = [int(x * 100) for x in do.column("o_totalprice").to_pylist()]
    want = np.floor(o.column("o_totalprice").to_numpy() * 100 + 0.5)
    assert cents == want.astype(np.int64).tolist()
