"""The port's memory runtime against the JAX package's: the buffer catalog
(the cases of ``tests/test_memory.py`` that need no Session or semaphore,
run on both catalogs with the same batches: same tiers, same counters),
a register / spill to host and disk / reacquire round trip bit for bit,
frames that each package writes read back on the other for every column
kind the port carries (nulls included) and every codec, and the OOM
classification of ``torch.OutOfMemoryError``. Every test ends with no pins
and no handles left in the catalogs it used."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.batch import from_arrow as jax_from_arrow
from spark_rapids_tpu.batch import to_arrow as jax_to_arrow
from spark_rapids_tpu.memory import catalog as jcatalog
from spark_rapids_tpu.shuffle import serializer as jser
from spark_rapids_tpu_torch import batch as tb
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.exec import collect
from spark_rapids_tpu_torch.memory import catalog as tcatalog
from spark_rapids_tpu_torch.memory import is_retryable_oom
from spark_rapids_tpu_torch.memory.retry import FinalOOMError
from spark_rapids_tpu_torch.shuffle import serializer as tser

from harness.asserts import assert_tables_equal
from harness.data_gen import (BooleanGen, DateGen, DoubleGen, IntegerGen,
                              LongGen, StringGen, gen_table)

PACKAGES = {"jax": (jcatalog, lambda t: jax_from_arrow(t)),
            "torch": (tcatalog, lambda t: tb.from_arrow(t, device="cpu"))}


def make_table(n=256, seed=0):
    return gen_table([("a", IntegerGen()), ("s", StringGen(max_len=8))],
                     n=n, seed=seed)


def all_kinds(n=300, seed=1):
    """Every column kind the port carries, each with nulls."""
    return gen_table([("i", IntegerGen()), ("l", LongGen()),
                      ("f", DoubleGen()), ("d", DateGen()),
                      ("b", BooleanGen()), ("s", StringGen(max_len=8))],
                     n=n, seed=seed)


def _to_arrow(pkg, batch, schema):
    return (jax_to_arrow if pkg == "jax" else tb.to_arrow)(batch, schema)


def _assert_clean(cat):
    assert cat.total_pinned() == 0, cat.dump_state()
    assert not cat._entries, cat.dump_state()


def _lanes(batch):
    """Every lane of a port batch as numpy arrays, padding included."""
    out = []
    for c in batch.columns:
        out += [c.data.numpy(), c.validity.numpy()]
        if c.lengths is not None:
            out.append(c.lengths.numpy())
    return out + [batch.num_rows.numpy()]


# ---------------------------------------------------------------------------
# The cases of tests/test_memory.py, on both catalogs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_register_reserves_budget(pkg, tmp_path):
    mod, load = PACKAGES[pkg]
    batch, schema = load(make_table())
    cat = mod.BufferCatalog(device_limit=1 << 20, spill_dir=str(tmp_path))
    hid = cat.register(batch, schema)
    assert cat.device_used == batch.size_bytes()
    cat.remove(hid)
    assert cat.device_used == 0
    _assert_clean(cat)


def test_size_bytes_equal_across_packages():
    """Both packages charge a batch the same bytes: payload, validity and
    string lengths."""
    t = all_kinds()
    assert (tb.from_arrow(t, device="cpu")[0].size_bytes()
            == jax_from_arrow(t)[0].size_bytes())


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_spill_to_host_and_back(pkg, tmp_path):
    mod, load = PACKAGES[pkg]
    t = make_table()
    batch, schema = load(t)
    size = batch.size_bytes()
    cat = mod.BufferCatalog(device_limit=size + 100, host_limit=1 << 30,
                            spill_dir=str(tmp_path))
    hid = cat.register(batch, schema)
    hid2 = cat.register(load(make_table(seed=1))[0], schema)
    assert cat.tier_of(hid) is mod.StorageTier.HOST
    assert cat.spilled_to_host == size
    got = cat.acquire(hid)          # unspills it and spills the other
    assert cat.tier_of(hid) is mod.StorageTier.DEVICE
    assert cat.tier_of(hid2) is mod.StorageTier.HOST
    assert_tables_equal(_to_arrow(pkg, got, schema), t)
    cat.release(hid)
    cat.remove(hid)
    cat.remove(hid2)
    _assert_clean(cat)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_overflow_to_disk_and_back(pkg, tmp_path):
    mod, load = PACKAGES[pkg]
    t = make_table()
    batch, schema = load(t)
    size = batch.size_bytes()
    cat = mod.BufferCatalog(device_limit=size + 100, host_limit=size // 2,
                            spill_dir=str(tmp_path))
    hid = cat.register(batch, schema)
    hid2 = cat.register(load(make_table(seed=1))[0], schema)
    assert cat.tier_of(hid) is mod.StorageTier.DISK   # host tier too small
    assert cat.spilled_to_disk == size
    assert len(list(tmp_path.iterdir())) == 1
    got = cat.acquire(hid)          # and the other goes to disk in turn
    assert_tables_equal(_to_arrow(pkg, got, schema), t)
    assert cat.tier_of(hid2) is mod.StorageTier.DISK
    assert len(list(tmp_path.iterdir())) == 1
    cat.release(hid)
    cat.remove(hid)
    cat.remove(hid2)
    _assert_clean(cat)
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_pinned_buffers_do_not_spill(pkg, tmp_path):
    mod, load = PACKAGES[pkg]
    batch, schema = load(make_table())
    size = batch.size_bytes()
    cat = mod.BufferCatalog(device_limit=int(size * 1.5),
                            spill_dir=str(tmp_path))
    hid = cat.register(batch, schema)
    cat.acquire(hid)   # pin
    batch2 = load(make_table(seed=1))[0]
    with pytest.raises(mod.OutOfBudgetError):
        cat.register(batch2, schema)
    cat.release(hid)   # unpin -> now it can spill
    hid2 = cat.register(batch2, schema)
    assert cat.tier_of(hid) is mod.StorageTier.HOST
    cat.remove(hid)
    cat.remove(hid2)
    _assert_clean(cat)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_spill_priority_order(pkg, tmp_path):
    mod, load = PACKAGES[pkg]
    b1, schema = load(make_table(seed=1))
    b2 = load(make_table(seed=2))[0]
    cat = mod.BufferCatalog(device_limit=int(b1.size_bytes() * 2.5),
                            spill_dir=str(tmp_path))
    low = cat.register(b1, schema, priority=0)
    high = cat.register(b2, schema, priority=100)
    mid = cat.register(load(make_table(seed=3))[0], schema, priority=50)
    assert cat.tier_of(low) is mod.StorageTier.HOST     # lowest first
    assert cat.tier_of(high) is mod.StorageTier.DEVICE
    for h in (low, high, mid):
        cat.remove(h)
    _assert_clean(cat)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_spillable_batch_wrapper(pkg, tmp_path):
    mod, load = PACKAGES[pkg]
    t = make_table()
    batch, schema = load(t)
    cat = mod.BufferCatalog(device_limit=1 << 30, spill_dir=str(tmp_path))
    with mod.SpillableBatch(cat, batch, schema) as sb:
        assert_tables_equal(_to_arrow(pkg, sb.get(), schema), t)
        sb.done_with()
    assert cat.device_used == 0
    _assert_clean(cat)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_leak_check_names_origin(pkg):
    mod, load = PACKAGES[pkg]
    cat = mod.BufferCatalog(device_limit=1 << 24, track_leaks=True)
    b, s = load(pa.table({"x": pa.array([1, 2, 3], pa.int64())}))
    sb = mod.SpillableBatch(cat, b, s)
    leaks = cat.leak_check()
    assert len(leaks) == 1 and "test_torch_memory" in leaks[0], leaks
    with pytest.raises(mod.LeakError, match="leaked"):
        cat.assert_no_leaks()
    sb.close()
    cat.assert_no_leaks()
    _assert_clean(cat)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_double_release_raises(pkg):
    mod, load = PACKAGES[pkg]
    cat = mod.BufferCatalog(device_limit=1 << 24)
    b, s = load(pa.table({"x": pa.array([1], pa.int64())}))
    sb = mod.SpillableBatch(cat, b, s)
    sb.get()
    sb.done_with()
    with pytest.raises(mod.DoubleReleaseError):
        sb.done_with()
    sb.close()
    _assert_clean(cat)


def test_tier_summary_matches_jax(tmp_path):
    """The same registrations give the same tier summary on both."""
    summaries = []
    for pkg, (mod, load) in PACKAGES.items():
        b1, schema = load(make_table(seed=1))
        cat = mod.BufferCatalog(device_limit=int(b1.size_bytes() * 1.5),
                                host_limit=1 << 20,
                                spill_dir=str(tmp_path / pkg))
        hids = [cat.register(load(make_table(seed=s))[0], schema)
                for s in (1, 2, 3)]
        cat.acquire(hids[-1])
        summaries.append(cat.tier_summary())
        cat.release(hids[-1])
        for h in hids:
            cat.remove(h)
        _assert_clean(cat)
    assert summaries[0] == summaries[1]
    assert "pinned_handles=1" in summaries[1]


def test_query_leaves_no_catalog_leaks():
    """After collect() closes the plan, the catalog holds nothing from the
    query's exchanges, broadcast, aggregates, joins or sort."""
    cat = tcatalog.BufferCatalog(device_limit=1 << 30)
    c, o, li = entry.tpch_q3_tables(0.001)
    for broadcast in (False, True):
        plan = entry.q3_plan(c, o, li, 2, 3, broadcast, device="cpu")
        for scan in _leaves(plan):
            scan._catalog = cat
        collect(plan)
        _assert_clean(cat)


def _leaves(plan):
    if not plan.children:
        return [plan]
    return [s for c in plan.children for s in _leaves(c)]


def test_default_budget_on_the_cpu_is_8_gib():
    cat = tcatalog.device_budget("cpu")
    assert cat is tcatalog.device_budget(torch.device("cpu"))
    assert cat.device_limit == 8 << 30 == jcatalog.BufferCatalog().device_limit
    assert cat.host_limit == 4 << 30


# ---------------------------------------------------------------------------
# Register, spill to host and disk, reacquire: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["HOST", "DISK"])
def test_spill_round_trip_is_bit_exact(tier, tmp_path):
    """Every lane of every column, padding included, comes back as it was
    registered, through the host tier or through a frame on disk; the
    port's spilled bytes match the JAX catalog's for the same batches."""
    t = all_kinds()
    spilled = {}
    for pkg, (mod, load) in PACKAGES.items():
        batch, schema = load(t)
        size = batch.size_bytes()
        host_limit = (1 << 30) if tier == "HOST" else size // 2
        cat = mod.BufferCatalog(device_limit=size + 100,
                                host_limit=host_limit,
                                spill_dir=str(tmp_path / pkg))
        before = _lanes(batch) if pkg == "torch" else None
        hid = cat.register(batch, schema)
        other = cat.register(load(all_kinds(seed=2))[0], schema)
        assert cat.tier_of(hid) is getattr(mod.StorageTier, tier)
        spilled[pkg] = (cat.spilled_to_host, cat.spilled_to_disk)
        got = cat.acquire(hid)
        assert cat.tier_of(hid) is mod.StorageTier.DEVICE
        if pkg == "torch":
            for a, b in zip(_lanes(got), before):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        assert_tables_equal(_to_arrow(pkg, got, schema), t,
                            approx_float=False)
        cat.release(hid)
        cat.remove(hid)
        cat.remove(other)
        _assert_clean(cat)
    assert spilled["torch"] == spilled["jax"]


def test_registered_pieces_own_their_storage():
    """A spill frees memory only if the catalog entry holds tensors that own
    their storage: every exchange piece's tensors are as large as the bytes
    the catalog charges for them."""
    from spark_rapids_tpu_torch.exec import InMemoryScanExec
    from spark_rapids_tpu_torch.expressions import col
    from spark_rapids_tpu_torch.shuffle import (HashPartitioning,
                                                ShuffleExchangeExec)
    cat = tcatalog.BufferCatalog(device_limit=1 << 30)
    t = all_kinds(2000)
    ex = ShuffleExchangeExec(HashPartitioning([col("l")], 3),
                             InMemoryScanExec(t, batch_rows=700,
                                              device="cpu", catalog=cat))
    pieces = [sb for part in ex._materialize() for sb, _ in part]
    assert len(pieces) == 9
    for sb in pieces:
        batch = cat._entries[sb.hid].batch
        storages = {}
        for c in batch.columns:
            for x in (c.data, c.validity, c.lengths):
                if x is not None:
                    assert x.untyped_storage().nbytes() == \
                        x.numel() * x.element_size()
                    storages[x.untyped_storage().data_ptr()] = \
                        x.untyped_storage().nbytes()
        assert sum(storages.values()) == batch.size_bytes() \
            == cat._entries[sb.hid].size
    ex.close()
    _assert_clean(cat)


# ---------------------------------------------------------------------------
# Frames across the two packages
# ---------------------------------------------------------------------------

CODECS = ["none", "lz4", "zstd"]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_frames_read_back_across_packages(writer, codec):
    """A frame either package writes decodes on the other to the same
    lanes; every kind, with nulls; strings at the scan width."""
    t = all_kinds()
    pb, ps = tb.from_arrow(t, device="cpu")
    jb, js = jax_from_arrow(t)
    if writer == "torch":
        frame = tser.serialize_batch(pb, ps, codec)
        back = jser.deserialize_batch(frame, js)
        assert_tables_equal(jax_to_arrow(back, js), t, approx_float=False)
        np.testing.assert_array_equal(np.asarray(back.columns[5].data),
                                      pb.columns[5].data.numpy())
    else:
        frame = jser.serialize_batch(jb, js, codec)
        back = tser.deserialize_batch(frame, ps)
        assert_tables_equal(tb.to_arrow(back, ps), t, approx_float=False)
        for a, b in zip(_lanes(back), _lanes(pb)):
            np.testing.assert_array_equal(a, b)
    arrays, n = jser.deserialize_host(frame)
    parrays, pn = tser.deserialize_host(frame)
    assert n == pn == t.num_rows
    assert sorted(arrays) == sorted(parrays)
    for k in arrays:
        assert arrays[k].dtype == parrays[k].dtype
        np.testing.assert_array_equal(arrays[k], parrays[k])


def test_host_frames_match_byte_for_byte():
    """Uncompressed, the two packages write the same bytes for the same
    named arrays; a damaged frame fails its CRC on both."""
    rng = np.random.default_rng(5)
    arrays = {"d0": rng.integers(-9, 9, 40).astype(np.int64),
              "v0": rng.random(40) < 0.8,
              "d1": rng.integers(0, 255, (40, 8)).astype(np.uint8),
              "n": np.array([37], np.int32)}
    frame = tser.serialize_host(arrays, 37, "none")
    assert frame == jser.serialize_host(arrays, 37, "none")
    bad = bytearray(frame)
    bad[-1] ^= 0xFF
    with pytest.raises(tser.FrameChecksumError):
        tser.deserialize_host(bytes(bad))
    with pytest.raises(jser.FrameChecksumError):
        jser.deserialize_host(bytes(bad))


def test_host_table_packs_every_lane():
    """The spill carrier: one buffer, every lane and the row count, views
    equal to the batch's lanes, back to a batch equal to the first."""
    t = all_kinds()
    pb, ps = tb.from_arrow(t, device="cpu")
    table = tser.HostTable.pack(pb)
    arrays = table.arrays()
    assert int(arrays["n"][0]) == t.num_rows
    assert set(arrays) == set(tser.batch_to_arrays(pb)) | {"n"}
    back = table.to_device(ps, torch.device("cpu"))
    for a, b in zip(_lanes(back), _lanes(pb)):
        np.testing.assert_array_equal(a, b)
    assert_tables_equal(tb.to_arrow(back, ps), t, approx_float=False)


# ---------------------------------------------------------------------------
# OOM classification
# ---------------------------------------------------------------------------

def test_torch_oom_is_retryable():
    assert is_retryable_oom(torch.OutOfMemoryError("CUDA out of memory"))
    assert is_retryable_oom(torch.cuda.OutOfMemoryError("CUDA oom"))
    assert is_retryable_oom(tcatalog.OutOfBudgetError("cannot reserve"))
    assert is_retryable_oom(RuntimeError("RESOURCE_EXHAUSTED: out of HBM"))
    assert not is_retryable_oom(FinalOOMError("gave up"))
    assert not is_retryable_oom(MemoryError("host oom"))
    assert not is_retryable_oom(ValueError("boom"))
