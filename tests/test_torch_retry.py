"""The port's OOM retry loop against the JAX package's: the cases of
``tests/test_retry.py`` that need no Session, semaphore, prefetch pipeline
or wire export, each run on both packages with the same inputs and held to
the same outcome (results bit for bit, retry and split counts, injection
schedules), and each ending with no pins and no handles left."""

import os

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.batch import from_arrow as jax_from_arrow
from spark_rapids_tpu.batch import to_arrow as jax_to_arrow
from spark_rapids_tpu.exec import InMemoryScanExec as JScan
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.memory import catalog as jcatalog
from spark_rapids_tpu.memory import retry as jretry
from spark_rapids_tpu.shuffle import HashPartitioning as JHash
from spark_rapids_tpu.shuffle import ShuffleExchangeExec as JExchange
from spark_rapids_tpu_torch import batch as tb
from spark_rapids_tpu_torch.exec import InMemoryScanExec
from spark_rapids_tpu_torch.expressions import col
from spark_rapids_tpu_torch.memory import catalog as tcatalog
from spark_rapids_tpu_torch.memory import retry as tretry
from spark_rapids_tpu_torch.shuffle import (HashPartitioning,
                                            ShuffleExchangeExec)

from harness.asserts import assert_tables_equal

PKGS = ["jax", "torch"]


def _mods(pkg):
    return (jcatalog, jretry) if pkg == "jax" else (tcatalog, tretry)


def _table(n=1000, seed=7):
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, 50, n).astype(np.int64),
                     "v": rng.integers(-100, 100, n).astype(np.int64)})


def _batch(pkg, n=1000, seed=7):
    t = _table(n, seed)
    if pkg == "jax":
        b, schema = jax_from_arrow(t)
    else:
        b, schema = tb.from_arrow(t, device="cpu")
    return t, b, schema


def _to_arrow(pkg, b, schema):
    return (jax_to_arrow if pkg == "jax" else tb.to_arrow)(b, schema)


def _catalog(pkg, tmp_path):
    cat_mod, _ = _mods(pkg)
    return cat_mod.BufferCatalog(device_limit=1 << 24,
                                 spill_dir=str(tmp_path / pkg))


def _assert_clean(cat):
    assert cat.total_pinned() == 0, cat.dump_state()
    assert not cat._entries, cat.dump_state()


@pytest.fixture(autouse=True)
def _injection_off_after():
    yield
    for mod in (jretry, tretry):
        mod.injector().configure("")
        assert not mod.injector().enabled


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_retryable_classification(pkg):
    cat_mod, r = _mods(pkg)
    assert r.is_retryable_oom(cat_mod.OutOfBudgetError("cannot reserve"))
    assert r.is_retryable_oom(r.InjectedOOMError("injected OOM at x"))
    assert r.is_retryable_oom(RuntimeError(
        "RESOURCE_EXHAUSTED: XLA:TPU ran out of memory"))
    assert r.is_retryable_oom(RuntimeError("HBM OOM allocating 2GiB"))
    assert not r.is_retryable_oom(ValueError("boom"))
    assert not r.is_retryable_oom(MemoryError("host oom"))
    assert not r.is_retryable_oom(r.FinalOOMError("gave up"))
    assert r.RETRYABLE_OOM_MARKERS == jretry.RETRYABLE_OOM_MARKERS


# ---------------------------------------------------------------------------
# retry loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_no_split_retries_then_succeeds(pkg, tmp_path):
    cat_mod, r = _mods(pkg)
    cat = _catalog(pkg, tmp_path)
    calls = [0]

    def body():
        calls[0] += 1
        if calls[0] < 3:
            raise cat_mod.OutOfBudgetError("synthetic")
        return "ok"

    m0 = r.metrics().snapshot()
    assert r.with_retry_no_split(body, catalog=cat, name="t") == "ok"
    assert calls[0] == 3
    assert r.metrics().snapshot()["retryCount"] - m0["retryCount"] == 2


@pytest.mark.parametrize("pkg", PKGS)
def test_non_retryable_propagates_immediately(pkg, tmp_path):
    _, r = _mods(pkg)
    cat = _catalog(pkg, tmp_path)
    calls = [0]

    def body():
        calls[0] += 1
        raise ValueError("not an oom")

    with pytest.raises(ValueError):
        r.with_retry_no_split(body, catalog=cat, name="t")
    assert calls[0] == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_retry_disabled_propagates(pkg, tmp_path):
    cat_mod, r = _mods(pkg)
    cat = _catalog(pkg, tmp_path)

    def body():
        raise cat_mod.OutOfBudgetError("x")

    with r.retry_policy(enabled=False):
        with pytest.raises(cat_mod.OutOfBudgetError):
            r.with_retry_no_split(body, catalog=cat, name="t")


@pytest.mark.parametrize("pkg", PKGS)
def test_final_oom_after_max_retries_writes_dump(pkg, tmp_path):
    cat_mod, r = _mods(pkg)
    cat = _catalog(pkg, tmp_path)
    dump_dir = str(tmp_path / "dumps")

    def body():
        raise cat_mod.OutOfBudgetError("always")

    with r.retry_policy(dump_dir=dump_dir, max_retries=2):
        with pytest.raises(r.FinalOOMError) as ei:
            r.with_retry_no_split(body, catalog=cat, name="always-oom")
    assert ei.value.dump_path and os.path.exists(ei.value.dump_path)
    text = open(ei.value.dump_path).read()
    assert "catalog tier occupancy" in text
    assert "always-oom" in text
    assert "retry/split counts per operator" in text


@pytest.mark.parametrize("pkg", PKGS)
def test_retry_releases_pins_and_spills(pkg, tmp_path):
    """A body that pins a handle and OOMs finds it unpinned (and spilled)
    on the retry."""
    cat_mod, r = _mods(pkg)
    t, b, schema = _batch(pkg)
    cat = _catalog(pkg, tmp_path)
    inp = r.SpillableInput.from_batch(b, schema, cat)
    attempts = [0]

    def body():
        got = inp.acquire()          # pin without releasing
        attempts[0] += 1
        if attempts[0] == 1:
            assert cat.total_pinned() == 1
            raise cat_mod.OutOfBudgetError("mid-use")
        return got

    spill0 = cat.spilled_to_host
    got = r.with_retry_no_split(body, catalog=cat, name="t")
    assert cat.total_pinned() == 1
    assert cat.spilled_to_host > spill0, "recovery never forced a spill"
    assert_tables_equal(_to_arrow(pkg, got, schema), t)
    inp.release()
    inp.close()
    _assert_clean(cat)


def _split_run(pkg, tmp_path, body_ooms, split=None):
    """Run with_retry over a 2000-row input whose body OOMs ``body_ooms``
    times while the input has more than 1000 rows."""
    cat_mod, r = _mods(pkg)
    t, b, schema = _batch(pkg, 2000)
    cat = _catalog(pkg, tmp_path)
    inp = r.SpillableInput.from_batch(b, schema, cat)
    oomed = [0]

    def body(item):
        got = item.acquire()
        try:
            if item.rows > 1000 and oomed[0] < body_ooms:
                oomed[0] += 1
                raise cat_mod.OutOfBudgetError("too big")
            return _to_arrow(pkg, got, schema)
        finally:
            item.release()

    m0 = r.metrics().snapshot()
    with r.retry_policy(split_floor_rows=64):
        outs = list(r.with_retry(inp, body,
                                 split=split or r.split_input_halves,
                                 catalog=cat, name="t"))
    splits = (r.metrics().snapshot()["splitAndRetryCount"]
              - m0["splitAndRetryCount"])
    _assert_clean(cat)
    return t, outs, splits


@pytest.mark.parametrize("pkg", PKGS)
def test_split_and_retry_bit_for_bit(pkg, tmp_path):
    """Two OOMs on the same input halve it; the halves' results
    concatenate to the no-OOM output, in order."""
    t, outs, splits = _split_run(pkg, tmp_path, 2)
    assert len(outs) == 2 and splits == 1
    assert_tables_equal(pa.concat_tables(outs), t, ignore_order=False,
                        approx_float=False)


@pytest.mark.parametrize("pkg", PKGS)
def test_split_floor_blocks_split_then_final_oom(pkg, tmp_path):
    cat_mod, r = _mods(pkg)
    t, b, schema = _batch(pkg, 500)
    cat = _catalog(pkg, tmp_path)
    inp = r.SpillableInput.from_batch(b, schema, cat)

    def body(item):
        raise cat_mod.OutOfBudgetError("never fits")

    with r.retry_policy(split_floor_rows=1 << 10, max_retries=2):
        with pytest.raises(r.FinalOOMError):
            list(r.with_retry(inp, body, split=r.split_input_halves,
                              catalog=cat, name="t"))
    _assert_clean(cat)


@pytest.mark.parametrize("pkg", PKGS)
def test_split_oom_is_one_more_attempt(pkg, tmp_path):
    """An OOM inside split() re-enters recovery and leaks nothing."""
    cat_mod, r = _mods(pkg)
    split_calls = [0]

    def flaky_split(item):
        split_calls[0] += 1
        if split_calls[0] == 1:
            raise cat_mod.OutOfBudgetError("split itself OOMs")
        return r.split_input_halves(item)

    t, outs, _ = _split_run(pkg, tmp_path, 3, flaky_split)
    assert split_calls[0] == 2
    assert len(outs) == 2
    assert_tables_equal(pa.concat_tables(outs), t, ignore_order=False,
                        approx_float=False)


@pytest.mark.parametrize("pkg", PKGS)
def test_split_closes_left_half_on_right_registration_oom(pkg, tmp_path,
                                                         monkeypatch):
    """Registering the halves is transactional: an OOM on the right half
    closes the left half."""
    cat_mod, r = _mods(pkg)
    t, b, schema = _batch(pkg, 2000)
    cat = _catalog(pkg, tmp_path)
    inp = r.SpillableInput.from_batch(b, schema, cat)
    orig = r.SpillableInput.from_batch.__func__
    calls = [0]

    def flaky(cls, *args, **kwargs):
        calls[0] += 1
        if calls[0] == 2:
            raise cat_mod.OutOfBudgetError("right half registration")
        return orig(cls, *args, **kwargs)

    monkeypatch.setattr(r.SpillableInput, "from_batch", classmethod(flaky))
    with pytest.raises(cat_mod.OutOfBudgetError):
        inp.split(64)
    assert calls[0] == 2
    assert cat.total_pinned() == 0
    inp.close()
    _assert_clean(cat)


def _exchange(pkg, tmp_path, n=4000, parts=4, scan_cls=None):
    cat = _catalog(pkg, tmp_path)
    t = _table(n, seed=13)
    if pkg == "jax":
        scan = (scan_cls or JScan)(t, num_slices=2, batch_rows=n // 4)
        ex = JExchange(JHash([jcol("k")], parts), scan, catalog=cat)
    else:
        scan = (scan_cls or InMemoryScanExec)(
            t, num_slices=2, batch_rows=n // 4, device="cpu", catalog=cat)
        ex = ShuffleExchangeExec(HashPartitioning([col("k")], parts), scan)
    return t, ex, cat


def _read_all(pkg, ex):
    seen = []
    for p in range(ex.num_partitions):
        for b in ex.execute_partition(p):
            tab = _to_arrow(pkg, b, ex.output_schema)
            seen.extend(zip(tab.column("k").to_pylist(),
                            tab.column("v").to_pylist()))
    return sorted(seen)


def _expected(t):
    return sorted(zip(t.column("k").to_pylist(), t.column("v").to_pylist()))


@pytest.mark.parametrize("pkg", PKGS)
def test_exchange_write_midstream_failure_frees_staged_pieces(pkg,
                                                             tmp_path):
    """A failure after earlier batches staged their pieces frees them."""
    base = JScan if pkg == "jax" else InMemoryScanExec

    class Boom(base):
        def do_execute_partition(self, p):
            it = super().do_execute_partition(p)
            yield next(it)
            raise ValueError("downstream failure")

    t, ex, cat = _exchange(pkg, tmp_path, scan_cls=Boom)
    with pytest.raises(ValueError):
        for _ in ex.execute_partition(0):
            pass
    _assert_clean(cat)


@pytest.mark.parametrize("pkg", PKGS)
def test_admit_all_closes_on_midway_failure(pkg, tmp_path):
    """admit_all is transactional: a failed admit k of n closes the
    handles admitted before it."""
    _, r = _mods(pkg)
    cat = _catalog(pkg, tmp_path)
    _, b1, schema = _batch(pkg, 100, seed=1)
    _, b2, _ = _batch(pkg, 100, seed=2)
    with r.retry_policy(enabled=False):
        with r.oom_injection("every-1", skip_count=1):
            with pytest.raises(r.InjectedOOMError):
                r.admit_all([b1, b2], schema, cat, name="t")
    _assert_clean(cat)


# ---------------------------------------------------------------------------
# fault injection: the same schedules as the JAX package's injector
# ---------------------------------------------------------------------------

def _schedule(r, mode, n, **kw):
    with r.oom_injection(mode, **kw) as inj:
        fired = []
        for _ in range(n):
            try:
                inj.check("site")
                fired.append(False)
            except r.InjectedOOMError:
                fired.append(True)
        return fired


@pytest.mark.parametrize("mode,kw", [
    ("every-3", {}), ("every-1", {"skip_count": 3}),
    ("every-1", {"oom_count": 2}), ("random-0.5", {"seed": 11}),
    ("random", {"seed": 12})], ids=["every-3", "skip", "oom-count",
                                    "random-0.5", "random"])
def test_injector_schedules_match_jax(mode, kw):
    got = _schedule(tretry, mode, 40, **kw)
    assert got == _schedule(jretry, mode, 40, **kw)
    assert any(got)


def test_injector_every_n_deterministic():
    assert _schedule(tretry, "every-3", 9) == [
        False, False, True, False, False, False, True, False, False]


def test_injector_random_seed_replays():
    assert _schedule(tretry, "random-0.5", 50, seed=11) == \
        _schedule(tretry, "random-0.5", 50, seed=11)
    assert _schedule(tretry, "random-0.5", 50, seed=11) != \
        _schedule(tretry, "random-0.5", 50, seed=12)


def test_injector_oom_count_consecutive():
    with tretry.oom_injection("every-1", oom_count=2) as inj:
        with pytest.raises(tretry.InjectedOOMError):
            inj.check("s")
        with pytest.raises(tretry.InjectedOOMError):
            inj.check("s")          # pending consecutive throw
        inj.check("s")              # free pass after the sequence
        with pytest.raises(tretry.InjectedOOMError):
            inj.check("s")          # counting resumed


def test_apply_session_conf_configures_policy_and_injection():
    conf = {"spark.rapids.tpu.test.injectOOM.mode": "every-2",
            "spark.rapids.tpu.retry.maxRetries": "5",
            "spark.rapids.tpu.retry.splitFloorRows": 64,
            "spark.rapids.tpu.sql.adaptive.enabled": False}
    tretry.apply_session_conf(conf)
    try:
        assert tretry.injector().enabled
        assert tretry._POLICY.max_retries == 5
        assert tretry._POLICY.split_floor_rows == 64
    finally:
        tretry.apply_session_conf({})
    assert not tretry.injector().enabled
    assert tretry._POLICY.max_retries == 8


@pytest.mark.parametrize("pkg", PKGS)
def test_injection_through_catalog_reserve_retried(pkg, tmp_path):
    """every-1 at catalog.reserve: every registration OOMs once and the
    retry loop recovers each time."""
    _, r = _mods(pkg)
    cat = _catalog(pkg, tmp_path)
    t, b, schema = _batch(pkg)
    m0 = r.metrics().snapshot()
    with r.oom_injection("every-1"):
        inp = r.SpillableInput.admit(b, schema, cat, name="t")
    assert r.metrics().snapshot()["retryCount"] > m0["retryCount"]
    got = r.with_retry_no_split(inp.acquire, catalog=cat, name="t")
    assert_tables_equal(_to_arrow(pkg, got, schema), t)
    inp.release()
    inp.close()
    _assert_clean(cat)


# ---------------------------------------------------------------------------
# the exchange's read pin loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_exchange_mid_pin_oom_unpins_before_propagating(pkg, tmp_path):
    """OOM at pin k of n in the read loop, retry off: the error propagates,
    every piece already pinned is unpinned."""
    _, r = _mods(pkg)
    t, ex, cat = _exchange(pkg, tmp_path)
    parts = ex._materialize()
    assert cat.total_pinned() == 0
    target = next(p for p, pieces in enumerate(parts) if len(pieces) >= 2)
    with r.retry_policy(enabled=False):
        with r.oom_injection("every-1", skip_count=1):
            with pytest.raises(r.InjectedOOMError):
                for _ in ex.execute_partition(target):
                    pass
    assert cat.total_pinned() == 0, cat.dump_state()
    ex.close()
    _assert_clean(cat)


@pytest.mark.parametrize("pkg", PKGS)
def test_exchange_read_retries_injected_pin_oom(pkg, tmp_path):
    """Same fault with retry on: every row is read, once."""
    _, r = _mods(pkg)
    t, ex, cat = _exchange(pkg, tmp_path)
    with r.oom_injection("every-1", skip_count=5):
        seen = _read_all(pkg, ex)
    assert seen == _expected(t)
    ex.close()
    _assert_clean(cat)


@pytest.mark.parametrize("mode", ["every-1", "every-3"])
def test_exchange_under_injection_matches_jax(mode, tmp_path):
    """The whole exchange (write with its admit, split and register
    sites, then the reads) under an injection schedule gives the clean
    rows, on both packages, and leaves both catalogs clean."""
    for pkg in PKGS:
        _, r = _mods(pkg)
        t, ex, cat = _exchange(pkg, tmp_path / mode)
        m0 = r.metrics().snapshot()
        with r.oom_injection(mode):
            seen = _read_all(pkg, ex)
        assert seen == _expected(t)
        assert r.metrics().snapshot()["retryCount"] > m0["retryCount"]
        ex.close()
        _assert_clean(cat)
