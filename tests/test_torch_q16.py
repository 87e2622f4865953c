"""The string slices as a whole: the part stage of TPC-H Q16 and the whole
of Q16 through the port on the CPU against the JAX Session (the same
physical tree, the same explain) and against pyarrow, exactly (every
output column is a string or an integer); and the guards that keep the
slices' entry points and modules free of JAX and off a silent CPU
fallback.

The JAX Session's ``table()`` takes no string width and refuses a value
over 64 bytes, so whole Q16 compares with it on tables whose
``s_comment`` is cut to 64 bytes; the full-width tables are held against
pyarrow. Each JAX Session runs once."""

import pathlib
import subprocess
import sys

import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

from spark_rapids_tpu.exec.sort import SortOrder as JSortOrder
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions.aggregates import Count
from spark_rapids_tpu.expressions.boolean import And as JAnd
from spark_rapids_tpu.expressions.comparison import EqualTo as JEqualTo
from spark_rapids_tpu.expressions.comparison import In as JIn
from spark_rapids_tpu.expressions.comparison import Not as JNot
from spark_rapids_tpu.expressions.regex import Like as JLike
from spark_rapids_tpu.expressions.strings import startswith as jstartswith
from spark_rapids_tpu.exec.join import JoinType as JJoinType
from spark_rapids_tpu.plan import Session, table
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.exec import collect
from spark_rapids_tpu_torch.plan import Session as TSession

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, SLICES = 4000, 4


def _jax_part_condition():
    return JAnd(JAnd(JNot(JEqualTo(jcol("p_brand"), jlit(entry.Q16_BRAND))),
                     JNot(jstartswith(jcol("p_type"),
                                      entry.Q16_TYPE_PREFIX))),
                JIn(jcol("p_size"), entry.Q16_SIZES))


def _jax_q16_part(t, num_slices):
    cond = _jax_part_condition()
    df = (table(t, num_slices=num_slices,
                batch_rows=-(-t.num_rows // num_slices))
          .where(cond)
          .group_by(*entry.Q16_KEYS)
          .agg(Count().alias("part_cnt"))
          .order_by(JSortOrder(jcol("part_cnt"), True),
                    *[JSortOrder(jcol(k)) for k in entry.Q16_KEYS]))
    ses = Session({"spark.rapids.tpu.sql.incompatibleOps.enabled": True})
    return ses.collect(df), ses.executed_exec_names()


@pytest.fixture(scope="module")
def q16_jax():
    t = entry.part_table(N)
    result, names = _jax_q16_part(t, SLICES)
    return t, result, names


def test_q16_part_matches_jax_session_and_pyarrow(q16_jax):
    t, jax_result, _ = q16_jax
    got = entry.run_q16_part(t, num_slices=SLICES, shuffle_partitions=8,
                             device="cpu")
    assert got.schema == pa.schema([("p_brand", pa.string()),
                                    ("p_type", pa.string()),
                                    ("p_size", pa.int32()),
                                    ("part_cnt", pa.int64())])
    assert got.num_rows > 500
    assert got.equals(jax_result)
    assert got.equals(entry.q16_part_reference(t))


def test_q16_part_plan_is_the_jax_planners_tree(q16_jax):
    t, _, jax_names = q16_jax
    plan = entry.q16_part_plan(t, num_slices=SLICES, device="cpu")
    assert plan.exec_names() == jax_names == [
        "SortExec", "HashAggregateExec", "ShuffleExchangeExec",
        "HashAggregateExec", "CoalesceBatchesExec", "FilterExec",
        "InMemoryScanExec"]


@pytest.mark.parametrize("rows,slices,partitions", [
    (3000, 1, 1), (3001, 3, 5), (0, 2, 4), (50, 8, 8), (20000, 4, 8)])
def test_q16_part_shapes_match_pyarrow(rows, slices, partitions):
    t = entry.part_table(rows, seed=rows)
    got = entry.run_q16_part(t, slices, partitions, device="cpu")
    assert got.equals(entry.q16_part_reference(t))


def test_part_table_follows_the_spec_domains():
    t = entry.part_table(5000, seed=1)
    assert set(t.column("p_brand").to_pylist()) <= set(entry.P_BRANDS)
    assert set(t.column("p_type").to_pylist()) <= set(entry.P_TYPES)
    sizes = t.column("p_size").to_numpy()
    assert sizes.min() >= 1 and sizes.max() <= 50
    assert len(entry.P_TYPES) == 150 and len(entry.P_BRANDS) == 25
    assert max(len(v) for v in entry.P_TYPES) == 25   # VARCHAR(25)


def test_q16_part_filter_and_group_counts():
    """What the stage keeps and the groups it forms, against a Python count
    over the rows."""
    t = entry.part_table(6000, seed=2)
    plan = entry.q16_part_plan(t, num_slices=3, shuffle_partitions=4,
                               device="cpu")
    got = collect(plan)
    rows = zip(*[t.column(k).to_pylist() for k in entry.Q16_KEYS])
    kept = [r for r in rows if r[0] != entry.Q16_BRAND
            and not r[1].startswith(entry.Q16_TYPE_PREFIX)
            and r[2] in entry.Q16_SIZES]
    node = plan
    while node.name != "FilterExec":
        node = node.children[0]
    assert node.metrics["numOutputRows"].total() == len(kept)
    assert got.num_rows == len(set(kept))
    assert sum(got.column("part_cnt").to_pylist()) == len(kept)


@pytest.mark.parametrize("entry_point", ["run_q16_part", "q16_part_plan",
                                         "run_q1", "q1_plan"])
def test_entry_points_ask_for_cuda_by_default(monkeypatch, entry_point):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = (entry.part_table(10) if "q16" in entry_point
         else entry.lineitem_table(10))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(entry, entry_point)(t)


#: modules of the string slices, which the package-wide guards must reach
SLICE_MODULES = ["spark_rapids_tpu_torch.kernels.string_search",
                 "spark_rapids_tpu_torch.expressions.strings",
                 "spark_rapids_tpu_torch.expressions.regex",
                 "spark_rapids_tpu_torch.expressions.boolean",
                 "spark_rapids_tpu_torch.expressions.comparison",
                 "spark_rapids_tpu_torch.plan.interpreter",
                 "spark_rapids_tpu_torch.expressions.decimal128",
                 "spark_rapids_tpu_torch.expressions.collections",
                 "spark_rapids_tpu_torch.exec.generate",
                 "spark_rapids_tpu_torch.entry"]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_module_loads_no_jax(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    assert path.is_file()
    code = (f"import sys\nimport {module}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'spark_rapids_tpu')]\n"
            "assert not bad, bad\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------------------
# TPC-H Q16, whole
# ---------------------------------------------------------------------------

SF = 0.01
Q16_CONF = entry.session_conf(SLICES)


def cut_comments(supplier: pa.Table) -> pa.Table:
    """``s_comment`` cut to the JAX Session's 64-byte scan width."""
    i = supplier.schema.get_field_index("s_comment")
    return supplier.set_column(i, "s_comment", pc.utf8_slice_codeunits(
        supplier.column("s_comment"), 0, 64))


def _jax_q16(part, supplier, partsupp, num_slices):
    """``entry.q16_df`` written with the JAX package's classes."""
    def scan(t):
        return table(t, num_slices=num_slices,
                     batch_rows=-(-t.num_rows // num_slices))
    complaints = (scan(supplier)
                  .where(JLike(jcol("s_comment"), entry.Q16_COMMENT))
                  .select("s_suppkey"))
    return (scan(partsupp)
            .join(scan(part).where(_jax_part_condition()), ["ps_partkey"],
                  ["p_partkey"])
            .join(complaints, ["ps_suppkey"], ["s_suppkey"],
                  JJoinType.LEFT_ANTI)
            .group_by(*entry.Q16_KEYS, "ps_suppkey").agg()
            .group_by(*entry.Q16_KEYS).agg(Count().alias("supplier_cnt"))
            .order_by(JSortOrder(jcol("supplier_cnt"), True),
                      *[JSortOrder(jcol(k)) for k in entry.Q16_KEYS]))


@pytest.fixture(scope="module")
def q16_whole():
    part, supplier, partsupp = entry.tpch_q16_tables(SF)
    cut = cut_comments(supplier)
    ses = Session(Q16_CONF)
    df = _jax_q16(part, cut, partsupp, SLICES)
    result = ses.collect(df)
    return (part, supplier, partsupp, cut, result, ses.executed_exec_names(),
            ses.explain(df))


def test_q16_matches_jax_session_and_pyarrow(q16_whole):
    part, supplier, partsupp, cut, jax_result, _, _ = q16_whole
    got = entry.run_q16(part, cut, partsupp, SLICES, SLICES, device="cpu")
    assert got.schema == pa.schema([("p_brand", pa.string()),
                                    ("p_type", pa.string()),
                                    ("p_size", pa.int32()),
                                    ("supplier_cnt", pa.int64())])
    assert got.num_rows > 200
    assert got.equals(jax_result)
    assert got.equals(entry.q16_reference(part, cut, partsupp))
    full = entry.run_q16(part, supplier, partsupp, SLICES, SLICES,
                         device="cpu")
    assert full.equals(entry.q16_reference(part, supplier, partsupp))


def test_q16_plan_and_explain_are_the_jax_sessions(q16_whole):
    part, _, partsupp, cut, _, jax_names, jax_explain = q16_whole
    ses = TSession(Q16_CONF, device="cpu")
    df = entry.q16_df(part, cut, partsupp, SLICES)
    assert ses.explain(df) == jax_explain
    ses.collect(df)
    assert ses.executed_exec_names() == jax_names
    assert ses.fell_back() == []
    assert jax_names.count("HashJoinExec") == 2
    assert jax_names.count("HashAggregateExec") == 4


def test_q16_anti_join_drops_the_complained_of_suppliers():
    """The LIKE keeps exactly the suppliers whose comment has 'Customer'
    and later 'Complaints' (not 'Recommends'), and no partsupp row of
    theirs is counted: against a Python count over the rows."""
    part, supplier, partsupp = entry.tpch_q16_tables(0.2, seed=5)
    comments = supplier.column("s_comment").to_pylist()
    bad = {k for k, c in zip(supplier.column("s_suppkey").to_pylist(),
                             comments)
           if "Customer" in c and "Complaints" in c[c.index("Customer"):]}
    assert len(bad) == 1
    assert sum("Recommends" in c for c in comments) == 1
    keep = {}
    for pk, b, t, sz in zip(*[part.column(k).to_pylist() for k in
                              ("p_partkey", "p_brand", "p_type", "p_size")]):
        if b != entry.Q16_BRAND and not t.startswith(
                entry.Q16_TYPE_PREFIX) and sz in entry.Q16_SIZES:
            keep[pk] = (b, t, sz)
    groups = {}
    for pk, sk in zip(partsupp.column("ps_partkey").to_pylist(),
                      partsupp.column("ps_suppkey").to_pylist()):
        if pk in keep and sk not in bad:
            groups.setdefault(keep[pk], set()).add(sk)
    got = entry.run_q16(part, supplier, partsupp, 3, 4, device="cpu")
    assert {(r["p_brand"], r["p_type"], r["p_size"]): r["supplier_cnt"]
            for r in got.to_pylist()} == \
        {k: len(v) for k, v in groups.items()}


def test_q16_tables_follow_the_spec():
    part, supplier, partsupp = entry.tpch_q16_tables(0.5, seed=3)
    assert (part.num_rows, supplier.num_rows, partsupp.num_rows) == \
        (100_000, 5_000, 400_000)
    lengths = pc.utf8_length(supplier.column("s_comment")).to_numpy()
    assert lengths.min() >= 25 and lengths.max() <= 100
    like = pc.match_like(supplier.column("s_comment"), entry.Q16_COMMENT)
    assert pc.sum(like).as_py() == 2            # round(0.5 * 5), rounded
    rec = pc.match_like(supplier.column("s_comment"),
                        "%Customer%Recommends%")
    assert pc.sum(rec).as_py() == 2
    sk = partsupp.column("ps_suppkey").to_numpy()
    assert sk.min() >= 1 and sk.max() <= 5_000
    # four distinct suppliers per part, as dbgen's formula gives
    per_part = sk.reshape(-1, 4)
    assert all(len(set(r)) == 4 for r in per_part[:1000])
    assert set(part.column("p_brand").to_pylist()) <= set(entry.P_BRANDS)


def test_run_q16_asks_for_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.run_q16(*entry.tpch_q16_tables(0.001))
