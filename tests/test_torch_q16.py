"""The string slice as a whole: the part stage of TPC-H Q16 through the port
on the CPU against the JAX Session (the same physical tree) and against
pyarrow, exactly (every output column is a string or an integer); and the
guards that keep the slice's entry points and modules free of JAX and off a
silent CPU fallback."""

import pathlib
import subprocess
import sys

import pyarrow as pa
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
from spark_rapids_tpu.expressions.strings import startswith as jstartswith
from spark_rapids_tpu.plan import Session, table
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.exec import collect

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, SLICES = 4000, 4


def _jax_q16_part(t, num_slices):
    cond = JAnd(JAnd(JNot(JEqualTo(jcol("p_brand"), jlit(entry.Q16_BRAND))),
                     JNot(jstartswith(jcol("p_type"),
                                      entry.Q16_TYPE_PREFIX))),
                JIn(jcol("p_size"), entry.Q16_SIZES))
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


#: modules of the string slice, which the package-wide guards must reach
SLICE_MODULES = ["spark_rapids_tpu_torch.kernels.string_search",
                 "spark_rapids_tpu_torch.expressions.strings",
                 "spark_rapids_tpu_torch.expressions.boolean",
                 "spark_rapids_tpu_torch.expressions.comparison"]


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
