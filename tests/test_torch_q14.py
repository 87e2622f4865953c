"""TPC-H Q14 through the port on the CPU: ``entry.q14_df`` through the
port's Session against the same query through the JAX Session (the same
executed operators, the same row within rel 1e-6) and against pyarrow;
its inputs against the spec's domains; and the guards that keep the new
modules and the Q14/Q9 entry points free of JAX and off a silent CPU
fallback.

The JAX Session runs once (a module fixture): its cost is the JAX
compile of the plan."""

import math
import pathlib
import subprocess
import sys

import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions.aggregates import Sum as JSum
from spark_rapids_tpu.expressions.boolean import And as JAnd
from spark_rapids_tpu.expressions.conditional import CaseWhen as JCaseWhen
from spark_rapids_tpu.expressions.datetime import add_months as jadd_months
from spark_rapids_tpu.expressions.strings import startswith as jstartswith
from spark_rapids_tpu.plan import Session, table
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.plan import Session as TSession

ROOT = pathlib.Path(__file__).resolve().parent.parent
SF, SLICES = 0.01, 2
CONF = entry.session_conf(SLICES)
REL = 1e-6


def jax_q14(lineitem, part):
    """``entry.q14_df`` written with the JAX package's classes."""
    def scan(t):
        return table(t, num_slices=SLICES,
                     batch_rows=-(-t.num_rows // SLICES))

    def revenue():
        return jcol("l_extendedprice") * (jlit(1.0) - jcol("l_discount"))
    start = jlit(entry.Q14_DATE)
    promo = JCaseWhen(((jstartswith(jcol("p_type"), entry.Q14_TYPE_PREFIX),
                        revenue()),), jlit(0.0))
    return (scan(lineitem)
            .where(JAnd(jcol("l_shipdate") >= start,
                        jcol("l_shipdate") < jadd_months(
                            jlit(entry.Q14_DATE), 1)))
            .join(scan(part), ["l_partkey"], ["p_partkey"])
            .agg(JSum(promo).alias("promo"), JSum(revenue()).alias("total"))
            .select((jlit(100.0) * jcol("promo") / jcol("total"))
                    .alias("promo_revenue")))


@pytest.fixture(scope="module")
def q14_jax():
    lineitem, part = entry.tpch_q14_tables(SF)
    ses = Session(CONF)
    result = ses.collect(jax_q14(lineitem, part))
    return lineitem, part, result, ses.executed_exec_names()


def test_q14_matches_jax_session_and_pyarrow(q14_jax):
    lineitem, part, jax_result, jax_names = q14_jax
    ses = TSession(CONF, device="cpu")
    got = ses.collect(entry.q14_df(lineitem, part, SLICES))
    assert got.schema == pa.schema([("promo_revenue", pa.float64())])
    assert ses.executed_exec_names() == jax_names
    assert ses.fell_back() == []
    (value,) = got.column("promo_revenue").to_pylist()
    (want,) = jax_result.column("promo_revenue").to_pylist()
    (ref,) = entry.q14_reference(lineitem, part).column(
        "promo_revenue").to_pylist()
    assert 5.0 < value < 30.0           # a sixth of the types are PROMO
    assert math.isclose(value, want, rel_tol=REL)
    assert math.isclose(value, ref, rel_tol=REL)


def test_run_q14_matches_pyarrow_at_other_shapes():
    lineitem, part = entry.tpch_q14_tables(0.02, seed=5)
    got = entry.run_q14(lineitem, part, 3, 4, device="cpu")
    (value,) = got.column("promo_revenue").to_pylist()
    (ref,) = entry.q14_reference(lineitem, part).column(
        "promo_revenue").to_pylist()
    assert math.isclose(value, ref, rel_tol=REL)


def test_q14_month_bound_is_add_months():
    """The upper bound is add_months(date '1995-09-01', 1): the filter
    keeps exactly September 1995, against a Python count."""
    lineitem, part = entry.tpch_q14_tables(SF)
    days = lineitem.column("l_shipdate").to_pylist()
    import datetime as dt
    want = sum(dt.date(1995, 9, 1) <= d < dt.date(1995, 10, 1)
               for d in days)
    from spark_rapids_tpu_torch.expressions import And, add_months, col, lit
    start = lit(entry.Q14_DATE)
    df = entry._df(lineitem, SLICES).where(And(
        col("l_shipdate") >= start,
        col("l_shipdate") < add_months(lit(entry.Q14_DATE), 1)))
    assert TSession(CONF, device="cpu").collect(df).num_rows == want > 100


def test_q14_tables_follow_the_spec():
    lineitem, part = entry.tpch_q14_tables(0.05, seed=1)
    assert part.num_rows == 10_000
    pk = lineitem.column("l_partkey").to_numpy()
    assert pk.min() >= 1 and pk.max() <= 10_000
    assert set(part.column("p_type").to_pylist()) <= set(entry.P_TYPES)
    # the part keys are drawn last: Q3's lineitem columns do not move
    q3_li = entry.tpch_q3_tables(0.05, seed=1)[2]
    for name in ("l_extendedprice", "l_discount", "l_shipdate"):
        assert lineitem.column(name).equals(q3_li.column(name))


# ---------------------------------------------------------------------------
# Guards: the slice's modules load no JAX; its entry points ask for CUDA
# ---------------------------------------------------------------------------

SLICE_MODULES = ["spark_rapids_tpu_torch.expressions.conditional",
                 "spark_rapids_tpu_torch.expressions.math",
                 "spark_rapids_tpu_torch.expressions.cast",
                 "spark_rapids_tpu_torch.expressions.datetime",
                 "spark_rapids_tpu_torch.plan.interpreter",
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


@pytest.mark.parametrize("entry_point", ["run_q14", "run_q9"])
def test_entry_points_ask_for_cuda_by_default(monkeypatch, entry_point):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tables = entry.tpch_q14_tables(0.001) if entry_point == "run_q14" \
        else entry.tpch_q9_tables(0.001)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(entry, entry_point)(*tables)
