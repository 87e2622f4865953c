"""The port's datetime expressions against the JAX package's, on the CPU.

Every case of ``tests/test_datetime.py``, built with each package's
classes on the same ``gen_table`` data and seed: the select-only cases of
one table go through one JAX Session collect (one plan, so one compile)
and one port Session collect, and each case then holds its columns of the
port's device against the JAX device's (floats within rel 1e-6) and of the
port's row interpreter against the port's device. The cases with a
group-by, a fallback or an interpreter-only parse run alone, against both
packages. Then the edges the reference's file does not reach: dates before
1970 and timestamps a microsecond before the epoch (floor division), every
field at once on the civil-calendar boundaries, and the pattern compiler
against the JAX one."""

import datetime as dt
import importlib
import types as pytypes

import pyarrow as pa
import pytest

from harness.asserts import assert_rows_equal, assert_tables_equal, rows_of
from harness.data_gen import (DateGen, IntegerGen, LongGen, StringGen,
                              TimestampGen, gen_table)

CONF = {"spark.rapids.tpu.sql.incompatibleOps.enabled": True}
ORACLE = {**CONF, "spark.rapids.tpu.sql.enabled": False}


def _api(pkg):
    ns = {}
    for m in ("base", "datetime", "comparison", "aggregates"):
        mod = importlib.import_module(f"{pkg}.expressions.{m}")
        ns.update({k: v for k, v in vars(mod).items()
                   if not k.startswith("_")})
    plan = importlib.import_module(f"{pkg}.plan")
    ns.update(table=plan.table, Session=plan.Session)
    return pytypes.SimpleNamespace(**ns)


JAX = _api("spark_rapids_tpu")
PORT = _api("spark_rapids_tpu_torch")


def session(api, conf):
    return api.Session(conf, device="cpu") if api is PORT \
        else api.Session(conf)


DT = gen_table([("d", DateGen()), ("t", TimestampGen()),
                ("n", IntegerGen(min_val=-500, max_val=500))],
               n=500, seed=110)
PARSE_GOOD = gen_table(
    [("s", StringGen(charset="0123456789-", min_len=10, max_len=10))],
    n=50, seed=113)
UG = gen_table([("u", LongGen(min_val=-2_000_000_000,
                              max_val=4_000_000_000))], n=300, seed=114)


def _cases():
    """case name -> (table, [expression builder over an API])."""
    c = {}
    for fn in ("year", "month", "dayofmonth", "quarter", "dayofweek",
               "dayofyear", "weekofyear"):
        c[f"date_parts[{fn}]"] = (DT, [lambda a, fn=fn: getattr(a, fn)(
            a.col("d"))])
    for fn in ("year", "month", "dayofmonth", "hour", "minute", "second"):
        c[f"timestamp_parts[{fn}]"] = (DT, [lambda a, fn=fn: getattr(
            a, fn)(a.col("t"))])
    c["date_add_sub"] = (DT, [lambda a: a.date_add(a.col("d"), a.col("n")),
                              lambda a: a.date_sub(a.col("d"), 30)])
    c["datediff"] = (DT, [lambda a: a.datediff(
        a.col("d"), a.date_add(a.col("d"), a.col("n")))])
    c["add_months_clamps"] = (DT, [
        lambda a: a.add_months(a.col("d"), a.col("n")),
        lambda a: a.add_months(a.col("d"), 1)])
    c["last_day"] = (DT, [lambda a: a.LastDay(a.col("d"))])
    c["unix_timestamp"] = (DT, [lambda a: a.UnixTimestampConv(a.col("t")),
                                lambda a: a.UnixTimestampConv(a.col("d"))])
    for fmt in ("yyyy-MM-dd", "yyyy/MM/dd", "MM-dd-yyyy", "yyyyMMdd"):
        c[f"date_format_date[{fmt}]"] = (DT, [
            lambda a, fmt=fmt: a.date_format(a.col("d"), fmt)])
    for fmt in ("yyyy-MM-dd HH:mm:ss", "dd/MM/yyyy HH:mm:ss.SSS", "HH:mm"):
        c[f"date_format_timestamp[{fmt}]"] = (DT, [
            lambda a, fmt=fmt: a.date_format(a.col("t"), fmt)])
    c["to_date_round_trip"] = (DT, [lambda a: a.to_date(
        a.date_format(a.col("d"), "yyyy-MM-dd"))])
    c["to_date_rejects_garbage"] = (PARSE_GOOD, [
        lambda a: a.to_date(a.col("s"))])
    c["to_timestamp_and_unix"] = (DT, [
        lambda a: a.to_timestamp(a.date_format(a.col("t"),
                                               "yyyy-MM-dd HH:mm:ss")),
        lambda a: a.unix_timestamp(a.date_format(a.col("t"),
                                                 "yyyy-MM-dd HH:mm:ss"))])
    c["from_unixtime"] = (UG, [lambda a: a.from_unixtime(a.col("u")),
                               lambda a: a.from_unixtime(a.col("u"),
                                                         "yyyy-MM")])
    for lvl in ("year", "quarter", "month", "week", "mm", "nonsense"):
        c[f"trunc_date[{lvl}]"] = (DT, [
            lambda a, lvl=lvl: a.trunc(a.col("d"), lvl)])
    for lvl in ("year", "month", "week", "day", "hour", "minute", "second"):
        c[f"date_trunc_timestamp[{lvl}]"] = (DT, [
            lambda a, lvl=lvl: a.date_trunc(lvl, a.col("t"))])
    c["months_between"] = (DT, [lambda a: a.months_between(
        a.col("d"), a.date_add(a.col("d"), a.col("n")))])
    c["months_between_timestamps"] = (DT, [lambda a: a.months_between(
        a.col("t"), a.col("d"))])
    for name in ("mon", "TUESDAY", "we", "th", "Fri", "sa", "sunday", "xx"):
        c[f"next_day[{name}]"] = (DT, [
            lambda a, name=name: a.next_day(a.col("d"), name)])
    c["next_day_on_timestamp"] = (DT, [lambda a: a.next_day(
        a.col("t"), "wednesday")])
    return c


CASES = _cases()
TABLES = {"DT": DT, "PARSE_GOOD": PARSE_GOOD, "UG": UG}


def _columns(name, t):
    """The cases over table ``t``, as (case, column names, builders)."""
    out = []
    for case, (tt, builders) in CASES.items():
        if tt is t:
            out.append((case, [f"c{len(out)}_{i}" for i in
                               range(len(builders))], builders))
    return out


@pytest.fixture(scope="module")
def collected():
    """Per table: the JAX device's, the port device's and the port
    interpreter's outputs of every select case at once."""
    out = {}
    for tname, t in TABLES.items():
        cols = _columns(tname, t)

        def df(a):
            return a.table(t).select(*[
                b(a).alias(n) for _, names, bs in cols
                for n, b in zip(names, bs)])
        jax_out = session(JAX, CONF).collect(df(JAX))
        ses = session(PORT, CONF)
        port_out = ses.collect(df(PORT))
        assert ses.fell_back() == [], ses.fell_back()
        interp = session(PORT, ORACLE).collect(df(PORT))
        for case, names, _ in cols:
            out[case] = tuple(x.select(names)
                              for x in (jax_out, port_out, interp))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_datetime_case_matches_jax(collected, case):
    jax_out, port_out, interp = collected[case]
    assert port_out.schema == jax_out.schema
    assert_tables_equal(port_out, jax_out)
    assert_tables_equal(interp, port_out)


def test_date_grouping_pipeline():
    def q(a):
        return a.table(DT).group_by(a.year(a.col("d")).alias("y")).agg(
            a.Count().alias("n"))
    want = session(JAX, CONF).collect(q(JAX))
    got = session(PORT, CONF).collect(q(PORT))
    assert_tables_equal(got, want, ignore_order=True)
    assert_tables_equal(session(PORT, ORACLE).collect(q(PORT)), got,
                        ignore_order=True)


def test_pattern_unsupported_directives():
    for bad in ("E", "a", "d/M/yyyy", "yyyy-MM-dd'T'HH:mm:ssXXX"):
        with pytest.raises(PORT.DateTimeFormatUnsupported):
            PORT.compile_pattern(bad)
        with pytest.raises(JAX.DateTimeFormatUnsupported):
            JAX.compile_pattern(bad)
    for good in ("yyyy'T'MM", "yyyy-MM-dd HH:mm:ss.SSS", "''yyyy", "HH:mm"):
        assert PORT.compile_pattern(good) == JAX.compile_pattern(good)
    assert PORT.compile_pattern("yyyy'T'MM") == [
        ("f", "year", 4), ("l", b"T"), ("f", "month", 2)]


@pytest.mark.parametrize("query", ["unsupported_pattern_falls_back",
                                   "fallback_format_result_reimports"])
def test_unsupported_pattern_falls_back_in_both(query):
    def q(a):
        if query == "unsupported_pattern_falls_back":
            return a.table(DT).select(
                a.date_format(a.col("d"), "EEEE").alias("s"))
        return (a.table(DT).select(a.date_format(a.col("d"), "EEEE")
                                   .alias("s"), a.col("d"))
                .where(a.col("s") != a.lit("Monday")))
    jses = session(JAX, CONF)
    want = jses.collect(q(JAX))
    ses = session(PORT, CONF)
    got = ses.collect(q(PORT))
    assert any("Project" in n for n in ses.fell_back())
    assert ses.fell_back() == jses.fell_back()
    assert_tables_equal(got, want, ignore_order=True)
    assert_tables_equal(session(PORT, ORACLE).collect(q(PORT)), got,
                        ignore_order=True)


def test_to_date_runs_on_device():
    ses = session(PORT, CONF)
    ses.collect(PORT.table(DT).select(PORT.to_date(PORT.date_format(
        PORT.col("d"), "yyyy-MM-dd")).alias("d2")))
    assert not any("CpuFallback" in n for n in ses.executed_exec_names())


def test_months_between_ignores_time_on_matching_days():
    t = pa.table({"a": pa.array([dt.datetime(2020, 2, 15, 12, 0, 0)]),
                  "b": pa.array([dt.datetime(2020, 1, 15, 0, 0, 0)])})
    for conf in (CONF, ORACLE):
        for a in (JAX, PORT):
            got = session(a, conf).collect(a.table(t).select(
                a.months_between(a.col("a"), a.col("b")).alias("mb")))
            assert got.column("mb").to_pylist() == [1.0], (conf, a)


def test_cpu_parse_micros_fraction():
    t = pa.table({"s": pa.array(["2020-01-01 00:00:00.123456", "bogus"])})
    outs = []
    for a in (JAX, PORT):
        got = session(a, ORACLE).collect(a.table(t).select(a.to_timestamp(
            a.col("s"), "yyyy-MM-dd HH:mm:ss.SSSSSS").alias("t")))
        vals = got.column("t").to_pylist()
        assert vals[1] is None
        assert vals[0].replace(tzinfo=None) == \
            dt.datetime(2020, 1, 1, 0, 0, 0, 123456)
        outs.append(vals)
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# Edges: floor division before the epoch, calendar boundaries
# ---------------------------------------------------------------------------

EDGE = pa.table({
    "d": pa.array([dt.date(1969, 12, 31), dt.date(1970, 1, 1),
                   dt.date(1600, 2, 29), dt.date(1900, 3, 1),
                   dt.date(2000, 2, 29), dt.date(2100, 12, 31),
                   dt.date(1, 1, 1), dt.date(9999, 12, 31),
                   dt.date(1582, 10, 15), None]),
    "t": pa.array([dt.datetime(1969, 12, 31, 23, 59, 59, 999999),
                   dt.datetime(1970, 1, 1), dt.datetime(1600, 2, 29, 12),
                   dt.datetime(1899, 12, 31, 23, 0, 0, 1),
                   dt.datetime(2000, 2, 29, 0, 0, 0, 999),
                   dt.datetime(2100, 1, 1, 6, 30), dt.datetime(1, 1, 1),
                   dt.datetime(9999, 12, 24, 23, 59, 59),
                   dt.datetime(1969, 1, 1, 0, 0, 0, 500000), None],
                  pa.timestamp("us")),
    "n": pa.array([1, -1, 12, -12, 13, 0, 5, -5, 1200, None], pa.int32()),
})


def test_edges_before_the_epoch_match_jax_and_python():
    """Each field of dates and timestamps around 1970, leap days and the
    ends of Python's calendar: the port's device against the JAX
    device's and against the port's interpreter (Python's datetime)."""
    def q(a):
        d, t = a.col("d"), a.col("t")
        return a.table(EDGE).select(*[e.alias(f"e{i}") for i, e in
                                      enumerate([
            a.year(t), a.month(t), a.dayofmonth(t), a.hour(t), a.minute(t),
            a.second(t), a.year(d), a.dayofweek(d), a.dayofyear(d),
            a.weekofyear(d), a.weekofyear(t), a.quarter(t),
            a.LastDay(d), a.UnixTimestampConv(t), a.UnixTimestampConv(d),
            a.date_format(t, "yyyy-MM-dd HH:mm:ss.SSS"),
            a.trunc(d, "week"), a.date_trunc("second", t),
            a.date_trunc("quarter", t), a.next_day(t, "su"),
            a.months_between(t, d)])])
    want = session(JAX, CONF).collect(q(JAX))
    ses = session(PORT, CONF)
    got = ses.collect(q(PORT))
    assert ses.fell_back() == []
    assert_tables_equal(got, want)
    assert_tables_equal(session(PORT, ORACLE).collect(q(PORT)), got)
    # a microsecond before the epoch is 1969-12-31 23:59:59 (floor)
    assert rows_of(got)[0][:6] == (1969, 12, 31, 23, 59, 59)
    assert rows_of(got)[0][13] == -1


def test_civil_calendar_round_trips_every_day():
    """days_from_civil(civil_from_days(z)) == z over 1 to 9999 AD, and
    each (year, month, day) equal to Python's."""
    import torch
    from spark_rapids_tpu_torch.expressions.datetime import (
        civil_from_days, days_from_civil)
    lo = (dt.date(1, 1, 1) - dt.date(1970, 1, 1)).days
    hi = (dt.date(9999, 12, 31) - dt.date(1970, 1, 1)).days
    z = torch.arange(lo, hi + 1, dtype=torch.int32)
    y, m, d = civil_from_days(z)
    assert torch.equal(days_from_civil(y, m, d), z)
    for i in range(0, len(z), 9973):
        want = dt.date(1970, 1, 1) + dt.timedelta(days=int(z[i]))
        assert (int(y[i]), int(m[i]), int(d[i])) == \
            (want.year, want.month, want.day)


def test_utc_conversions_match_jax():
    """from_utc_timestamp / to_utc_timestamp over the reference's zones,
    the port's transition table equal to the JAX package's."""
    from spark_rapids_tpu.expressions.datetime import _tz_transitions as jtz
    from spark_rapids_tpu_torch.expressions.datetime import _tz_transitions
    import numpy as np
    for zone in ("America/Los_Angeles", "Europe/Berlin", "Asia/Kolkata"):
        a, b = jtz(zone), _tz_transitions(zone)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
