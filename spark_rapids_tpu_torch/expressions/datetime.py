"""Date and timestamp expressions.

Port of ``spark_rapids_tpu/expressions/datetime.py`` (reference:
datetimeExpressions.scala, DateUtils.scala). DATE is int32 days since the
epoch, TIMESTAMP int64 microseconds since the epoch in UTC. The civil
calendar is Howard Hinnant's ``days_from_civil`` / ``civil_from_days``
(public domain): branch-free integer arithmetic over whole columns.

Every division here floors: dates before 1970 are negative, and a
timestamp 1 us before the epoch lies on day -1. Python's ``//`` on a
tensor floors as well, but the module writes ``torch.div(...,
rounding_mode="floor")`` and ``torch.remainder`` out (``_fdiv``, ``_mod``)
so that no division depends on an operator's rounding.

Format and parse patterns compile on the host into fixed-width field
tokens (``compile_pattern``), so formatting and parsing are rectangular
byte ops; a directive with no fixed width raises
``DateTimeFormatUnsupported``, and tagging sends the expression to the
row interpreter, which formats a wider subset. Time zones
(``UTCTimestampConv``) read the zone database on the host through
``zoneinfo`` into a table of transitions, looked up on the device with one
``searchsorted``; a zone the database lacks is refused at tagging.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import types as T
from ..batch import DeviceColumn
from ..types import TypeKind
from .base import (EvalContext, Expression, _device_row, lit_if_needed,
                   numeric_column)
from .strings import _string_column, _table

US_PER_DAY = 86_400_000_000
US_PER_HOUR = 3_600_000_000
US_PER_MIN = 60_000_000
US_PER_SEC = 1_000_000

_I32, _I64 = torch.int32, torch.int64


def _fdiv(a, b):
    """Floor division (toward negative infinity)."""
    return torch.div(a, b, rounding_mode="floor")


def _mod(a, b):
    """The remainder of floor division: in [0, b) for b > 0."""
    return torch.remainder(a, b)


def civil_from_days(z: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Days since the epoch -> (year, month, day), int32 each."""
    z = z.to(_I64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097                                   # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)                             # [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1                     # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)                 # [1, 12]
    return (y + (m <= 2).to(_I64)).to(_I32), m.to(_I32), d.to(_I32)


def days_from_civil(y, m, d) -> torch.Tensor:
    """(year, month, day) -> days since the epoch, int32."""
    y = y.to(_I64) - (m <= 2).to(_I64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9).to(_I64)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(_I32)


def _days_of(col: DeviceColumn) -> torch.Tensor:
    """A date or timestamp column as int64 days since the epoch (a
    timestamp floored: -1 us is day -1)."""
    if col.dtype.kind is TypeKind.DATE:
        return col.data.to(_I64)
    return _fdiv(col.data.to(_I64), US_PER_DAY)


_MONTH_DAYS = np.asarray([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                         np.int32)


def _month_len(y, m) -> torch.Tensor:
    base = _table(_MONTH_DAYS, y.device)[(m - 1).to(_I64)]
    leap = ((_mod(y, 4) == 0) & (_mod(y, 100) != 0)) | (_mod(y, 400) == 0)
    return torch.where((m == 2) & leap, torch.full_like(base, 29), base)


@dataclass(frozen=True, eq=False)
class ExtractDatePart(Expression):
    """year, month, day, quarter, dayofweek, dayofyear, weekofyear, and the
    time parts hour, minute and second."""

    child: Expression
    part: str = "year"

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return ExtractDatePart(c[0], self.part)

    @property
    def dtype(self):
        return T.INT32

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        p = self.part
        if p in ("hour", "minute", "second"):
            tod = _mod(c.data.to(_I64), US_PER_DAY)
            if p == "hour":
                v = _fdiv(tod, US_PER_HOUR)
            elif p == "minute":
                v = _fdiv(_mod(tod, US_PER_HOUR), US_PER_MIN)
            else:
                v = _fdiv(_mod(tod, US_PER_MIN), US_PER_SEC)
            return numeric_column(v.to(_I32), c.validity, T.INT32)
        days = _days_of(c)
        y, m, d = civil_from_days(days)
        one = torch.ones_like(m)
        if p == "year":
            v = y
        elif p == "month":
            v = m
        elif p == "day":
            v = d
        elif p == "quarter":
            v = _fdiv(m - 1, 3) + 1
        elif p == "dayofweek":
            # Spark: 1 = Sunday ... 7 = Saturday; 1970-01-01 was a Thursday
            v = _mod(days + 4, 7) + 1
        elif p == "dayofyear":
            v = days - days_from_civil(y, one, one) + 1
        elif p == "weekofyear":
            # ISO 8601: the week of the Thursday of this row's week
            thursday = days + 3 - _mod(days + 3, 7)
            ty, _, _ = civil_from_days(thursday)
            jan1 = days_from_civil(ty, one, one)
            v = _fdiv(thursday - jan1, 7) + 1
        else:
            raise ValueError(p)
        return numeric_column(v.to(_I32), c.validity, T.INT32)


@dataclass(frozen=True, eq=False)
class DateAddSub(Expression):
    """date_add / date_sub(date, days)."""

    child: Expression
    days: Expression
    negate: bool = False

    @property
    def children(self):
        return (self.child, self.days)

    def with_children(self, c):
        return DateAddSub(c[0], c[1], self.negate)

    @property
    def dtype(self):
        return T.DATE

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        d = self.days.eval(batch, ctx)
        delta = d.data.to(_I32)
        v = c.data + (-delta if self.negate else delta)
        return numeric_column(v, c.validity & d.validity, T.DATE)


@dataclass(frozen=True, eq=False)
class DateDiff(Expression):
    """datediff(end, start) in days."""

    end: Expression
    start: Expression

    @property
    def children(self):
        return (self.end, self.start)

    def with_children(self, c):
        return DateDiff(c[0], c[1])

    @property
    def dtype(self):
        return T.INT32

    def eval(self, batch, ctx=EvalContext()):
        e = self.end.eval(batch, ctx)
        s = self.start.eval(batch, ctx)
        return numeric_column((e.data - s.data).to(_I32),
                              e.validity & s.validity, T.INT32)


@dataclass(frozen=True, eq=False)
class AddMonths(Expression):
    """add_months: the day of the month clamped to the target month's
    last (Spark)."""

    child: Expression
    months: Expression

    @property
    def children(self):
        return (self.child, self.months)

    def with_children(self, c):
        return AddMonths(c[0], c[1])

    @property
    def dtype(self):
        return T.DATE

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        mo = self.months.eval(batch, ctx)
        y, m, d = civil_from_days(c.data.to(_I64))
        total = y.to(_I64) * 12 + (m - 1) + mo.data.to(_I64)
        ny = _fdiv(total, 12).to(_I32)
        nm = (_mod(total, 12) + 1).to(_I32)
        nd = torch.minimum(d, _month_len(ny, nm))
        return numeric_column(days_from_civil(ny, nm, nd),
                              c.validity & mo.validity, T.DATE)


@dataclass(frozen=True, eq=False)
class LastDay(Expression):
    child: Expression

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return LastDay(c[0])

    @property
    def dtype(self):
        return T.DATE

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        y, m, _ = civil_from_days(c.data.to(_I64))
        return numeric_column(days_from_civil(y, m, _month_len(y, m)),
                              c.validity, T.DATE)


@dataclass(frozen=True, eq=False)
class UnixTimestampConv(Expression):
    """to_unix_timestamp(date or timestamp) in seconds (floored), or
    seconds as a timestamp."""

    child: Expression
    to_unix: bool = True

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return UnixTimestampConv(c[0], self.to_unix)

    @property
    def dtype(self):
        return T.INT64 if self.to_unix else T.TIMESTAMP

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        x = c.data.to(_I64)
        if self.to_unix:
            v = x * 86400 if c.dtype.kind is TypeKind.DATE \
                else _fdiv(x, US_PER_SEC)
            return numeric_column(v, c.validity, T.INT64)
        return numeric_column(x * US_PER_SEC, c.validity, T.TIMESTAMP)


# ---------------------------------------------------------------------------
# Pattern-driven format and parse (reference: GpuDateFormatClass,
# GpuToTimestamp, GpuFromUnixTime; DateUtils.tagAndGetCudfFormat)
# ---------------------------------------------------------------------------

class DateTimeFormatUnsupported(ValueError):
    """The pattern uses a directive with no fixed-width device lowering."""


#: directive -> (field name, byte width)
_PATTERN_FIELDS = {
    "yyyy": ("year", 4), "MM": ("month", 2), "dd": ("day", 2),
    "HH": ("hour", 2), "mm": ("minute", 2), "ss": ("second", 2),
    "SSS": ("millis", 3),
}


def compile_pattern(fmt: str) -> List[tuple]:
    """``fmt`` -> a list of ("f", field, width) and ("l", literal bytes)
    tokens. Only fixed-width directives compile: variable-width ones
    (a single "d", "M" or "H"), locale text ("E", "a", "z") and week-based
    fields raise ``DateTimeFormatUnsupported``."""
    toks = []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "'":
            j = fmt.find("'", i + 1)
            if j < 0:
                raise DateTimeFormatUnsupported(
                    f"unterminated quote in datetime pattern {fmt!r}")
            toks.append(("l", b"'" if j == i + 1
                         else fmt[i + 1:j].encode()))
            i = j + 1
            continue
        if ch.isalpha():
            j = i
            while j < len(fmt) and fmt[j] == ch:
                j += 1
            run = fmt[i:j]
            if run not in _PATTERN_FIELDS:
                raise DateTimeFormatUnsupported(
                    f"datetime pattern directive {run!r} has no fixed-"
                    f"width device lowering (pattern {fmt!r})")
            toks.append(("f", *_PATTERN_FIELDS[run]))
            i = j
            continue
        toks.append(("l", ch.encode()))
        i += 1
    out: List[list] = []
    for t in toks:                      # adjacent literals merge
        if t[0] == "l" and out and out[-1][0] == "l":
            out[-1] = ["l", out[-1][1] + t[1]]
        else:
            out.append(list(t))
    return [tuple(t) for t in out]


def pattern_width(toks) -> int:
    return sum(t[2] if t[0] == "f" else len(t[1]) for t in toks)


def _civil_fields(col: DeviceColumn) -> Dict[str, torch.Tensor]:
    """A date or timestamp column as int32 civil fields."""
    y, m, d = civil_from_days(_days_of(col))
    if col.dtype.kind is TypeKind.TIMESTAMP:
        tod = _mod(col.data.to(_I64), US_PER_DAY)
        hh = _fdiv(tod, US_PER_HOUR).to(_I32)
        mi = _fdiv(_mod(tod, US_PER_HOUR), US_PER_MIN).to(_I32)
        ss = _fdiv(_mod(tod, US_PER_MIN), US_PER_SEC).to(_I32)
        ms = _fdiv(_mod(tod, US_PER_SEC), 1000).to(_I32)
    else:
        hh = mi = ss = ms = torch.zeros_like(y)
    return {"year": y, "month": m, "day": d, "hour": hh, "minute": mi,
            "second": ss, "millis": ms}


def _safe_width(fmt: str) -> int:
    """The pattern's width for the result type. An unsupported pattern
    must still type (tagging records its reason against the node), and its
    width must hold what the interpreter renders for it ("EEEE" ->
    "Wednesday"), since an island's output comes back to the device under
    this type."""
    try:
        return pattern_width(compile_pattern(fmt))
    except DateTimeFormatUnsupported:
        pass
    width = 0
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "'":
            j = fmt.find("'", i + 1)
            if j < 0:
                return max(len(fmt.encode()), 1)
            width += 1 if j == i + 1 else len(fmt[i + 1:j].encode())
            i = j + 1
            continue
        if not ch.isalpha():
            width += len(ch.encode())
            i += 1
            continue
        j = i
        while j < len(fmt) and fmt[j] == ch:
            j += 1
        w = j - i
        if ch == "y":
            width += max(w, 4)
        elif ch == "M":
            width += 9 if w >= 4 else 3 if w == 3 else 2
        elif ch == "E":
            width += 9 if w >= 4 else 3
        elif ch in "dHhms":
            width += max(w, 2)
        elif ch == "S":
            width += max(w, 1)
        elif ch == "a":
            width += 2
        elif ch == "D":
            width += max(w, 3)
        else:
            width += max(w, 4)      # an unknown directive: conservative
        i = j
    return max(width, 1)


def _format_reason(fmt: str):
    try:
        compile_pattern(fmt)
    except DateTimeFormatUnsupported as ex:
        return str(ex)
    return None


def _format(c: DeviceColumn, fmt: str) -> DeviceColumn:
    """A date or timestamp column formatted by ``fmt``: each token is a
    block of fixed width, and the row is their concatenation."""
    toks = compile_pattern(fmt)
    f = _civil_fields(c)
    n, dev = c.data.shape[0], c.data.device
    blocks = []
    for t in toks:
        if t[0] == "l":
            blocks.append(_device_row(t[1], len(t[1]), dev)[None, :]
                          .expand(n, len(t[1])))
        else:
            _, name, w = t
            v = f[name]
            digs = [_mod(_fdiv(v, 10 ** (w - 1 - i)), 10) for i in range(w)]
            blocks.append(torch.stack(digs, dim=1).to(torch.uint8) + 48)
    data = torch.cat(blocks, dim=1)
    width = data.shape[1]
    # years outside 1..9999 have no 4-digit form (and Python's datetime,
    # the host boundary, starts at year 1)
    ok = c.validity & (f["year"] >= 1) & (f["year"] <= 9999)
    return _string_column(data, torch.full((n,), width, dtype=_I32,
                                           device=dev), ok, width)


@dataclass(frozen=True, eq=False)
class DateFormat(Expression):
    """date_format(date or timestamp, fmt) -> string."""

    child: Expression
    fmt: str = "yyyy-MM-dd"

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return DateFormat(c[0], self.fmt)

    @property
    def dtype(self):
        return T.string(max(_safe_width(self.fmt), 1))

    @property
    def nullable(self):
        return True

    def device_unsupported_reason(self):
        return _format_reason(self.fmt)

    def eval(self, batch, ctx=EvalContext()):
        return _format(self.child.eval(batch, ctx), self.fmt)


@dataclass(frozen=True, eq=False)
class ParseDateTime(Expression):
    """to_date / to_timestamp / unix_timestamp(string, fmt). A fixed-width
    pattern puts every field at a static byte offset, so the parse is a few
    masked digit dot-products. A row that fails (wrong length, a non-digit,
    a literal that differs, a field out of range) is null: Spark's non-ANSI
    parse."""

    child: Expression
    fmt: str = "yyyy-MM-dd"
    out: str = "date"           # date | timestamp | unix (int64 seconds)

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return ParseDateTime(c[0], self.fmt, self.out)

    @property
    def dtype(self):
        return {"date": T.DATE, "timestamp": T.TIMESTAMP,
                "unix": T.INT64}[self.out]

    @property
    def nullable(self):
        return True

    def device_unsupported_reason(self):
        return _format_reason(self.fmt)

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        toks = compile_pattern(self.fmt)
        total = pattern_width(toks)
        n, ml = c.data.shape
        dev = c.data.device
        if total > ml:
            # no stored string can hold the pattern
            zeros = torch.zeros(n, dtype=self.dtype.storage_dtype,
                                device=dev)
            return numeric_column(zeros, torch.zeros(n, dtype=torch.bool,
                                                     device=dev), self.dtype)
        ok = c.validity & (c.lengths == total)

        def full(v):
            return torch.full((n,), v, dtype=_I32, device=dev)
        vals = {"year": full(1970), "month": full(1), "day": full(1),
                "hour": full(0), "minute": full(0), "second": full(0),
                "millis": full(0)}
        off = 0
        for t in toks:
            if t[0] == "l":
                k = len(t[1])
                lit = _device_row(t[1], k, dev)
                ok = ok & (c.data[:, off:off + k] == lit[None, :]).all(dim=1)
                off += k
            else:
                _, name, w = t
                b = c.data[:, off:off + w]
                ok = ok & ((b >= 48) & (b <= 57)).all(dim=1)
                p10 = _table(np.asarray([10 ** (w - 1 - i) for i in range(w)],
                                        np.int32), dev)
                vals[name] = ((b - 48).to(_I32) * p10[None, :]).sum(
                    dim=1, dtype=_I32)
                off += w
        y, m, d = vals["year"], vals["month"], vals["day"]
        # year >= 1: Python's datetime.date (the host boundary) has no year 0
        ok = ok & (y >= 1) & (m >= 1) & (m <= 12) & (d >= 1)
        mc = m.clamp(1, 12)
        ok = ok & (d <= _month_len(y, mc))
        ok = ok & (vals["hour"] < 24) & (vals["minute"] < 60) & \
            (vals["second"] < 60)
        days = days_from_civil(y, mc, d)
        zero = torch.zeros((), dtype=_I64, device=dev)
        if self.out == "date":
            v = torch.where(ok, days, torch.zeros_like(days))
        else:
            us = days.to(_I64) * US_PER_DAY + \
                vals["hour"].to(_I64) * US_PER_HOUR + \
                vals["minute"].to(_I64) * US_PER_MIN + \
                vals["second"].to(_I64) * US_PER_SEC + \
                vals["millis"].to(_I64) * 1000
            if self.out == "unix":
                us = _fdiv(us, US_PER_SEC)
            v = torch.where(ok, us, zero)
        return numeric_column(v, ok, self.dtype)


@dataclass(frozen=True, eq=False)
class FromUnixtime(Expression):
    """from_unixtime(seconds, fmt) -> string (reference: GpuFromUnixTime)."""

    child: Expression
    fmt: str = "yyyy-MM-dd HH:mm:ss"

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return FromUnixtime(c[0], self.fmt)

    @property
    def dtype(self):
        return T.string(max(_safe_width(self.fmt), 1))

    @property
    def nullable(self):
        return True

    def device_unsupported_reason(self):
        return _format_reason(self.fmt)

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        ts = numeric_column(c.data.to(_I64) * US_PER_SEC, c.validity,
                            T.TIMESTAMP)
        return _format(ts, self.fmt)


_TRUNC_DATE_LEVELS = {"year": "year", "yyyy": "year", "yy": "year",
                      "quarter": "quarter", "month": "month", "mon": "month",
                      "mm": "month", "week": "week"}
_TRUNC_TS_LEVELS = dict(_TRUNC_DATE_LEVELS,
                        day="day", dd="day", hour="hour", minute="minute",
                        second="second")


@dataclass(frozen=True, eq=False)
class TruncDateTime(Expression):
    """trunc(date, level) / date_trunc(level, ts). A level it does not know
    gives null (Spark's behavior, not an error)."""

    child: Expression
    level: str = "month"
    to_timestamp: bool = False      # date_trunc keeps TimestampType

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return TruncDateTime(c[0], self.level, self.to_timestamp)

    @property
    def dtype(self):
        return T.TIMESTAMP if self.to_timestamp else T.DATE

    @property
    def nullable(self):
        return True

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        levels = _TRUNC_TS_LEVELS if self.to_timestamp else \
            _TRUNC_DATE_LEVELS
        lvl = levels.get(self.level.lower())
        if lvl is None:
            z = torch.zeros(c.data.shape[0], dtype=self.dtype.storage_dtype,
                            device=c.data.device)
            return numeric_column(z, torch.zeros_like(c.validity),
                                  self.dtype)
        days = _days_of(c)
        y, m, d = civil_from_days(days)
        one = torch.ones_like(m)
        if lvl == "year":
            tdays = days_from_civil(y, one, one)
        elif lvl == "quarter":
            tdays = days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1, one)
        elif lvl == "month":
            tdays = days_from_civil(y, m, one)
        elif lvl == "week":
            tdays = (days - _mod(days + 3, 7)).to(_I32)
        else:
            tdays = days.to(_I32)
        if not self.to_timestamp:
            return numeric_column(tdays, c.validity, T.DATE)
        us = tdays.to(_I64) * US_PER_DAY
        if lvl in ("hour", "minute", "second") and \
                c.dtype.kind is TypeKind.TIMESTAMP:
            # sub-day truncation only on real timestamps: a DATE child
            # holds days, already at day granularity
            unit = {"hour": US_PER_HOUR, "minute": US_PER_MIN,
                    "second": US_PER_SEC}[lvl]
            us = _fdiv(c.data.to(_I64), unit) * unit
        return numeric_column(us, c.validity, T.TIMESTAMP)


@dataclass(frozen=True, eq=False)
class MonthsBetween(Expression):
    """months_between(end, start[, roundOff]), Spark's rule: whole months
    where the days of the month match (time of day ignored) or both are
    their month's last, else fractional by (day and time difference) /
    31."""

    end: Expression
    start: Expression
    round_off: bool = True

    @property
    def children(self):
        return (self.end, self.start)

    def with_children(self, c):
        return MonthsBetween(c[0], c[1], self.round_off)

    @property
    def dtype(self):
        return T.FLOAT64

    def eval(self, batch, ctx=EvalContext()):
        a = self.end.eval(batch, ctx)
        b = self.start.eval(batch, ctx)
        fa, fb = _civil_fields(a), _civil_fields(b)
        f64 = torch.float64
        months = (fa["year"] - fb["year"]).to(f64) * 12 + \
            (fa["month"] - fb["month"]).to(f64)
        la = _month_len(fa["year"], fa["month"])
        lb = _month_len(fb["year"], fb["month"])
        both_last = (fa["day"] == la) & (fb["day"] == lb)
        sec_a = fa["hour"] * 3600 + fa["minute"] * 60 + fa["second"]
        sec_b = fb["hour"] * 3600 + fb["minute"] * 60 + fb["second"]
        whole = fa["day"] == fb["day"]
        frac = ((fa["day"] - fb["day"]).to(f64) +
                (sec_a - sec_b).to(f64) / 86400.0) / 31.0
        v = torch.where(whole | both_last, months, months + frac)
        if self.round_off:
            v = torch.round(v * 1e8) / 1e8
        return numeric_column(v, a.validity & b.validity, T.FLOAT64)


_DAY_NAMES = ["monday", "tuesday", "wednesday", "thursday", "friday",
              "saturday", "sunday"]


@dataclass(frozen=True, eq=False)
class NextDay(Expression):
    """next_day(date, dayName): the first date strictly after ``date`` on
    the named weekday; a name it does not know gives null (Spark
    non-ANSI)."""

    child: Expression
    day_name: str = "monday"

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return NextDay(c[0], self.day_name)

    @property
    def dtype(self):
        return T.DATE

    @property
    def nullable(self):
        return True

    def _target(self):
        s = self.day_name.strip().lower()
        if len(s) < 2:
            return None
        for i, full in enumerate(_DAY_NAMES):
            if full.startswith(s):
                return i
        return None

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        t = self._target()
        if t is None:
            return numeric_column(
                torch.zeros(c.data.shape[0], dtype=_I32,
                            device=c.data.device),
                torch.zeros_like(c.validity), T.DATE)
        days = _days_of(c)                 # a timestamp floors to its day
        w = _mod(days + 3, 7)              # Monday = 0 (1970-01-01: 3)
        delta = _mod(t - w + 7, 7)
        delta = torch.where(delta == 0, torch.full_like(delta, 7), delta)
        return numeric_column((days + delta).to(_I32), c.validity, T.DATE)


# convenience builders, under the JAX package's names
def year(e):
    return ExtractDatePart(e, "year")


def month(e):
    return ExtractDatePart(e, "month")


def dayofmonth(e):
    return ExtractDatePart(e, "day")


def quarter(e):
    return ExtractDatePart(e, "quarter")


def dayofweek(e):
    return ExtractDatePart(e, "dayofweek")


def dayofyear(e):
    return ExtractDatePart(e, "dayofyear")


def weekofyear(e):
    return ExtractDatePart(e, "weekofyear")


def hour(e):
    return ExtractDatePart(e, "hour")


def minute(e):
    return ExtractDatePart(e, "minute")


def second(e):
    return ExtractDatePart(e, "second")


def date_add(e, days):
    return DateAddSub(e, lit_if_needed(days), False)


def date_sub(e, days):
    return DateAddSub(e, lit_if_needed(days), True)


def datediff(end, start):
    return DateDiff(end, start)


def add_months(e, months):
    return AddMonths(e, lit_if_needed(months))


def date_format(e, fmt):
    return DateFormat(e, fmt)


def to_date(e, fmt="yyyy-MM-dd"):
    return ParseDateTime(e, fmt, "date")


def to_timestamp(e, fmt="yyyy-MM-dd HH:mm:ss"):
    return ParseDateTime(e, fmt, "timestamp")


def unix_timestamp(e, fmt="yyyy-MM-dd HH:mm:ss"):
    return ParseDateTime(e, fmt, "unix")


def from_unixtime(e, fmt="yyyy-MM-dd HH:mm:ss"):
    return FromUnixtime(e, fmt)


def trunc(e, level):
    return TruncDateTime(e, level, to_timestamp=False)


def date_trunc(level, e):
    return TruncDateTime(e, level, to_timestamp=True)


def months_between(end, start, round_off=True):
    return MonthsBetween(end, start, round_off)


def next_day(e, day_name):
    return NextDay(e, day_name)


# ---------------------------------------------------------------------------
# Time zones (reference: GpuFromUTCTimestamp / GpuToUTCTimestamp with the
# transition tables of GpuTimeZoneDB): a table built on the host per zone,
# one searchsorted into it on the device
# ---------------------------------------------------------------------------

_TZ_CACHE: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}


def _tz_transitions(tz_name: str) -> Tuple[np.ndarray, np.ndarray]:
    """(instants_us, offsets_us) int64 arrays: the UTC instants at which
    the zone's offset changes, and the offset in force from each on. It
    covers 1900-2100 by probing ``zoneinfo`` every 6 hours (which catches
    days with two shifts) and bisecting each change to the second. Raises
    where the zone database lacks the zone."""
    import datetime as dt
    from zoneinfo import ZoneInfo
    if tz_name in _TZ_CACHE:
        return _TZ_CACHE[tz_name]
    tz = ZoneInfo(tz_name)

    def off_s(ts_s: int) -> int:
        d = dt.datetime.fromtimestamp(ts_s, dt.timezone.utc).astimezone(tz)
        return int(d.utcoffset().total_seconds())

    start = int(dt.datetime(1900, 1, 1, tzinfo=dt.timezone.utc).timestamp())
    end = int(dt.datetime(2100, 1, 1, tzinfo=dt.timezone.utc).timestamp())
    step = 6 * 3600
    trans = [-(1 << 62)]
    offs = [off_s(start)]
    prev, t = offs[0], start
    while t < end:
        nt = min(t + step, end)
        o = off_s(nt)
        if o != prev:
            lo, hi = t, nt
            while hi - lo > 1:
                mid = (lo + hi) // 2
                if off_s(mid) == prev:
                    lo = mid
                else:
                    hi = mid
            trans.append(hi * 1_000_000)
            offs.append(off_s(hi))
            prev = offs[-1]
        t = nt
    out = (np.asarray(trans, np.int64),
           np.asarray(offs, np.int64) * 1_000_000)
    _TZ_CACHE[tz_name] = out
    return out


@dataclass(frozen=True, eq=False)
class UTCTimestampConv(Expression):
    """from_utc_timestamp / to_utc_timestamp with a literal zone id (the
    reference requires a literal zone too). ``to_utc`` resolves a local
    wall time as Java does: the earlier offset in an overlap, shifted
    forward through a gap."""

    child: Expression = None  # type: ignore
    tz: str = "UTC"
    to_utc: bool = False

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return UTCTimestampConv(c[0], self.tz, self.to_utc)

    @property
    def dtype(self):
        return T.TIMESTAMP

    def device_unsupported_reason(self):
        try:
            _tz_transitions(self.tz)
        except Exception:
            return f"unknown time zone {self.tz!r}"
        return None

    def eval(self, batch, ctx=EvalContext()):
        trans, offs = _tz_transitions(self.tz)
        c = self.child.eval(batch, ctx)
        dev = c.data.device
        ts = c.data.to(_I64).contiguous()
        od = _table(offs, dev)
        if not self.to_utc:
            td = _table(trans, dev)
            ix = (torch.searchsorted(td, ts, right=True) - 1).clamp(
                0, td.shape[0] - 1)
            out = ts + od[ix]
        else:
            # transition k's earlier offset holds for local times below
            # T_k + max(o_{k-1}, o_k): Java's resolution of overlaps (the
            # earlier offset) and of gaps (shifted forward)
            cd = _table(trans[1:] + np.maximum(offs[:-1], offs[1:]), dev)
            ix = torch.searchsorted(cd, ts, right=True).clamp(
                0, od.shape[0] - 1)
            out = ts - od[ix]
        return numeric_column(out, c.validity, T.TIMESTAMP)
