"""CronExpression — → org/redisson/executor/CronExpression (the Quartz
cron grammar RScheduledExecutorService#schedule(cron) accepts).

Supports the Quartz 6-field form with seconds (``sec min hour dom month
dow``) and the classic 5-field form (minute resolution); ``?`` is
accepted as ``*`` (Quartz day-field convention), along with ``*``,
``*/n``, ``a-b``, ``a-b/n`` and comma lists.

Day-of-week numbering follows the FORM's own convention — the two
grammars disagree and silently firing on the wrong day is worse than
either choice alone:
- 6-field (Quartz): numeric 1=SUN .. 7=SAT (the Quartz convention);
- 5-field (classic cron): numeric 0=SUN .. 6=SAT, with 7 also Sunday;
- SUN..SAT names work identically in both.
Classic cron's dom/dow OR rule also applies: when BOTH day fields are
restricted, a time matches if EITHER matches (vixie semantics; Quartz
requires '?' on one side, which parses as unrestricted here).

The port's copy of ``redisson_tpu/grid/cron.py``.
"""

from __future__ import annotations

from datetime import datetime, timedelta

_DOW_NAMES = {
    "SUN": 0, "MON": 1, "TUE": 2, "WED": 3, "THU": 4, "FRI": 5, "SAT": 6,
}
_MON_NAMES = {
    "JAN": 1, "FEB": 2, "MAR": 3, "APR": 4, "MAY": 5, "JUN": 6,
    "JUL": 7, "AUG": 8, "SEP": 9, "OCT": 10, "NOV": 11, "DEC": 12,
}


def _atom(tok: str, lo: int, hi: int, names, quartz_dow: bool = False) -> int:
    t = tok.upper()
    if names and t in names:
        return names[t]
    v = int(tok)
    if lo == 0 and hi == 6:  # the day-of-week field
        if quartz_dow:
            # Quartz numeric convention: 1=SUN .. 7=SAT.
            if not 1 <= v <= 7:
                raise ValueError(f"Quartz day-of-week {tok!r} outside [1, 7]")
            return v - 1
        if v == 7:
            v = 0  # classic cron: 7 == Sunday too
    if not lo <= v <= hi:
        raise ValueError(f"cron field value {tok!r} outside [{lo}, {hi}]")
    return v


def _parse_field(field: str, lo: int, hi: int, names=None,
                 quartz_dow: bool = False) -> frozenset:
    out: set[int] = set()
    for part in field.split(","):
        step, has_step = 1, False
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
            has_step = True
            if step < 1:
                raise ValueError(f"cron step must be >= 1: {field!r}")
        if part in ("*", "?", ""):
            a, b = lo, hi
        elif "-" in part and not part.lstrip("-").isdigit():
            a_s, b_s = part.split("-", 1)
            a = _atom(a_s, lo, hi, names, quartz_dow)
            b = _atom(b_s, lo, hi, names, quartz_dow)
        else:
            a = _atom(part, lo, hi, names, quartz_dow)
            # Quartz: "n/step" means from n to max (even with step 1 —
            # '0/1' is the standard spelling of 'every'); bare "n" is
            # the single value.
            b = hi if has_step else a
        if b < a:  # wrap range (e.g. FRI-MON)
            out.update(range(a, hi + 1, step))
            out.update(range(lo, b + 1, step))
        else:
            out.update(range(a, b + 1, step))
    return frozenset(out)


class CronExpression:
    def __init__(self, expr: str):
        parts = expr.split()
        if len(parts) == 6:
            self.seconds = _parse_field(parts[0], 0, 59)
            rest = parts[1:]
            quartz = True
        elif len(parts) == 5:
            self.seconds = frozenset({0})
            rest = parts
            quartz = False
        else:
            raise ValueError(
                f"cron expression needs 5 or 6 fields, got {len(parts)}: {expr!r}"
            )
        self.minutes = _parse_field(rest[0], 0, 59)
        self.hours = _parse_field(rest[1], 0, 23)
        self.dom = _parse_field(rest[2], 1, 31)
        self.months = _parse_field(rest[3], 1, 12, _MON_NAMES)
        self.dow = _parse_field(rest[4], 0, 6, _DOW_NAMES, quartz_dow=quartz)
        # Classic cron OR rule: when BOTH day fields are restricted, a
        # time matches if either matches.
        self._dom_star = rest[2].split("/")[0] in ("*", "?")
        self._dow_star = rest[4].split("/")[0] in ("*", "?")
        self.expr = expr

    def _minute_matches(self, dt: datetime) -> bool:
        if not (
            dt.minute in self.minutes
            and dt.hour in self.hours
            and dt.month in self.months
        ):
            return False
        dom_ok = dt.day in self.dom
        dow_ok = (dt.weekday() + 1) % 7 in self.dow  # py Mon=0 → cron Sun=0
        if not self._dom_star and not self._dow_star:
            return dom_ok or dow_ok  # vixie OR semantics
        return dom_ok and dow_ok

    def next_after(self, ts: float) -> float:
        """Epoch seconds of the first fire time strictly after ``ts``."""
        base = datetime.fromtimestamp(ts)
        cur_min = base.replace(second=0, microsecond=0)
        if self._minute_matches(cur_min):
            for s in sorted(self.seconds):
                cand = cur_min + timedelta(seconds=s)
                if cand.timestamp() > ts:
                    return cand.timestamp()
        m = cur_min + timedelta(minutes=1)
        for _ in range(527040):  # bounded scan: 366 days of minutes
            if self._minute_matches(m):
                return (m + timedelta(seconds=min(self.seconds))).timestamp()
            m += timedelta(minutes=1)
        raise ValueError(f"no fire time within a year for {self.expr!r}")

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"CronExpression({self.expr!r})"
