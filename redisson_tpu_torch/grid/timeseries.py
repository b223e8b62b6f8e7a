"""RTimeSeries — → org/redisson/RedissonTimeSeries.java (SURVEY.md §2.3
geo/time row): timestamp-ordered values with optional labels and per-entry
TTL, range queries in both directions, first/last/poll access.

The port's copy of ``redisson_tpu/grid/timeseries.py``.
"""

from __future__ import annotations

import bisect
import time
from typing import Any, Iterable, Optional

from redisson_tpu_torch.grid.base import GridObject


class _TsValue:
    __slots__ = ("ts", "rows")  # parallel: sorted timestamps + row dicts

    def __init__(self):
        self.ts: list[int] = []
        self.rows: list[dict] = []  # {"v": bytes, "label": bytes|None, "exp": float|None}

    def prune_expired(self, now: float) -> None:
        keep_ts, keep_rows = [], []
        for t, r in zip(self.ts, self.rows):
            if r["exp"] is None or now < r["exp"]:
                keep_ts.append(t)
                keep_rows.append(r)
        self.ts, self.rows = keep_ts, keep_rows


class TimeSeries(GridObject):
    KIND = "timeseries"

    @staticmethod
    def _new_value():
        return _TsValue()

    def _live(self, create: bool = False) -> Optional[_TsValue]:
        e = self._entry(create=create)
        if e is None:
            return None
        e.value.prune_expired(time.time())
        return e.value

    # -- writes ------------------------------------------------------------

    def add(self, timestamp: int, value: Any, label: Any = None,
            ttl_seconds: Optional[float] = None) -> None:
        """→ RTimeSeries#add: same-timestamp add REPLACES (reference
        semantics — one value per timestamp)."""
        with self._store.lock:
            v = self._live(create=True)
            row = {
                "v": self._enc(value),
                "label": None if label is None else self._enc(label),
                "exp": None if ttl_seconds is None else time.time() + ttl_seconds,
            }
            i = bisect.bisect_left(v.ts, int(timestamp))
            if i < len(v.ts) and v.ts[i] == int(timestamp):
                v.rows[i] = row
            else:
                v.ts.insert(i, int(timestamp))
                v.rows.insert(i, row)

    def add_all(self, entries: Iterable[tuple], ttl_seconds: Optional[float] = None) -> None:
        for ts, value in entries:
            self.add(ts, value, ttl_seconds=ttl_seconds)

    def remove(self, timestamp: int) -> bool:
        with self._store.lock:
            v = self._live()
            if v is None:
                return False
            i = bisect.bisect_left(v.ts, int(timestamp))
            if i < len(v.ts) and v.ts[i] == int(timestamp):
                del v.ts[i]
                del v.rows[i]
                return True
            return False

    def remove_range(self, from_ts: int, to_ts: int) -> int:
        """Removes [from_ts, to_ts] inclusive (reference range semantics)."""
        with self._store.lock:
            v = self._live()
            if v is None:
                return 0
            lo = bisect.bisect_left(v.ts, int(from_ts))
            hi = bisect.bisect_right(v.ts, int(to_ts))
            n = hi - lo
            del v.ts[lo:hi]
            del v.rows[lo:hi]
            return n

    # -- reads -------------------------------------------------------------

    def get(self, timestamp: int) -> Any:
        with self._store.lock:
            v = self._live()
            if v is None:
                return None
            i = bisect.bisect_left(v.ts, int(timestamp))
            if i < len(v.ts) and v.ts[i] == int(timestamp):
                return self._dec(v.rows[i]["v"])
            return None

    def size(self) -> int:
        with self._store.lock:
            v = self._live()
            return 0 if v is None else len(v.ts)

    def range(self, from_ts: int, to_ts: int, limit: Optional[int] = None) -> list:
        """[(timestamp, value)] ascending over [from_ts, to_ts]."""
        with self._store.lock:
            v = self._live()
            if v is None:
                return []
            lo = bisect.bisect_left(v.ts, int(from_ts))
            hi = bisect.bisect_right(v.ts, int(to_ts))
            out = [
                (v.ts[i], self._dec(v.rows[i]["v"])) for i in range(lo, hi)
            ]
            return out if limit is None else out[:limit]

    def range_reversed(self, from_ts: int, to_ts: int, limit: Optional[int] = None) -> list:
        out = self.range(from_ts, to_ts)
        out.reverse()
        return out if limit is None else out[:limit]

    def entry_range(self, from_ts: int, to_ts: int) -> list:
        """[(timestamp, value, label|None)] ascending."""
        with self._store.lock:
            v = self._live()
            if v is None:
                return []
            lo = bisect.bisect_left(v.ts, int(from_ts))
            hi = bisect.bisect_right(v.ts, int(to_ts))
            return [
                (
                    v.ts[i],
                    self._dec(v.rows[i]["v"]),
                    None
                    if v.rows[i]["label"] is None
                    else self._dec(v.rows[i]["label"]),
                )
                for i in range(lo, hi)
            ]

    def first(self, count: int = 1) -> list:
        with self._store.lock:
            v = self._live()
            if v is None:
                return []
            return [self._dec(r["v"]) for r in v.rows[:count]]

    def last(self, count: int = 1) -> list:
        if count <= 0:  # [-0:] is the WHOLE list, not none of it
            return []
        with self._store.lock:
            v = self._live()
            if v is None:
                return []
            return [self._dec(r["v"]) for r in v.rows[-count:]][::-1]

    def first_timestamp(self) -> Optional[int]:
        with self._store.lock:
            v = self._live()
            return v.ts[0] if v and v.ts else None

    def last_timestamp(self) -> Optional[int]:
        with self._store.lock:
            v = self._live()
            return v.ts[-1] if v and v.ts else None

    def poll_first(self, count: int = 1) -> list:
        with self._store.lock:
            v = self._live()
            if v is None:
                return []
            out = [self._dec(r["v"]) for r in v.rows[:count]]
            del v.ts[:count]
            del v.rows[:count]
            return out

    def poll_last(self, count: int = 1) -> list:
        if count <= 0:  # [-0:] slices destroyed the ENTIRE series
            return []
        with self._store.lock:
            v = self._live()
            if v is None or not v.ts:
                return []
            n = min(count, len(v.ts))
            out = [self._dec(r["v"]) for r in v.rows[-n:]][::-1]
            del v.ts[-n:]
            del v.rows[-n:]
            return out
