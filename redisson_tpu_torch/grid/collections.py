"""Sets and lists — → org/redisson/RedissonSet.java (Redis sets),
RedissonSetCache (per-element TTL via timeout scores), RedissonList
(Redis lists), RedissonSortedSet (comparator order over a Redis list),
RedissonScoredSortedSet (ZSET), RedissonLexSortedSet (lexicographic ZSET).

Element identity follows the codec-encoded bytes, matching the
reference's serialized-member semantics.

The port's copy of ``redisson_tpu/grid/collections.py``.
"""

from __future__ import annotations

import bisect
import fnmatch
import time
from typing import Any, Iterable, Optional

from redisson_tpu_torch.grid.base import GridObject, journaled


@journaled("add", "add_all", "remove", "remove_random", "union",
           "intersection", "diff")
class Set_(GridObject):
    KIND = "set"

    @staticmethod
    def _new_value():
        return {}  # key bytes -> None (insertion-ordered like Python dict)

    def add(self, value: Any) -> bool:
        with self._store.lock:
            e = self._entry()
            vb = self._enc(value)
            if vb in e.value:
                return False
            e.value[vb] = None
            return True

    def add_all(self, values: Iterable[Any]) -> bool:
        with self._store.lock:
            return any([self.add(v) for v in values])

    def remove(self, value: Any) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return False
            vb = self._enc(value)
            if vb in e.value:  # explicit membership — the old
                del e.value[vb]  # pop(...)-is-None trick silently
                return True  # inverts if stored markers ever change
            return False

    def contains(self, value: Any) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            return e is not None and self._enc(value) in e.value

    def size(self) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            return 0 if e is None else len(e.value)

    def read_all(self) -> list:
        with self._store.lock:
            e = self._entry(create=False)
            return [] if e is None else [self._dec(vb) for vb in e.value]

    def random(self, count: int = 1) -> list:
        """→ RSet#random (SRANDMEMBER)."""
        import random as _random

        with self._store.lock:
            vals = self.read_all()
            return _random.sample(vals, min(count, len(vals)))

    def remove_random(self, count: int = 1) -> list:
        """→ RSet#removeRandom (SPOP)."""
        with self._store.lock:
            got = self.random(count)
            for v in got:
                self.remove(v)
            return got

    def move(self, dest_name: str, value: Any) -> bool:
        """→ RSet#move (SMOVE)."""
        with self._store.lock:
            # WRONGTYPE-check the destination BEFORE removing — including
            # the FOREIGN backend (a sketch object under dest_name would
            # make add() raise after remove() succeeded: element lost).
            self._store.get_entry(dest_name, self.KIND)
            self._store._guard_foreign(dest_name)
            if not self.remove(value):
                return False
            self._client.get_set(dest_name).add(value)
            return True

    # -- set algebra (SUNION/SINTER/SDIFF + *STORE analogs) ----------------

    def _other(self, name: str) -> set:
        return {self._enc(v) for v in self._client.get_set(name).read_all()}

    def union(self, *names: str) -> int:
        with self._store.lock:
            e = self._entry()
            for n in names:
                for vb in self._other(n):
                    e.value[vb] = None
            return len(e.value)

    def intersection(self, *names: str) -> int:
        with self._store.lock:
            e = self._entry()
            keep = set(e.value)
            for n in names:
                keep &= self._other(n)
            e.value = {vb: None for vb in e.value if vb in keep}
            return len(e.value)

    def diff(self, *names: str) -> int:
        with self._store.lock:
            e = self._entry()
            drop = set()
            for n in names:
                drop |= self._other(n)
            e.value = {vb: None for vb in e.value if vb not in drop}
            return len(e.value)

    def read_union(self, *names: str) -> list:
        with self._store.lock:
            out = {self._enc(v): None for v in self.read_all()}
            for n in names:
                for vb in self._other(n):
                    out[vb] = None
            return [self._dec(vb) for vb in out]

    def read_intersection(self, *names: str) -> list:
        with self._store.lock:
            keep = {self._enc(v) for v in self.read_all()}
            for n in names:
                keep &= self._other(n)
            return [self._dec(vb) for vb in keep]

    def __contains__(self, value):
        return self.contains(value)

    def __len__(self):
        return self.size()


@journaled("add", "remove")
class SetCache(GridObject):
    """→ RedissonSetCache: set with per-element TTL."""

    KIND = "setcache"

    class _Value:
        __slots__ = ("data",)

        def __init__(self):
            self.data: dict[bytes, Optional[float]] = {}

        def live(self, vb: bytes, now: Optional[float] = None) -> bool:
            exp = self.data.get(vb, -1)
            if exp == -1 and vb not in self.data:
                return False
            now = now or time.time()
            if exp is not None and exp != -1 and now >= exp:
                del self.data[vb]
                return False
            return vb in self.data

        def prune_expired(self, now: float) -> None:
            for vb in list(self.data.keys()):
                self.live(vb, now)

    @classmethod
    def _new_value(cls):
        return cls._Value()

    def add(self, value: Any, ttl_seconds: Optional[float] = None) -> bool:
        with self._store.lock:
            e = self._entry()
            vb = self._enc(value)
            fresh = not e.value.live(vb)
            e.value.data[vb] = (
                None if ttl_seconds is None else time.time() + float(ttl_seconds)
            )
            return fresh

    def contains(self, value: Any) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            return e is not None and e.value.live(self._enc(value))

    def remove(self, value: Any) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return False
            vb = self._enc(value)
            if not e.value.live(vb):
                return False
            del e.value.data[vb]
            return True

    def size(self) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return 0
            e.value.prune_expired(time.time())
            return len(e.value.data)

    def read_all(self) -> list:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return []
            e.value.prune_expired(time.time())
            return [self._dec(vb) for vb in e.value.data]


@journaled("add", "add_all", "insert", "set", "remove", "remove_at",
           "trim")
class List_(GridObject):
    KIND = "list"

    @staticmethod
    def _new_value():
        return []  # list of value bytes

    def add(self, value: Any) -> bool:
        with self._store.lock:
            self._entry().value.append(self._enc(value))
            self._store.notify()
            return True

    def add_all(self, values: Iterable[Any]) -> bool:
        with self._store.lock:
            vals = [self._enc(v) for v in values]
            self._entry().value.extend(vals)
            self._store.notify()
            return bool(vals)

    def insert(self, index: int, value: Any) -> None:
        with self._store.lock:
            self._entry().value.insert(index, self._enc(value))

    def get(self, index: int) -> Any:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None or not -len(e.value) <= index < len(e.value):
                raise IndexError(index)
            return self._dec(e.value[index])

    def set(self, index: int, value: Any) -> None:
        with self._store.lock:
            e = self._entry()
            e.value[index] = self._enc(value)

    def remove(self, value: Any, count: int = 1) -> bool:
        """→ RList#remove(Object) / LREM semantics for count occurrences."""
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return False
            vb = self._enc(value)
            removed = 0
            while removed < count and vb in e.value:
                e.value.remove(vb)
                removed += 1
            return removed > 0

    def remove_at(self, index: int) -> Any:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                raise IndexError(index)
            return self._dec(e.value.pop(index))

    def index_of(self, value: Any) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return -1
            try:
                return e.value.index(self._enc(value))
            except ValueError:
                return -1

    def contains(self, value: Any) -> bool:
        return self.index_of(value) >= 0

    def size(self) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            return 0 if e is None else len(e.value)

    def read_all(self) -> list:
        with self._store.lock:
            e = self._entry(create=False)
            return [] if e is None else [self._dec(vb) for vb in e.value]

    def sub_list(self, from_index: int, to_index: int) -> list:
        with self._store.lock:
            e = self._entry(create=False)
            return [] if e is None else [self._dec(vb) for vb in e.value[from_index:to_index]]

    def trim(self, from_index: int, to_index: int) -> None:
        """LTRIM: keep [from, to] inclusive (Redis convention).  Negative
        indexes count from the tail — to=-1 keeps through the LAST element
        (the naive to+1 slice wiped the whole list on exactly that, the
        most common negative form); from > to empties the list."""
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return
            n = len(e.value)
            if from_index < 0:
                from_index = max(0, n + from_index)
            if to_index < 0:
                to_index = n + to_index
            if from_index > to_index or to_index < 0:
                e.value[:] = []
            else:
                e.value[:] = e.value[from_index : to_index + 1]

    def __getitem__(self, index):
        return self.get(index)

    def __setitem__(self, index, value):
        self.set(index, value)

    def __len__(self):
        return self.size()


class SortedSet(GridObject):
    """→ RedissonSortedSet: natural-order sorted collection of distinct
    values."""

    KIND = "sortedset"

    @staticmethod
    def _new_value():
        return []  # sorted list of (decoded value, value bytes)

    def add(self, value: Any) -> bool:
        with self._store.lock:
            e = self._entry()
            vb = self._enc(value)
            if any(b == vb for _, b in e.value):
                return False
            bisect.insort(e.value, (value, vb), key=lambda t: t[0])
            return True

    def remove(self, value: Any) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return False
            vb = self._enc(value)
            for i, (_, b) in enumerate(e.value):
                if b == vb:
                    e.value.pop(i)
                    return True
            return False

    def contains(self, value: Any) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            vb = self._enc(value)
            return e is not None and any(b == vb for _, b in e.value)

    def first(self) -> Any:
        with self._store.lock:
            e = self._entry(create=False)
            return None if e is None or not e.value else e.value[0][0]

    def last(self) -> Any:
        with self._store.lock:
            e = self._entry(create=False)
            return None if e is None or not e.value else e.value[-1][0]

    def size(self) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            return 0 if e is None else len(e.value)

    def read_all(self) -> list:
        with self._store.lock:
            e = self._entry(create=False)
            return [] if e is None else [v for v, _ in e.value]


@journaled("add", "add_all", "add_score", "remove",
           "remove_range_by_score", "poll_first", "poll_last")
class ScoredSortedSet(GridObject):
    """→ RedissonScoredSortedSet (Redis ZSET)."""

    KIND = "zset"

    @staticmethod
    def _new_value():
        return {}  # member bytes -> float score

    def add(self, score: float, member: Any) -> bool:
        with self._store.lock:
            e = self._entry()
            mb = self._enc(member)
            fresh = mb not in e.value
            e.value[mb] = float(score)
            return fresh

    def add_all(self, mapping: dict) -> int:
        """mapping: member -> score."""
        with self._store.lock:
            return sum(1 for m, s in mapping.items() if self.add(s, m))

    def add_score(self, member: Any, delta: float) -> float:
        """ZINCRBY."""
        with self._store.lock:
            e = self._entry()
            mb = self._enc(member)
            e.value[mb] = e.value.get(mb, 0.0) + float(delta)
            return e.value[mb]

    def get_score(self, member: Any) -> Optional[float]:
        with self._store.lock:
            e = self._entry(create=False)
            return None if e is None else e.value.get(self._enc(member))

    def remove(self, member: Any) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return False
            return e.value.pop(self._enc(member), None) is not None

    def rank(self, member: Any) -> Optional[int]:
        """ZRANK (ascending, ties by member bytes like Redis lex order)."""
        with self._store.lock:
            order = self._sorted()
            mb = self._enc(member)
            for i, (b, _) in enumerate(order):
                if b == mb:
                    return i
            return None

    def _sorted(self):
        e = self._entry(create=False)
        if e is None:
            return []
        return sorted(e.value.items(), key=lambda kv: (kv[1], kv[0]))

    def value_range(self, start: int, end: int) -> list:
        """ZRANGE start..end inclusive."""
        with self._store.lock:
            order = self._sorted()
            end = len(order) if end == -1 else end + 1
            return [self._dec(b) for b, _ in order[start:end]]

    def entry_range(self, start: int, end: int) -> list:
        with self._store.lock:
            order = self._sorted()
            end = len(order) if end == -1 else end + 1
            return [(self._dec(b), s) for b, s in order[start:end]]

    def value_range_by_score(self, min_score: float, max_score: float) -> list:
        with self._store.lock:
            return [
                self._dec(b)
                for b, s in self._sorted()
                if min_score <= s <= max_score
            ]

    def remove_range_by_score(self, min_score: float, max_score: float) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return 0
            drop = [b for b, s in e.value.items() if min_score <= s <= max_score]
            for b in drop:
                del e.value[b]
            return len(drop)

    def poll_first(self) -> Any:
        """ZPOPMIN."""
        with self._store.lock:
            order = self._sorted()
            if not order:
                return None
            b, _ = order[0]
            self._entry().value.pop(b, None)
            return self._dec(b)

    def poll_last(self) -> Any:
        with self._store.lock:
            order = self._sorted()
            if not order:
                return None
            b, _ = order[-1]
            self._entry().value.pop(b, None)
            return self._dec(b)

    def first(self) -> Any:
        with self._store.lock:
            order = self._sorted()
            return None if not order else self._dec(order[0][0])

    def last(self) -> Any:
        with self._store.lock:
            order = self._sorted()
            return None if not order else self._dec(order[-1][0])

    def count(self, min_score: float, max_score: float) -> int:
        with self._store.lock:
            return len(self.value_range_by_score(min_score, max_score))

    def contains(self, member: Any) -> bool:
        return self.get_score(member) is not None

    def size(self) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            return 0 if e is None else len(e.value)

    def read_all(self) -> list:
        with self._store.lock:
            return [self._dec(b) for b, _ in self._sorted()]


@journaled("add", "add_all", "remove")
class LexSortedSet(GridObject):
    """→ RedissonLexSortedSet: string ZSET, all scores 0, lexicographic
    range ops."""

    KIND = "lexset"

    @staticmethod
    def _new_value():
        return set()  # of str

    def add(self, value: str) -> bool:
        with self._store.lock:
            e = self._entry()
            if value in e.value:
                return False
            e.value.add(value)
            return True

    def add_all(self, values: Iterable[str]) -> int:
        with self._store.lock:
            return sum(1 for v in values if self.add(v))

    def remove(self, value: str) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None or value not in e.value:
                return False
            e.value.discard(value)
            return True

    def contains(self, value: str) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            return e is not None and value in e.value

    def range(self, from_value: str, from_inclusive: bool,
              to_value: str, to_inclusive: bool) -> list:
        """ZRANGEBYLEX."""
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return []
            lo = (lambda v: v >= from_value) if from_inclusive else (lambda v: v > from_value)
            hi = (lambda v: v <= to_value) if to_inclusive else (lambda v: v < to_value)
            return sorted(v for v in e.value if lo(v) and hi(v))

    def range_head(self, to_value: str, inclusive: bool = False) -> list:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return []
            hi = (lambda v: v <= to_value) if inclusive else (lambda v: v < to_value)
            return sorted(v for v in e.value if hi(v))

    def range_tail(self, from_value: str, inclusive: bool = False) -> list:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return []
            lo = (lambda v: v >= from_value) if inclusive else (lambda v: v > from_value)
            return sorted(v for v in e.value if lo(v))

    def count(self, from_value: str, from_inclusive: bool,
              to_value: str, to_inclusive: bool) -> int:
        return len(self.range(from_value, from_inclusive, to_value, to_inclusive))

    def size(self) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            return 0 if e is None else len(e.value)

    def read_all(self) -> list:
        with self._store.lock:
            e = self._entry(create=False)
            return [] if e is None else sorted(e.value)
