"""Counters — → org/redisson/RedissonAtomicLong.java, RedissonAtomicDouble,
RedissonLongAdder/RedissonDoubleAdder (topic-coordinated in the reference;
in-process the adder IS its sum), RedissonIdGenerator (allocation-block id
ranges).
"""

from __future__ import annotations

from redisson_tpu_torch.grid.base import GridObject, journaled


def _as_int(v) -> int:
    """Strict integer view of a counter value.  A fractional value (left
    by a RESP INCRBYFLOAT on this key) raises like Java's
    NumberFormatException in RedissonAtomicLong — silently truncating
    would lose the fraction on the next write."""
    if isinstance(v, int):
        return v  # no float round-trip: ints past 2**53 (or 10**400)
    if not float(v).is_integer():
        raise ValueError(f"counter value {v!r} is not an integer")
    return int(v)


@journaled("set", "add_and_get", "get_and_add", "increment_and_get",
           "decrement_and_get", "get_and_increment", "get_and_decrement",
           "get_and_set", "compare_and_set", "get_and_delete")
class AtomicLong(GridObject):
    KIND = "atomiclong"
    # One counter FAMILY on read: RESP INCR/INCRBYFLOAT may legitimately
    # flip an entry between the two kinds (serve/resp.py _numeric_incr),
    # and a live handle of either class must keep working across that.
    _FAMILY = ("atomiclong", "atomicdouble")

    @staticmethod
    def _new_value():
        return 0

    def _entry(self, create: bool = True):
        e = self._store.get_entry(self._name)
        if e is not None and e.kind not in self._FAMILY:
            raise TypeError(
                f"object {self._name!r} holds a {e.kind}, not a {self.KIND}"
            )
        if e is None and create:
            e = self._store.ensure_entry(self._name, self.KIND, self._new_value)
        return e

    def get(self) -> int:
        e = self._entry(create=False)
        return 0 if e is None else _as_int(e.value)

    def set(self, value: int) -> None:
        self._store.put_entry(self._name, self.KIND, int(value))

    def add_and_get(self, delta: int) -> int:
        with self._store.lock:
            e = self._entry()
            e.value = _as_int(e.value) + int(delta)
            e.kind = self.KIND  # an integer write re-claims the int kind
            return e.value

    def get_and_add(self, delta: int) -> int:
        with self._store.lock:
            e = self._entry()
            old = _as_int(e.value)
            e.value = old + int(delta)
            e.kind = self.KIND
            return old

    def increment_and_get(self) -> int:
        return self.add_and_get(1)

    def decrement_and_get(self) -> int:
        return self.add_and_get(-1)

    def get_and_increment(self) -> int:
        return self.get_and_add(1)

    def get_and_decrement(self) -> int:
        return self.get_and_add(-1)

    def get_and_set(self, value: int) -> int:
        with self._store.lock:
            e = self._entry()
            old = _as_int(e.value)
            e.value = int(value)
            e.kind = self.KIND
            return old

    def compare_and_set(self, expect: int, update: int) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            cur = 0 if e is None else _as_int(e.value)  # absent reads as 0
            if cur != int(expect):
                return False  # failed CAS must NOT materialize the key
            self._store.put_entry(self._name, self.KIND, int(update))
            return True

    def get_and_delete(self) -> int:
        with self._store.lock:
            old = self.get()
            self.delete()
            return old


@journaled("set", "add_and_get", "get_and_add", "get_and_set",
           "compare_and_set")
class AtomicDouble(AtomicLong):
    """→ RedissonAtomicDouble — same surface over float."""

    KIND = "atomicdouble"

    @staticmethod
    def _new_value():
        return 0.0

    def get(self) -> float:
        e = self._entry(create=False)
        return 0.0 if e is None else float(e.value)

    def set(self, value: float) -> None:
        self._store.put_entry(self._name, self.KIND, float(value))

    def add_and_get(self, delta: float) -> float:
        with self._store.lock:
            e = self._entry()
            e.value = float(e.value) + float(delta)
            e.kind = self.KIND  # a float write claims the double kind
            return e.value

    def get_and_add(self, delta: float) -> float:
        with self._store.lock:
            e = self._entry()
            old = float(e.value)
            e.value = old + float(delta)
            e.kind = self.KIND
            return old

    def get_and_set(self, value: float) -> float:
        with self._store.lock:
            e = self._entry()
            old = float(e.value)
            e.value = float(value)
            e.kind = self.KIND
            return old

    def compare_and_set(self, expect: float, update: float) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            cur = 0.0 if e is None else float(e.value)
            if cur != float(expect):
                return False  # failed CAS must NOT materialize the key
            self._store.put_entry(self._name, self.KIND, float(update))
            return True


@journaled("add", "increment", "decrement", "reset")
class LongAdder(GridObject):
    """→ RedissonLongAdder.  The reference keeps per-client local counters
    synced over a topic; in-process the shared cell is the sum itself."""

    KIND = "longadder"

    @staticmethod
    def _new_value():
        return 0

    def add(self, delta: int) -> None:
        with self._store.lock:
            e = self._entry()
            e.value = int(e.value) + int(delta)

    def increment(self) -> None:
        self.add(1)

    def decrement(self) -> None:
        self.add(-1)

    def sum(self) -> int:
        e = self._entry(create=False)
        return 0 if e is None else int(e.value)

    def reset(self) -> None:
        self._store.put_entry(self._name, self.KIND, 0)


@journaled("add", "reset")
class DoubleAdder(GridObject):
    KIND = "doubleadder"

    @staticmethod
    def _new_value():
        return 0.0

    def add(self, delta: float) -> None:
        with self._store.lock:
            e = self._entry()
            e.value = float(e.value) + float(delta)

    def sum(self) -> float:
        e = self._entry(create=False)
        return 0.0 if e is None else float(e.value)

    def reset(self) -> None:
        self._store.put_entry(self._name, self.KIND, 0.0)


@journaled("try_init", "next_id")
class IdGenerator(GridObject):
    """→ org/redisson/RedissonIdGenerator.java: ids handed out from locally
    cached allocation blocks reserved atomically from the shared counter."""

    KIND = "idgenerator"

    def __init__(self, name, client):
        super().__init__(name, client)
        self._local_next = 0
        self._local_end = 0

    @staticmethod
    def _new_value():
        # (next unallocated id, allocation block size)
        return {"next": 0, "block": 5000}

    def try_init(self, start: int, allocation_size: int) -> bool:
        if allocation_size < 1:
            raise ValueError(  # a zero-width block would hand out the
                "allocation_size must be >= 1"  # same id forever
            )
        with self._store.lock:
            if self._store.exists(self._name):
                return False
            self._store.put_entry(
                self._name, self.KIND,
                {"next": int(start), "block": int(allocation_size)},
            )
            return True

    def next_id(self) -> int:
        with self._store.lock:
            if self._local_next >= self._local_end:
                e = self._entry()
                start = e.value["next"]
                e.value["next"] = start + e.value["block"]
                self._local_next, self._local_end = start, e.value["next"]
            v = self._local_next
            self._local_next += 1
            return v
