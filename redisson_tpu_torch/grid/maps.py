"""Maps — → org/redisson/RedissonMap.java (RMap over Redis hashes) and
RedissonMapCache.java (per-entry TTL/max-idle via companion timeout
structures + EvictionScheduler; here TTLs live beside the entries and the
grid sweeper prunes them).

Keys and values are stored codec-encoded (hash-field semantics of the
reference: equality is on serialized bytes).

The port's copy of ``redisson_tpu/grid/maps.py``.
"""

from __future__ import annotations

import time
from typing import Any, Iterable, Optional

from redisson_tpu_torch.grid.base import GridObject, journaled

_MISSING = object()


class _MapValue:
    """dict: key bytes -> (value bytes, expire_at|None, max_idle_s|None,
    last_access).  ``on_expire`` (not persisted — see __getstate__) is
    an optional callback fired when lazy expiry reaps a slot, so cache
    layers can surface JSR-107 Expired events."""

    __slots__ = ("data", "on_expire")

    def __init__(self):
        self.data: dict[bytes, list] = {}
        self.on_expire = None

    def __getstate__(self):
        return self.data  # callbacks are process-local, never persisted

    def __setstate__(self, data):
        self.data = data
        self.on_expire = None

    def live(self, kb: bytes, now: Optional[float] = None, touch: bool = False):
        """Liveness check with lazy expiry.  ``touch`` refreshes the
        max-idle clock — only genuine value reads (RMapCache getAll/get
        semantics) pass it; size()/views/sweeper must NOT keep idle
        entries alive."""
        slot = self.data.get(kb)
        if slot is None:
            return None
        now = now or time.time()
        vb, exp, idle, last = slot
        if exp is not None and now >= exp:
            del self.data[kb]
            if self.on_expire is not None:
                self.on_expire(kb, vb)
            return None
        if idle is not None and now - last >= idle:
            del self.data[kb]
            if self.on_expire is not None:
                self.on_expire(kb, vb)
            return None
        if touch:
            slot[3] = now
        return slot

    def prune_expired(self, now: float) -> None:
        for kb in list(self.data.keys()):
            self.live(kb, now)


@journaled("put", "fast_put", "put_if_absent", "put_all", "remove",
           "fast_remove", "replace", "add_and_get", "clear")
class Map(GridObject):
    KIND = "map"

    @staticmethod
    def _new_value():
        return _MapValue()

    # -- entry listeners (→ RMapCache#addListener: EntryCreated/Updated/
    # Removed listeners ride the client's topic bus on the map's own
    # event channel, so every handle sees every mutation.  TTL expiry is
    # lazy/sweeper-driven with no client context, so no Expired event
    # fires — the reference's expired-listener has no analog here) --------

    _EVENT_CREATED = "created"
    _EVENT_UPDATED = "updated"
    _EVENT_REMOVED = "removed"

    def _event_channel(self) -> str:
        return f"{self._name}:map-events"

    def add_listener(self, listener, event: Optional[str] = None) -> int:
        """``listener(event, key, value)``; ``event`` filters to one of
        'created'/'updated'/'removed' (None = all)."""
        bus = self._client._topic_bus

        def on_event(channel, message):
            ev, key, value = message
            if event is None or ev == event:
                listener(ev, key, value)

        return bus.subscribe(self._event_channel(), on_event)

    def remove_listener(self, listener_id: int) -> None:
        self._client._topic_bus.unsubscribe(self._event_channel(), listener_id)

    def _emit(self, event: str, key, value) -> None:
        bus = getattr(self._client, "_topic_bus", None)
        if bus is not None and bus.count_listeners(self._event_channel()):
            bus.publish(self._event_channel(), (event, key, value))

    # -- core --------------------------------------------------------------

    def put(self, key: Any, value: Any) -> Any:
        """→ RMap#put: returns the previous value (or None)."""
        with self._store.lock:
            e = self._entry()
            kb = self._enc_key(key)
            prev = e.value.live(kb)
            e.value.data[kb] = [self._enc(value), None, None, time.time()]
        self._emit(
            self._EVENT_UPDATED if prev is not None else self._EVENT_CREATED,
            key,
            value,
        )
        return None if prev is None else self._dec(prev[0])

    def fast_put(self, key: Any, value: Any) -> bool:
        """→ RMap#fastPut: True iff the key was new (skips prev fetch)."""
        with self._store.lock:
            e = self._entry()
            kb = self._enc_key(key)
            existed = e.value.live(kb) is not None
            e.value.data[kb] = [self._enc(value), None, None, time.time()]
        self._emit(
            self._EVENT_UPDATED if existed else self._EVENT_CREATED, key, value
        )
        return not existed

    def put_if_absent(self, key: Any, value: Any) -> Any:
        with self._store.lock:
            e = self._entry()
            kb = self._enc_key(key)
            cur = e.value.live(kb)
            if cur is not None:
                return self._dec(cur[0])
            e.value.data[kb] = [self._enc(value), None, None, time.time()]
        self._emit(self._EVENT_CREATED, key, value)
        return None

    def get(self, key: Any) -> Any:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return None
            slot = e.value.live(self._enc_key(key), touch=True)
            return None if slot is None else self._dec(slot[0])

    def get_all(self, keys: Iterable[Any]) -> dict:
        with self._store.lock:
            out = {}
            for k in keys:
                v = self.get(k)
                if v is not None:
                    out[k] = v
            return out

    def put_all(self, mapping: dict) -> None:
        with self._store.lock:
            for k, v in mapping.items():
                self.fast_put(k, v)

    def remove(self, key: Any, expected: Any = _MISSING) -> Any:
        """→ RMap#remove(key) / remove(key, value)."""
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return None if expected is _MISSING else False
            kb = self._enc_key(key)
            slot = e.value.live(kb)
            if slot is None:
                return None if expected is _MISSING else False
            if expected is not _MISSING:
                if slot[0] != self._enc(expected):
                    return False
                del e.value.data[kb]
                removed = True
            else:
                del e.value.data[kb]
                removed = False
        self._emit(self._EVENT_REMOVED, key, self._dec(slot[0]))
        return True if removed else self._dec(slot[0])

    def fast_remove(self, *keys: Any) -> int:
        removed = []
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return 0
            for k in keys:
                kb = self._enc_key(k)
                if e.value.live(kb) is not None:
                    del e.value.data[kb]
                    removed.append(k)
        for k in removed:
            self._emit(self._EVENT_REMOVED, k, None)
        return len(removed)

    def replace(self, key: Any, value: Any, new_value: Any = _MISSING):
        """→ RMap#replace(key, newValue) returning the previous value, or
        RMap#replace(key, oldValue, newValue) returning success."""
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return None if new_value is _MISSING else False
            kb = self._enc_key(key)
            slot = e.value.live(kb)
            if slot is None:
                return None if new_value is _MISSING else False
            if new_value is not _MISSING:
                if slot[0] != self._enc(value):
                    return False
                slot[0] = self._enc(new_value)
                out = True
                emitted = new_value
            else:
                out = self._dec(slot[0])
                slot[0] = self._enc(value)
                emitted = value
        self._emit(self._EVENT_UPDATED, key, emitted)
        return out

    def contains_key(self, key: Any) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            return e is not None and e.value.live(self._enc_key(key)) is not None

    def contains_value(self, value: Any) -> bool:
        vb = self._enc(value)
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return False
            now = time.time()
            return any(
                e.value.live(kb, now) is not None and e.value.data.get(kb, [None])[0] == vb
                for kb in list(e.value.data.keys())
            )

    def size(self) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return 0
            e.value.prune_expired(time.time())
            return len(e.value.data)

    def is_empty(self) -> bool:
        return self.size() == 0

    def add_and_get(self, key: Any, delta) -> Any:
        """→ RMap#addAndGet (HINCRBY analog on the decoded value)."""
        with self._store.lock:
            cur = self.get(key) or 0
            new = cur + delta
            self.fast_put(key, new)
            return new

    # -- views -------------------------------------------------------------

    def key_set(self, pattern: Optional[str] = None) -> list:
        import fnmatch

        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return []
            e.value.prune_expired(time.time())
            keys = [self._dec_key(kb) for kb in e.value.data.keys()]
            if pattern is not None:
                keys = [k for k in keys if fnmatch.fnmatchcase(str(k), pattern)]
            return keys

    def values(self) -> list:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return []
            e.value.prune_expired(time.time())
            return [self._dec(slot[0]) for slot in e.value.data.values()]

    def entry_set(self) -> list:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return []
            e.value.prune_expired(time.time())
            return [
                (self._dec_key(kb), self._dec(slot[0]))
                for kb, slot in e.value.data.items()
            ]

    def key_iterator(self, pattern: Optional[str] = None, count: int = 10):
        """HSCAN-cursor idiom: lazy snapshot iteration in chunks (see
        Keys.scan_iterator for the guarantee)."""
        from redisson_tpu_torch.grid.keys import _chunked_snapshot_iter

        return _chunked_snapshot_iter(lambda: self.key_set(pattern), count)

    def entry_iterator(self, count: int = 10):
        for k in self.key_iterator(count=count):
            v = self.get(k)
            if v is not None:
                yield (k, v)

    def read_all_map(self) -> dict:
        return dict(self.entry_set())

    def clear(self) -> bool:
        return self.delete()

    # dict-protocol sugar
    def __getitem__(self, key):
        return self.get(key)

    def __setitem__(self, key, value):
        self.fast_put(key, value)

    def __contains__(self, key):
        return self.contains_key(key)

    def __len__(self):
        return self.size()


@journaled("put", "fast_put", "put_if_absent", "add_and_get")
class MapCache(Map):
    """→ org/redisson/RedissonMapCache.java: RMap + per-entry TTL/max-idle.
    The grid sweeper calls ``prune_expired`` (the MapCacheEvictionTask
    analog); reads prune lazily as in the reference's Lua guards."""

    KIND = "mapcache"

    def put(self, key: Any, value: Any, ttl_seconds: Optional[float] = None,
            max_idle_seconds: Optional[float] = None) -> Any:
        with self._store.lock:
            prev = self.get(key)
            self._put_slot(key, value, ttl_seconds, max_idle_seconds)
        self._emit(
            self._EVENT_UPDATED if prev is not None else self._EVENT_CREATED,
            key,
            value,
        )
        return prev

    def fast_put(self, key: Any, value: Any, ttl_seconds: Optional[float] = None,
                 max_idle_seconds: Optional[float] = None) -> bool:
        with self._store.lock:
            e = self._entry()
            existed = e.value.live(self._enc_key(key)) is not None
            self._put_slot(key, value, ttl_seconds, max_idle_seconds)
        self._emit(
            self._EVENT_UPDATED if existed else self._EVENT_CREATED, key, value
        )
        return not existed

    def put_if_absent(self, key: Any, value: Any, ttl_seconds: Optional[float] = None,
                      max_idle_seconds: Optional[float] = None) -> Any:
        with self._store.lock:
            cur = self.get(key)
            if cur is not None:
                return cur
            self._put_slot(key, value, ttl_seconds, max_idle_seconds)
        self._emit(self._EVENT_CREATED, key, value)
        return None

    def add_and_get(self, key: Any, delta) -> Any:
        """→ RMapCache#addAndGet: the numeric update must PRESERVE the
        entry's TTL/max-idle (the inherited path rewrote the slot with
        fresh None timeouts — a 10s-TTL counter became immortal)."""
        with self._store.lock:
            e = self._entry()
            kb = self._enc_key(key)
            slot = e.value.live(kb)
            cur = 0 if slot is None else self._dec(slot[0])
            new = (cur or 0) + delta
            if slot is None:
                e.value.data[kb] = [self._enc(new), None, None, __import__("time").time()]
            else:
                slot[0] = self._enc(new)  # timeouts untouched
            return new

    def _put_slot(self, key, value, ttl_s, idle_s) -> None:
        e = self._entry()
        now = time.time()
        exp = None if ttl_s is None else now + float(ttl_s)
        e.value.data[self._enc_key(key)] = [
            self._enc(value), exp, None if idle_s is None else float(idle_s), now
        ]

    def remain_time_to_live_entry(self, key: Any) -> int:
        """Entry-level TTL in ms (-2 absent, -1 no TTL)."""
        with self._store.lock:
            e = self._entry(create=False)
            slot = None if e is None else e.value.live(self._enc_key(key))
            if slot is None:
                return -2
            if slot[1] is None:
                return -1
            return max(0, int((slot[1] - time.time()) * 1000))
