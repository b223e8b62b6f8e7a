"""JCache — → org.redisson.jcache.* (JSR-107 javax.cache.Cache over a
Redisson map, SURVEY.md §2.3 caching-standards row).

JSR-107 contracts over the MapCache backing:

- ``put`` returns nothing, ``remove`` returns whether a mapping was
  removed, ``get_and_put``/``get_and_remove`` return the previous value,
  iteration yields entries;
- **ExpiryPolicy** (→ javax.cache.expiry): creation/access/update TTLs —
  Created/Accessed/Modified/Eternal policies are the three constructor
  knobs (access TTL rides MapCache's max-idle machinery);
- **entry listeners** (→ javax.cache.event.CacheEntryListener):
  created/updated/removed ride the map event channel
  (grid/maps.py Map.add_listener); *expired* events fire from the lazy
  expiry reaper (_MapValue.on_expire) and the grid sweeper;
- **CacheLoader / CacheWriter** (→ javax.cache.integration):
  read-through loads on miss, write-through mirrors every put/remove to
  the writer BEFORE the cache mutates (the JSR ordering — a failing
  writer must leave the cache unchanged).  Locking policy: UNCONDITIONAL
  ops (put/get_and_put/remove/remove_all(keys)) call the writer OUTSIDE
  the store lock, so slow external I/O never stalls unrelated grid ops;
  CONDITIONAL ops (replace, put_if_absent, remove(k, old), clear-form
  remove_all) call it UNDER the lock — exactly-once writer semantics
  for compare-guarded mutations outweigh lock-freedom on these rarer
  paths;
- **statistics** (→ javax.cache.management.CacheStatisticsMXBean):
  hits/misses/gets/puts/removals + hit percentage, per cache.

The port's copy of ``redisson_tpu/grid/jcache.py``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable, Optional

from redisson_tpu_torch.grid.maps import Map, MapCache

_MISSING = object()


class ExpiryPolicy:
    """→ javax.cache.expiry.ExpiryPolicy: per-event TTLs in seconds.

    - ``CreatedExpiryPolicy``  → ``ExpiryPolicy(creation_ttl=t)``
    - ``AccessedExpiryPolicy`` → ``ExpiryPolicy(access_ttl=t)``
    - ``ModifiedExpiryPolicy`` → ``ExpiryPolicy(update_ttl=t)``
    - ``EternalExpiryPolicy``  → ``ExpiryPolicy()``
    """

    def __init__(self, creation_ttl: Optional[float] = None,
                 access_ttl: Optional[float] = None,
                 update_ttl: Optional[float] = None):
        self.creation_ttl = creation_ttl
        self.access_ttl = access_ttl
        self.update_ttl = update_ttl


class CacheStatistics:
    """→ javax.cache.management.CacheStatisticsMXBean."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.removals = 0

    @property
    def gets(self) -> int:
        return self.hits + self.misses

    @property
    def hit_percentage(self) -> float:
        g = self.gets
        return 0.0 if g == 0 else 100.0 * self.hits / g

    def _hit(self):
        with self._lock:
            self.hits += 1

    def _miss(self):
        with self._lock:
            self.misses += 1

    def _put(self, n=1):
        with self._lock:
            self.puts += n

    def _removal(self, n=1):
        with self._lock:
            self.removals += n


class JCache(MapCache):
    KIND = "mapcache"  # shares MapCache's keyspace semantics

    def __init__(self, name: str, client, *,
                 default_ttl_seconds: Optional[float] = None,
                 expiry_policy: Optional[ExpiryPolicy] = None,
                 cache_loader: Optional[Callable[[Any], Any]] = None,
                 cache_writer: Optional[Any] = None,
                 read_through: bool = False,
                 write_through: bool = False,
                 statistics_enabled: bool = False):
        super().__init__(name, client)
        if expiry_policy is None:
            expiry_policy = ExpiryPolicy(creation_ttl=default_ttl_seconds)
        self._expiry = expiry_policy
        self._loader = cache_loader
        self._writer = cache_writer
        self._read_through = read_through and cache_loader is not None
        self._write_through = write_through and cache_writer is not None
        self.statistics = CacheStatistics() if statistics_enabled else None

    # -- expiry plumbing ----------------------------------------------------

    def _ttl_kwargs(self) -> dict:
        return {
            "ttl_seconds": self._expiry.creation_ttl,
            "max_idle_seconds": self._expiry.access_ttl,
        }

    def _entry(self, create: bool = True):
        e = super()._entry(create)
        if e is not None and e.value.on_expire is None:
            # Surface lazy-expiry reaps as JSR Expired events.  The
            # callback publishes to the map event channel (async
            # delivery pool), so firing under the store lock is safe.
            emit = self._emit
            dec_key = self._dec_key
            dec = self._dec

            def on_expire(kb, vb):
                try:
                    emit("expired", dec_key(kb), dec(vb))
                except Exception:
                    pass  # listener plumbing must never break expiry

            e.value.on_expire = on_expire
        return e

    # -- javax.cache.Cache surface -----------------------------------------

    def get(self, key: Any) -> Any:
        v = super().get(key)
        found = v is not None  # stats: a read-through LOAD is a miss
        if not found and self._read_through:
            v = self._loader(key)
            if v is not None:
                # Loaded entries enter WITHOUT the writer (JSR: loads
                # are not writes) under the creation expiry.
                super().fast_put(key, v, **self._ttl_kwargs())
        if self.statistics is not None:
            (self.statistics._hit if found else self.statistics._miss)()
        return v

    def put(self, key: Any, value: Any) -> None:
        """JSR-107 put returns void; write-through runs FIRST (a failing
        writer leaves the cache unchanged).  An update of an existing
        key re-arms under ``update_ttl`` (ModifiedExpiryPolicy),
        creation under ``creation_ttl``."""
        if self._write_through:
            self._writer.write(key, value)
        with self._store.lock:
            kw = self._ttl_kwargs()
            if (
                self._expiry.update_ttl is not None
                and super().contains_key(key)
            ):
                kw["ttl_seconds"] = self._expiry.update_ttl
            super().fast_put(key, value, **kw)
        if self.statistics is not None:
            self.statistics._put()

    def put_all(self, mapping: dict) -> None:
        for k, v in mapping.items():
            self.put(k, v)

    def get_and_put(self, key: Any, value: Any) -> Any:
        if self._write_through:
            self._writer.write(key, value)
        with self._store.lock:
            # STATIC Map.get: MapCache.put's `self.get` would dispatch
            # to JCache.get — firing the CacheLoader (JSR forbids loads
            # on getAndPut), returning the loaded value instead of None
            # for absent keys, and counting phantom statistics.
            prev = Map.get(self, key)
            kw = self._ttl_kwargs()
            if self._expiry.update_ttl is not None and prev is not None:
                kw["ttl_seconds"] = self._expiry.update_ttl
            super().fast_put(key, value, **kw)
        if self.statistics is not None:
            self.statistics._put()
        return prev

    def put_if_absent(self, key: Any, value: Any) -> bool:
        """JSR-107 contract: True iff the value was set."""
        with self._store.lock:
            if super().contains_key(key):
                return False
            self.put(key, value)
            return True

    def get_all(self, keys: Iterable[Any]) -> dict:
        keys = list(keys)
        # STATIC Map.get per key: Map.get_all's `self.get` would
        # dispatch to JCache.get, double-counting statistics and running
        # the loader under the store lock.
        out = {}
        with self._store.lock:
            for k in keys:
                v = Map.get(self, k)
                if v is not None:
                    out[k] = v
        cached = set(out)  # stats: read-through loads count as misses
        if self._read_through:
            for k in keys:
                if k not in out:
                    v = self._loader(k)  # outside the lock (slow I/O)
                    if v is not None:
                        super().fast_put(k, v, **self._ttl_kwargs())
                        out[k] = v
        if self.statistics is not None:
            for k in keys:
                (self.statistics._hit if k in cached
                 else self.statistics._miss)()
        return out

    def contains_key(self, key: Any) -> bool:
        return super().contains_key(key)

    def access(self, key: Any) -> Any:
        """Value read that refreshes the access-TTL clock (JSR accessed-
        expiry); plain ``get`` already touches via MapCache."""
        return self.get(key)

    def remove(self, key: Any, old_value: Any = None) -> bool:
        if old_value is None:
            if self._write_through:
                self._writer.delete(key)
            # Map.remove (not fast_remove): the removed EVENT must carry
            # the old value, per the JSR CacheEntryRemovedListener shape.
            removed = super().remove(key) is not None
        else:
            # Conditional remove: the writer fires ONLY when the compare
            # succeeds (a failed conditional remove must not touch the
            # external store), atomically under the store lock — see the
            # conditional-op locking policy in the class docstring.
            with self._store.lock:
                if super().get(key) != old_value:
                    return False
                if self._write_through:
                    self._writer.delete(key)
                removed = bool(super().remove(key, old_value))
        if removed and self.statistics is not None:
            self.statistics._removal()
        return removed

    def get_and_remove(self, key: Any) -> Any:
        if self._write_through:
            self._writer.delete(key)
        with self._store.lock:
            # Map.remove (static): the removed EVENT must carry the old
            # value, like JCache.remove — fast_remove would emit None.
            prev = Map.remove(self, key)
        if prev is not None and self.statistics is not None:
            self.statistics._removal()
        return prev

    def replace(self, key: Any, *vals) -> bool:
        """JSR-107 replace: ``replace(k, v)`` = True iff the key
        existed; ``replace(k, old, new)`` = compare-and-replace (the
        three-arg Cache contract — shadowing Map.replace with only the
        two-arg form broke callers written against either surface)."""
        if len(vals) == 1:
            old, value = _MISSING, vals[0]
        elif len(vals) == 2:
            old, value = vals
        else:
            raise TypeError("replace(key, value) or replace(key, old, new)")
        with self._store.lock:
            if not super().contains_key(key):
                return False
            if old is not _MISSING and Map.get(self, key) != old:
                return False
            kw = self._ttl_kwargs()
            if self._expiry.update_ttl is not None:
                kw["ttl_seconds"] = self._expiry.update_ttl
            if self._write_through:
                self._writer.write(key, value)
            super().fast_put(key, value, **kw)
            if self.statistics is not None:
                self.statistics._put()
            return True

    def remove_all(self, keys: Optional[Iterable[Any]] = None) -> None:
        if keys is None:
            # Snapshot + writer deletes + clear under ONE lock hold: a
            # concurrent put between the snapshot and the clear would
            # otherwise vanish from the cache while the external store
            # kept it (see the conditional-op locking policy).
            with self._store.lock:
                entries = self.entry_set()
                if self._write_through:
                    for k, _ in entries:
                        self._writer.delete(k)
                n = len(entries)
                super().clear()
        else:
            keys = list(keys)
            if self._write_through:
                for k in keys:
                    self._writer.delete(k)
            n = super().fast_remove(*keys)
        if self.statistics is not None:
            self.statistics._removal(n)

    def clear(self) -> None:
        """JSR clear: NO writer interaction and no removal stats (the
        spec distinguishes clear from removeAll)."""
        super().clear()

    def load_all(self, keys: Iterable[Any], replace_existing: bool = False) -> int:
        """→ Cache#loadAll (synchronous form): returns loaded count."""
        if self._loader is None:
            return 0
        n = 0
        for k in keys:
            if not replace_existing and super().contains_key(k):
                continue
            v = self._loader(k)
            if v is not None:
                super().fast_put(k, v, **self._ttl_kwargs())
                n += 1
        return n

    # -- listeners (→ javax.cache.event.CacheEntryListener) ----------------

    EVENT_CREATED = "created"
    EVENT_UPDATED = "updated"
    EVENT_REMOVED = "removed"
    EVENT_EXPIRED = "expired"

    def register_cache_entry_listener(self, listener,
                                      event: Optional[str] = None) -> int:
        """``listener(event, key, value)`` with event one of
        created/updated/removed/expired (None = all); returns an id for
        deregistration.  Rides the map event channel, so every handle of
        this cache sees every mutation."""
        return super().add_listener(listener, event)

    def deregister_cache_entry_listener(self, listener_id: int) -> None:
        super().remove_listener(listener_id)

    def __iter__(self):
        return iter(super().entry_set())

    def close(self) -> None:
        """JSR-107 lifecycle no-op (in-process cache)."""

    def is_closed(self) -> bool:
        return False


class CacheManager:
    """→ javax.cache.CacheManager via Redisson's JCacheManager."""

    def __init__(self, client):
        self._client = client
        self._caches: dict[str, JCache] = {}

    def create_cache(self, name: str, **config) -> JCache:
        cache = JCache(name, self._client, **config)
        self._caches[name] = cache
        return cache

    def get_cache(self, name: str) -> Optional[JCache]:
        """JSR-107 getCache: None when the cache does not exist (silently
        creating one dropped the original configuration — a destroyed
        30s-TTL cache came back immortal)."""
        return self._caches.get(name)

    def get_or_create_cache(self, name: str, **config) -> JCache:
        if name in self._caches:
            return self._caches[name]
        return self.create_cache(name, **config)

    def destroy_cache(self, name: str) -> None:
        cache = self._caches.pop(name, None)
        if cache is not None:
            cache.clear()

    def get_cache_names(self) -> list:
        return list(self._caches)
