"""Framework integrations — the L8 layer (SURVEY.md §1).

The reference ships Spring Cache/session, Hibernate 2nd-level cache and
Tomcat session modules; their Python-idiomatic analogs are:

- ``cached``: a method/function memoization decorator over a named cache
  (→ Spring's @Cacheable/@CacheEvict pair on RedissonSpringCacheManager).
- ``CacheManagerAdapter``: maps cache names to JCache instances with
  per-cache TTL config (→ RedissonSpringCacheManager's CacheConfig map).
- ``SessionStore``: a web-session store with TTL and dict-like sessions
  (→ redisson-tomcat / Spring Session's RedissonSessionRepository);
  framework-agnostic: any WSGI/ASGI middleware can call load/save.

The port's copy of ``redisson_tpu/integrations.py``.
"""

from __future__ import annotations

import functools
import pickle
import uuid
from typing import Any, Optional

from redisson_tpu_torch.grid.jcache import CacheManager as _GridCacheManager


def cached(client, cache_name: str, *, ttl_seconds: Optional[float] = None,
           key_fn=None):
    """→ @Cacheable: memoize through a named JCache.

    ``key_fn(*args, **kwargs)`` overrides the default repr-based key.
    The wrapper exposes ``cache_evict(*args, **kwargs)`` (→ @CacheEvict)
    and ``cache_clear()``.
    """
    cache = client.get_jcache(cache_name, default_ttl_seconds=ttl_seconds)

    def decorate(fn):
        def make_key(args, kwargs):
            if key_fn is not None:
                return key_fn(*args, **kwargs)
            # Function identity in the default key: two functions
            # memoized into one cache_name must not collide on equal
            # arguments (f(1) returning g's cached result).
            ident = (fn.__module__, fn.__qualname__)
            return pickle.dumps((ident, args, tuple(sorted(kwargs.items()))))

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            key = make_key(args, kwargs)
            hit = cache.get(key)
            if hit is not None:
                return hit
            value = fn(*args, **kwargs)
            if value is not None:  # None is the miss sentinel, like Spring's
                cache.put(key, value)  # default null-caching-off behavior
            return value

        def cache_evict(*args, **kwargs):
            cache.remove(make_key(args, kwargs))

        wrapper.cache_evict = cache_evict
        wrapper.cache_clear = cache.clear
        wrapper.cache = cache
        return wrapper

    return decorate


class CacheManagerAdapter(_GridCacheManager):
    """→ RedissonSpringCacheManager: the grid CacheManager plus the
    per-name CacheConfig map (ttl) Spring's manager carries."""

    def __init__(self, client, configs: Optional[dict] = None):
        super().__init__(client)
        self._configs = dict(configs or {})

    def get_cache(self, name: str):
        if name not in self._caches:
            cfg = self._configs.get(name, {})
            return self.create_cache(
                name, default_ttl_seconds=cfg.get("ttl_seconds")
            )
        return super().get_cache(name)

    def get_cache_names(self) -> list:
        return sorted(set(self._configs) | set(self._caches))


class Session(dict):
    """One web session: a dict persisted by its SessionStore."""

    def __init__(self, store: "SessionStore", session_id: str, data: dict):
        super().__init__(data)
        self._store = store
        self.session_id = session_id

    def save(self) -> None:
        self._store.save(self)

    def invalidate(self) -> None:
        self._store.delete(self.session_id)
        self.clear()


class SessionStore:
    """→ redisson-tomcat / Spring Session: TTL'd sessions over the grid
    map catalog.  ``load`` refreshes the inactivity window on access
    (the maxInactiveInterval contract)."""

    def __init__(self, client, *, prefix: str = "session",
                 max_inactive_seconds: float = 1800.0):
        self._client = client
        self._prefix = prefix
        self._ttl = max_inactive_seconds

    def _bucket(self, session_id: str):
        return self._client.get_bucket(f"{self._prefix}:{session_id}")

    def create(self) -> Session:
        sid = uuid.uuid4().hex
        session = Session(self, sid, {})
        self.save(session)
        return session

    def load(self, session_id: str) -> Optional[Session]:
        b = self._bucket(session_id)
        data = b.get()
        if data is None:
            return None
        b.expire(self._ttl)  # touch: sliding inactivity window
        return Session(self, session_id, data)

    def save(self, session: Session) -> None:
        self._bucket(session.session_id).set(dict(session), ttl_seconds=self._ttl)

    def delete(self, session_id: str) -> bool:
        return self._bucket(session_id).delete()
