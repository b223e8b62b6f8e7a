"""RLocalCachedMap — → org/redisson/RedissonLocalCachedMap.java +
org/redisson/cache/ (LocalCacheView, LRU caches, invalidation-topic sync
strategies).

The reference keeps a near cache in each client and invalidates peers
through a topic; writes publish the touched key hashes.  Here the shared
state is the grid Map entry and invalidation rides the client's TopicBus
on the map's own ``{name}:topic`` channel.

The near cache itself is ONE ``ShardedLRUStore`` per CLIENT, shared by
every LocalCachedMap handle and tenant-keyed by map name: two handles to one map
share hits — a key warmed through handle A answers handle B's ``get``
from host memory — instead of each handle refetching into a private
OrderedDict.  Coherence across handles is the sketch near cache's
epoch idiom (cache/nearcache.py): a per-map GENERATION bumps on every
write and every processed invalidation, and a reader installs its
backing-map result only if the generation it sampled before the read is
still current — a racing write retires the in-flight install instead of
letting it cache a stale value.

Riding the shared store gives per-tenant byte quotas
(``cache_max_bytes``) on top of the entry bound, and
hit/miss/eviction stats (``cache_stats()``) for free.

Sync strategies (→ SyncStrategy): INVALIDATE (default) clears peer cache
entries on write; UPDATE pushes the new value; NONE publishes nothing.

The port's copy of ``redisson_tpu/grid/local_cached_map.py``.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch.cache import MISS, ShardedLRUStore
from redisson_tpu_torch.grid.maps import Map, _MISSING

INVALIDATE = "invalidate"
UPDATE = "update"
NONE = "none"

_HUB_LOCK = _witness.named(threading.Lock(), "grid.localmap.hub")


def _approx_nbytes(kb: bytes, value: Any) -> int:
    """Caller-estimated entry size for the byte quota: key bytes + a flat
    per-entry overhead + the value's obvious payload (sized types only —
    arbitrary objects count a constant; the bound is a budget, not an
    audit)."""
    if isinstance(value, (bytes, bytearray, str)):
        vb = len(value)
    else:
        vb = 64
    return 96 + len(kb) + vb


class _MapCacheHub:
    """Per-client shared map near cache: the store plus per-map-name
    generation counters (the install guard).  Budget grows to the largest
    any handle asked for; per-map byte/entry quotas are tenant limits."""

    def __init__(self):
        # Few shards: each map's traffic is a handful of user threads
        # plus the TopicBus pool; tenant quotas do the real bounding.
        self.store = ShardedLRUStore(max_bytes=64 << 20, nshards=4)
        self.lock = _witness.named(threading.Lock(), "grid.localmap.gens")
        self.gens: dict = {}
        # Generation FLOOR (the SketchNearCache._prune_locked idiom):
        # ``gens`` is folded back toward the floor once it outgrows the
        # threshold, keeping name-churn workloads (TTL'd per-session
        # maps) from leaking one dict entry per map name forever.  A
        # pruned name's in-flight reads can never install (the floor
        # rises past its last generation, so their sampled gen no longer
        # matches); a pruned name that returns resumes ABOVE it.
        self.floor = 0
        self._prune_at = 4096

    def gen(self, name) -> int:
        g = self.gens.get(name)  # dict probe: atomic under the GIL
        return self.floor if g is None else g

    def bump(self, name) -> None:
        with self.lock:
            self.gens[name] = self.gen(name) + 1
            if len(self.gens) > self._prune_at:
                self._prune_locked()

    def _prune_locked(self) -> None:
        floor, keep = self.floor, {}
        for n, g in self.gens.items():
            if self.store.tenant_entry_count(n):
                keep[n] = g
            else:
                floor = max(floor, g)
        self.floor = floor + 1
        self.gens = keep
        self._prune_at = max(4096, 2 * len(keep))

    def install_if(self, name, key, value, nbytes, gen) -> bool:
        """Install a read-through result only if no write/invalidation
        landed since the reader sampled ``gen`` — the sampled-generation
        idiom shared with SketchNearCache.install."""
        with self.lock:
            if self.gen(name) != gen:
                return False
            return self.store.put(name, key, value, nbytes)

    def ensure_budget(self, max_bytes: int) -> None:
        with self.lock:
            if max_bytes > self.store.max_bytes:
                self.store.resize(max_bytes=max_bytes)


def _hub_for(client) -> _MapCacheHub:
    hub = getattr(client, "_map_cache_hub", None)
    if hub is None:
        with _HUB_LOCK:
            hub = getattr(client, "_map_cache_hub", None)
            if hub is None:
                hub = _MapCacheHub()
                client._map_cache_hub = hub
    return hub


class LocalCachedMap(Map):
    KIND = "map"  # shares the backing Map keyspace entry

    def __init__(self, name, client, *, cache_size: int = 4096,
                 cache_max_bytes: int = 64 << 20,
                 sync_strategy: str = INVALIDATE):
        import uuid

        super().__init__(name, client)
        if sync_strategy not in (INVALIDATE, UPDATE, NONE):
            raise ValueError(f"unknown sync strategy: {sync_strategy}")
        self._hub = _hub_for(client)
        if cache_size > 0:
            self._hub.ensure_budget(int(cache_max_bytes))
            # This map's slice of the shared store: its own byte quota
            # and entry bound (two enabled handles to one map share the
            # limits — last constructor wins, like two clients
            # configuring one cache).  A DISABLED handle (cache_size<=0)
            # must not touch them: passing its 0 through would erase an
            # enabled peer's entry bound (the store reads 0 as
            # UNBOUNDED).
            self._hub.store.set_tenant_limits(
                name, max_bytes=int(cache_max_bytes),
                max_entries=int(cache_size),
            )
        self._cache = self._hub.store
        self._cache_size = cache_size
        self._sync = sync_strategy
        self._bus = client._topic_bus
        self._channel = f"{name}:topic"
        # Invalidation messages carry the writer's cache id so the writer
        # skips its own (it already bumped the generation and maintained
        # the shared entry) — the reference's excludedId on
        # LocalCachedMapInvalidate.  OTHER handles still process it: the
        # redundant discard converges racing writers' installs onto the
        # backing map's order.
        self._cache_id = uuid.uuid4().hex
        self._listener_id = self._bus.subscribe(self._channel, self._on_sync)

    # -- near cache plumbing -----------------------------------------------

    def _on_sync(self, channel, message) -> None:
        origin, op, kb, vb = message
        if origin == self._cache_id:
            return
        # Any processed invalidation bumps the generation: a reader that
        # sampled the backing map BEFORE this message must not install
        # its (possibly stale) value afterwards.
        self._hub.bump(self._name)
        if kb is None:  # full clear
            self._cache.invalidate_tenant(self._name)
            return
        if op == UPDATE and vb is not None:
            self._cache_put(kb, self._dec(vb))
        else:
            self._cache.discard(self._name, kb)

    def _cache_put(self, kb: bytes, value: Any) -> None:
        # cache_size<=0 DISABLES the near cache: the store's own 0 means
        # "unbounded entry count", the inversion of what the caller
        # asked for.
        if self._cache_size <= 0:
            return
        self._cache.put(self._name, kb, value, _approx_nbytes(kb, value))

    def _publish(self, kb: Optional[bytes], vb: Optional[bytes]) -> None:
        if self._sync == NONE:
            return
        self._bus.publish(self._channel, (self._cache_id, self._sync, kb, vb))

    # -- overridden read/write paths ---------------------------------------

    def get(self, key: Any) -> Any:
        if self._cache_size <= 0:
            # This handle opted out of near-caching entirely: read
            # through — serving an enabled peer's shared entries would
            # un-opt it back in.
            return super().get(key)
        kb = self._enc_key(key)
        cached = self._cache.get(self._name, kb)
        if cached is not MISS:
            return cached
        gen = self._hub.gen(self._name)
        val = super().get(key)
        if val is not None:
            # Install only if no write/invalidation raced the backing
            # read — otherwise a stale value could be cached forever.
            self._hub.install_if(
                self._name, kb, val, _approx_nbytes(kb, val), gen
            )
        return val

    def put(self, key: Any, value: Any) -> Any:
        prev = super().put(key, value)
        kb = self._enc_key(key)
        self._hub.bump(self._name)  # retire in-flight read installs
        self._cache_put(kb, value)
        self._publish(kb, self._enc(value) if self._sync == UPDATE else None)
        return prev

    def fast_put(self, key: Any, value: Any) -> bool:
        created = super().fast_put(key, value)
        kb = self._enc_key(key)
        self._hub.bump(self._name)
        self._cache_put(kb, value)
        self._publish(kb, self._enc(value) if self._sync == UPDATE else None)
        return created

    def remove(self, key: Any, expected: Any = _MISSING) -> Any:
        # _MISSING sentinel, NOT None: remove(key, None) is a CONDITIONAL
        # remove expecting a stored None — collapsing it to unconditional
        # deleted data the caller meant to protect.
        if expected is _MISSING:
            prev = super().remove(key)
        else:
            prev = super().remove(key, expected)
        kb = self._enc_key(key)
        self._hub.bump(self._name)
        self._cache.discard(self._name, kb)
        self._publish(kb, None)
        return prev

    def replace(self, key: Any, value: Any, new_value: Any = _MISSING):
        out = super().replace(key, value, new_value)
        kb = self._enc_key(key)
        self._hub.bump(self._name)
        self._cache.discard(self._name, kb)
        self._publish(kb, None)
        return out

    def put_if_absent(self, key: Any, value: Any):
        out = super().put_if_absent(key, value)
        if out is None:  # stored: peers must drop any stale negative
            kb = self._enc_key(key)
            self._hub.bump(self._name)
            self._cache.discard(self._name, kb)
            self._publish(kb, None)
        return out

    def delete(self) -> bool:
        out = super().delete()
        self._hub.bump(self._name)
        self._cache.invalidate_tenant(self._name)
        # Whole-map invalidation: peers drop EVERYTHING (kb=None marker).
        self._publish(None, None)
        return out

    def fast_remove(self, *keys: Any) -> int:
        n = super().fast_remove(*keys)
        self._hub.bump(self._name)
        for k in keys:
            kb = self._enc_key(k)
            self._cache.discard(self._name, kb)
            self._publish(kb, None)
        return n

    def clear(self) -> bool:
        """→ RLocalCachedMap: clears backing map + every near cache."""
        existed = self.delete()
        self._cache.invalidate_tenant(self._name)
        if self._sync != NONE:
            self._bus.publish(
                self._channel, (self._cache_id, INVALIDATE, None, None)
            )
        return existed

    # -- cache introspection (→ RLocalCachedMap#cachedEntrySet etc.) -------

    def cached_size(self) -> int:
        return self._cache.tenant_entry_count(self._name)

    def cached_key_set(self) -> list:
        return [self._dec_key(kb) for kb in self._cache.tenant_keys(self._name)]

    def cache_stats(self) -> dict:
        """Near-cache occupancy/effectiveness (the shared LRU store's
        hit/miss/eviction/byte accounting).  Store-wide counters: with
        several maps on one client they aggregate — per-map bytes ride
        ``tenant_bytes``."""
        st = self._cache.stats()
        st["tenant_bytes"] = self._cache.tenant_bytes(self._name)
        st["max_entries"] = self._cache_size
        return st

    def clear_local_cache(self) -> None:
        """→ RLocalCachedMap#clearLocalCache.  The store is shared
        per-client now, so this drops the MAP's entries (every local
        handle's view of them — one store, one copy)."""
        self._hub.bump(self._name)
        self._cache.invalidate_tenant(self._name)

    def pre_load_cache(self) -> None:
        """→ RLocalCachedMap#preloadCache: warm the near cache with the
        whole backing map."""
        for k, v in self.read_all_map().items():
            self._cache_put(self._enc_key(k), v)

    def destroy(self) -> None:
        """Unsubscribe this handle's invalidation listener."""
        self._bus.unsubscribe(self._channel, self._listener_id)
        self._hub.bump(self._name)
        self._cache.invalidate_tenant(self._name)
