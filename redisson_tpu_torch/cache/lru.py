"""Shared sharded-LRU store — the eviction implementation behind the
port's host-side near cache (→ org/redisson/cache/: LRUCacheMap +
LocalCacheView sizing policy).  A copy of ``redisson_tpu/cache/lru.py``
with plain ``threading`` locks where the JAX package names its locks for
its runtime lock-order checker.

Design constraints, in order:

- **Bounded**: a global byte budget caps total host memory; entries carry
  caller-estimated sizes and the store evicts LRU-first when over budget.
- **Multi-tenant fair**: every entry belongs to a tenant (a sketch name, a
  map handle); per-tenant byte/entry quotas mean one hot tenant fills its
  OWN quota and then recycles its OWN tail — it can never flush everyone
  else's working set out of the shared budget.
- **Sharded**: the serving path hits this on every cached read, from many
  producer threads at once — N independent locks, key-hash sharded, keep
  the fast path a dict probe under an uncontended lock.  Each shard also
  keeps a per-tenant recency index, so tenant-quota eviction is O(1)
  (popping the tenant's LRU key), never a scan of the shard.

Tenant accounting is DELTA-based under its own small lock: every insert
contributes +nbytes/+1 exactly once and every removal -nbytes/-1 exactly
once, so any interleaving of a put with a concurrent invalidate/evict
nets to zero — no permanent drift (transient negatives are possible
mid-flight and resolve when the matching delta lands; the key is pruned
only at an exact zero balance, which later deltas recreate correctly via
``.get(tenant, 0)``).

Eviction order within a tenant is LRU-of-LRUs: every entry carries a
store-wide recency stamp, and each eviction takes the globally
least-recent among the shards' per-shard LRU heads (an O(nshards) peek
per eviction, no shared lock on the hit path).  The entry a put() just
installed is never evicted to make room for itself.
"""

from __future__ import annotations

import itertools
import threading
from collections import OrderedDict

from redisson_tpu_torch.analysis import witness as _witness


MISS = object()  # sentinel: ``None`` is a legal cached value


class _Shard:
    __slots__ = ("lock", "entries", "tenants", "bytes")

    def __init__(self):
        self.lock = _witness.named(threading.Lock(), "nearcache.lru.shard")
        # (tenant, key) -> (value, nbytes, stamp); OrderedDict insertion
        # order IS the recency order (move_to_end on hit); ``stamp`` is
        # the store-wide recency clock value of the entry's last touch —
        # the cross-shard comparison key for LRU-of-LRUs eviction.
        self.entries: OrderedDict = OrderedDict()
        # tenant -> OrderedDict(key -> nbytes), same recency order — the
        # O(1) source of "this tenant's LRU entry in this shard".
        self.tenants: dict = {}
        self.bytes = 0


class ShardedLRUStore:
    def __init__(self, max_bytes: int = 64 << 20, nshards: int = 8,
                 tenant_quota_bytes: int = 0, on_evict=None):
        nshards = max(1, int(nshards))
        self._shards = [_Shard() for _ in range(nshards)]
        self._nshards = nshards
        self.max_bytes = int(max_bytes)
        # 0 → an equal share of the budget for up to 8 concurrent hot
        # tenants; an explicit quota overrides.  Whether the quota was
        # defaulted is remembered so a live max_bytes resize re-derives
        # it (a budget retune must not silently pin every tenant to the
        # OLD budget's share).
        self._quota_explicit = bool(tenant_quota_bytes)
        self.tenant_quota_bytes = (
            int(tenant_quota_bytes) if tenant_quota_bytes
            else max(1, self.max_bytes // 8)
        )
        # Tenant accounting + optional per-tenant overrides, under one
        # small lock (touched once per put/evict, not per get).
        self._tlock = _witness.named(threading.Lock(), "nearcache.lru.tenants")
        self._tenant_bytes: dict = {}
        self._tenant_entries: dict = {}
        self._tenant_limits: dict = {}  # tenant -> (max_bytes, max_entries)
        self._on_evict = on_evict
        # Store-wide recency clock for cross-shard victim selection
        # (LRU-of-LRUs, see _victim_shard): every insert and every hit
        # promotion stamps the entry from this counter, so "least recent
        # among the shards' LRU heads" is a global-LRU approximation
        # instead of a per-shard guess.  The earlier rotation cursor
        # spread pressure but was recency-BLIND across shards: a
        # globally-recent key sitting alone in its shard was that
        # shard's LRU and died whenever the cursor landed there
        # (hash-seed-dependent eviction of hot keys).  itertools.count
        # is effectively atomic under the GIL; a torn interleaving only
        # perturbs tie-breaks.
        self._stamp = itertools.count()
        # Monotonic stats (read without locks: torn reads of ints are
        # fine for monitoring).
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- configuration -----------------------------------------------------

    def set_tenant_limits(self, tenant, max_bytes=None, max_entries=None):
        """Per-tenant overrides (a map handle's entry-count bound, a VIP
        tenant's larger byte quota).  ``None`` keeps the store default."""
        with self._tlock:
            self._tenant_limits[tenant] = (max_bytes, max_entries)

    def resize(self, max_bytes=None, tenant_quota_bytes=None) -> None:
        """Live-retune the budgets (CONFIG SET path); an over-budget store
        trims back lazily on the next puts.  A defaulted tenant quota
        (0 at construction or here) tracks max_bytes/8 across budget
        retunes; an explicit quota sticks until reset with 0."""
        if max_bytes is not None:
            self.max_bytes = int(max_bytes)
        if tenant_quota_bytes is not None:
            self._quota_explicit = bool(tenant_quota_bytes)
            if tenant_quota_bytes:
                self.tenant_quota_bytes = int(tenant_quota_bytes)
        if not self._quota_explicit:
            self.tenant_quota_bytes = max(1, self.max_bytes // 8)

    # -- core --------------------------------------------------------------

    def _shard_for(self, tenant, key) -> _Shard:
        return self._shards[hash((tenant, key)) % self._nshards]

    def _limits(self, tenant):
        lim = self._tenant_limits.get(tenant)
        max_b = self.tenant_quota_bytes
        max_e = 0  # 0 → unbounded entry count (bytes still bound)
        if lim is not None:
            if lim[0] is not None:
                max_b = lim[0]
            if lim[1] is not None:
                max_e = lim[1]
        return max_b, max_e

    def _acct(self, tenant, dbytes: int, dentries: int) -> None:
        """Apply a tenant accounting DELTA.  Deltas from any interleaving
        of inserts and removals net to zero per entry lifecycle; the key
        is pruned only at an exact zero balance (later deltas recreate it
        via the .get default, so pruning is always identity-safe)."""
        with self._tlock:
            nb = self._tenant_bytes.get(tenant, 0) + dbytes
            ne = self._tenant_entries.get(tenant, 0) + dentries
            if nb == 0 and ne == 0:
                self._tenant_bytes.pop(tenant, None)
                self._tenant_entries.pop(tenant, None)
            else:
                self._tenant_bytes[tenant] = nb
                self._tenant_entries[tenant] = ne

    def get(self, tenant, key):
        """Cached value or the MISS sentinel; a hit is promoted to MRU."""
        s = self._shard_for(tenant, key)
        k = (tenant, key)
        with s.lock:
            ent = s.entries.get(k)
            if ent is None:
                self.misses += 1
                return MISS
            s.entries.move_to_end(k)
            s.tenants[tenant].move_to_end(key)
            s.entries[k] = (ent[0], ent[1], next(self._stamp))
            self.hits += 1
            return ent[0]

    def put(self, tenant, key, value, nbytes: int) -> bool:
        """Insert/replace; False when the entry alone exceeds its quota
        (too big to ever cache — callers just skip).  A refused REPLACE
        still discards any existing entry under the key: the caller is
        installing a new value, so the old cached one is stale now."""
        nbytes = int(nbytes)
        max_b, max_e = self._limits(tenant)
        if nbytes > max_b or nbytes > self.max_bytes:
            self.discard(tenant, key)
            return False
        s = self._shard_for(tenant, key)
        k = (tenant, key)
        with s.lock:
            old = s.entries.pop(k, None)
            s.entries[k] = (value, nbytes, next(self._stamp))
            t = s.tenants.get(tenant)
            if t is None:
                t = s.tenants[tenant] = OrderedDict()
            t.pop(key, None)
            t[key] = nbytes
            s.bytes += nbytes - (old[1] if old else 0)
        self._acct(
            tenant, nbytes - (old[1] if old else 0), 0 if old else 1
        )
        self._enforce(tenant, max_b, max_e, protect=k)
        return True

    def _evict_one(self, shard: _Shard, tenant=None, protect=None) -> bool:
        """Drop the LRU entry of ``shard`` (of ``tenant`` only, when
        given — O(1) via the per-tenant recency index).  Returns True if
        something was evicted.

        ``protect``: the (tenant, key) a put() just installed — never
        evict it to make room for itself.  The protected entry sits at
        the MRU end, so it can be the LRU head only as the shard's sole
        eligible entry; the next-LRU (if any) is taken instead, still
        O(1).  Without this, an eviction landing on the new entry's
        shard could evict it on the spot: put() returned True, the
        entry was gone, and a just-written key missed its first read
        (surfaced as hash-seed-dependent flakes in the quota tests)."""
        with shard.lock:
            if tenant is None:
                it = iter(shard.entries)
                victim = next(it, None)
                if victim == protect:
                    victim = next(it, None)  # head is the new entry
                if victim is None:
                    return False
                ent = shard.entries.pop(victim)
                t = shard.tenants.get(victim[0])
                if t is not None:
                    t.pop(victim[1], None)
                    if not t:
                        del shard.tenants[victim[0]]
            else:
                t = shard.tenants.get(tenant)
                if not t:
                    return False
                it = iter(t)
                key = next(it, None)
                if protect is not None and protect == (tenant, key):
                    key = next(it, None)
                if key is None:
                    return False
                t.pop(key)
                if not t:
                    del shard.tenants[tenant]
                victim = (tenant, key)
                ent = shard.entries.pop(victim)
            shard.bytes -= ent[1]
        self._acct(victim[0], -ent[1], -1)
        self.evictions += 1
        if self._on_evict is not None:
            self._on_evict(victim[0], ent[1])
        return True

    def _victim_shard(self, tenant=None, protect=None) -> int:
        """LRU-of-LRUs victim selection: the shard whose eligible LRU
        head (of ``tenant`` when given, skipping ``protect``) carries
        the globally smallest recency stamp — so cross-shard eviction
        order tracks GLOBAL recency, not the accident of which shard a
        key hashed to.  Racy by design (stamps are re-read unlocked by
        _evict_one's pop): a concurrent touch only upgrades a victim to
        survivor, never the reverse.  Returns -1 when nothing is
        evictable."""
        best, best_stamp = -1, None
        for idx, shard in enumerate(self._shards):
            with shard.lock:
                if tenant is None:
                    it = iter(shard.entries)
                    k = next(it, None)
                    if k == protect:
                        k = next(it, None)
                    if k is None:
                        continue
                    st = shard.entries[k][2]
                else:
                    t = shard.tenants.get(tenant)
                    if not t:
                        continue
                    it = iter(t)
                    key = next(it, None)
                    if protect is not None and protect == (tenant, key):
                        key = next(it, None)
                    if key is None:
                        continue
                    st = shard.entries[(tenant, key)][2]
            if best_stamp is None or st < best_stamp:
                best, best_stamp = idx, st
        return best

    def _enforce(self, tenant, max_b: int, max_e: int,
                 protect=None) -> None:
        # Tenant quota first (fairness: the hot tenant recycles itself),
        # then the global budget.  Victims come from _victim_shard
        # (LRU-of-LRUs), so pressure lands on the least-recent entry
        # store-wide; each pass bounded to stay O(evictions).
        for _ in range(1 << 16):  # backstop, never hit in practice
            over_b = self._tenant_bytes.get(tenant, 0) > max_b
            over_e = max_e and self._tenant_entries.get(tenant, 0) > max_e
            if not (over_b or over_e):
                break
            idx = self._victim_shard(tenant, protect)
            if idx < 0 or not self._evict_one(
                self._shards[idx], tenant, protect=protect
            ):
                break  # accounting drift guard: nothing left to evict
        for _ in range(1 << 16):
            if self.bytes() <= self.max_bytes:
                break
            idx = self._victim_shard(None, protect)
            if idx < 0 or not self._evict_one(
                self._shards[idx], protect=protect
            ):
                break

    def discard(self, tenant, key) -> None:
        s = self._shard_for(tenant, key)
        k = (tenant, key)
        with s.lock:
            ent = s.entries.pop(k, None)
            if ent is None:
                return
            t = s.tenants.get(tenant)
            if t is not None:
                t.pop(key, None)
                if not t:
                    del s.tenants[tenant]
            s.bytes -= ent[1]
        self._acct(tenant, -ent[1], -1)

    def invalidate_tenant(self, tenant) -> int:
        """Drop every entry of one tenant (delete/clear paths).  The
        accounting decrements by exactly what was removed, so a put
        racing this call nets to zero instead of leaving phantom
        bytes/entries behind."""
        dropped = 0
        freed = 0
        for s in self._shards:
            with s.lock:
                t = s.tenants.pop(tenant, None)
                if not t:
                    continue
                for key, nb in t.items():
                    s.entries.pop((tenant, key), None)
                    s.bytes -= nb
                    freed += nb
                    dropped += 1
        if dropped:
            self._acct(tenant, -freed, -dropped)
        return dropped

    def clear(self) -> None:
        # Deltas aggregate PER TENANT per shard (like invalidate_tenant):
        # one _tlock round trip per tenant, not per entry — a full 300k-
        # entry sweep must not stall concurrent puts on the shared lock.
        for s in self._shards:
            freed: dict = {}
            counts: dict = {}
            with s.lock:
                for (t, _k), (_v, nb, _st) in s.entries.items():
                    freed[t] = freed.get(t, 0) + nb
                    counts[t] = counts.get(t, 0) + 1
                s.entries.clear()
                s.tenants.clear()
                s.bytes = 0
            for t in freed:
                self._acct(t, -freed[t], -counts[t])

    # -- introspection -----------------------------------------------------

    def bytes(self) -> int:
        return sum(s.bytes for s in self._shards)

    def entries(self) -> int:
        return sum(len(s.entries) for s in self._shards)

    def tenant_bytes(self, tenant) -> int:
        return self._tenant_bytes.get(tenant, 0)

    def tenant_entry_count(self, tenant) -> int:
        return self._tenant_entries.get(tenant, 0)

    def tenant_keys(self, tenant) -> list:
        out = []
        for s in self._shards:
            with s.lock:
                out.extend(s.tenants.get(tenant, ()))
        return out

    def stats(self) -> dict:
        hits, misses = self.hits, self.misses
        return {
            "hits": hits,
            "misses": misses,
            "hit_rate": round(hits / (hits + misses), 4)
            if hits + misses else 0.0,
            "evictions": self.evictions,
            "bytes": self.bytes(),
            "entries": self.entries(),
            "max_bytes": self.max_bytes,
            "tenant_quota_bytes": self.tenant_quota_bytes,
            "tenants": len(self._tenant_entries),
        }
