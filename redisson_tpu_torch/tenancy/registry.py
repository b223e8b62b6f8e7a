"""Tenant registry and size-class pools.

Counterpart of ``redisson_tpu/tenancy/registry.py`` with the same size
classes and row geometry, so a pool here and in the JAX package hold the
same bytes: a bloom filter or bitset of m bits lands in the pool whose
row is the next power of two >= ceil(m/32) uint32 words (minimum 128); a
HyperLogLog row is 16384 uint8 registers; a count-min sketch row is d*w
uint32 counters padded to a multiple of 128.  All tenants of a class
share one flat ``[capacity*row_units + 1]`` tensor (trailing scratch
element).  Pools grow by doubling row capacity.

Thread-safety: registry mutations happen under one lock; pool growth
takes the executor's dispatch lock, so it never races a launch.  Lock
order, as in the JAX package: the registry lock before the dispatch lock
(``try_create`` -> ``alloc_row`` -> ``_grow``; snapshot capture and
restore take them in the same order).

``TenantGovernor`` is the per-tenant admission side of the overload
control plane: a token bucket and an in-flight quota per tenant, checked
at the engine's submit boundary.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch.executor.failures import TenantThrottledError
from redisson_tpu_torch.ops.golden import HLL_M


class PoolKind:
    BLOOM = "bloom"
    BITSET = "bitset"
    HLL = "hll"
    CMS = "cms"


def _pow2ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def class_words_for_bits(m: int) -> int:
    """Size class for an m-bit bitmap: pow2 words >= ceil(m/32), min 128."""
    return max(128, _pow2ceil(-(-m // 32)))


@dataclass
class PoolSpec:
    kind: str
    class_key: tuple  # (words,) for bloom/bitset, () for hll, (d, w) for cms
    row_units: int  # elements per tenant row
    dtype: Any  # element type: np.uint32 words, or np.uint8 HLL registers

    @property
    def key(self) -> tuple:
        return (self.kind, *self.class_key)


def spec_for(kind: str, class_key: tuple) -> PoolSpec:
    if kind in (PoolKind.BLOOM, PoolKind.BITSET):
        (words,) = class_key
        return PoolSpec(kind, class_key, words, np.uint32)
    if kind == PoolKind.HLL:
        return PoolSpec(kind, (), HLL_M, np.uint8)
    if kind == PoolKind.CMS:
        d, w = class_key
        return PoolSpec(kind, class_key, -(-d * w // 128) * 128, np.uint32)
    raise ValueError(f"unknown pool kind: {kind}")


class SizeClassPool:
    """One stacked device tensor holding all tenants of a size class."""

    def __init__(self, spec: PoolSpec, capacity: int, factory, dispatch_lock=None):
        self.spec = spec
        # The factory (the executor) owns the state layout; this layer only
        # hands out row numbers.
        self._factory = factory
        self.capacity = factory.round_capacity(
            capacity, row_units=spec.row_units, kind=spec.kind
        )
        self._dispatch_lock = dispatch_lock or threading.RLock()
        self.state = factory.make_pool_state(
            self.capacity, spec.row_units, spec.dtype, kind=spec.kind
        )
        self._free: list[int] = list(range(self.capacity - 1, -1, -1))
        self.generation = 0  # bumped on every growth and snapshot restore
        # Optional growth callback (set by the engine's BucketPrewarmer):
        # growth changes the pool's launch signature, so the warm ladder
        # re-runs against the new layout.
        self.on_grow = None
        # Bumped (under the dispatch lock) by a live change_topology,
        # which rebuilds the free list wholesale: a reap that detached an
        # entry BEFORE the swap must not zero and free its rows again
        # afterwards (durability._reap_rows checks this epoch).
        self.topology_epoch = 0

    @property
    def row_units(self) -> int:
        return self.spec.row_units

    def alloc_row(self) -> int:
        with self._dispatch_lock:
            if not self._free:
                self._grow()
            return self._free.pop()

    def free_row(self, row: int) -> None:
        # The caller zeroes the row on the device before recycling it.
        self._free.append(row)

    def alloc_row_with_residue(self, residue: int, S: int) -> int:
        """Allocate a row with ``row % S == residue``: read replication
        needs one copy on each shard."""
        with self._dispatch_lock:
            while True:
                for i in range(len(self._free) - 1, -1, -1):
                    if self._free[i] % S == residue:
                        return self._free.pop(i)
                self._grow()

    def _grow(self) -> None:
        old_cap = self.capacity
        new_cap = old_cap * 2
        self.state = self._factory.grow_pool_state(
            self.state, old_cap, new_cap, self.spec.row_units,
            self.spec.dtype, kind=self.spec.kind,
        )
        self.capacity = new_cap
        self.generation += 1
        self._free.extend(range(new_cap - 1, old_cap - 1, -1))
        cb = self.on_grow
        if cb is not None:
            cb(self)

    def used_rows(self) -> int:
        return self.capacity - len(self._free)


class _TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill up to ``burst``;
    ``take(n)`` consumes or refuses atomically (caller holds the
    governor lock)."""

    __slots__ = ("tokens", "stamp")

    def __init__(self, burst: float, now: float):
        self.tokens = burst  # start full: a fresh tenant gets its burst
        self.stamp = now

    def take(self, n: int, rate: float, burst: float, now: float) -> bool:
        self.tokens = min(burst, self.tokens + (now - self.stamp) * rate)
        self.stamp = now
        # A FULL bucket admits even an oversize n (tokens go negative:
        # debt repaid by refill) — otherwise a single bulk submit larger
        # than the burst could never pass at any rate.
        if self.tokens >= n or self.tokens >= burst:
            self.tokens -= n
            return True
        return False


class TenantGovernor:
    """Per-tenant fair-load-shedding quotas (counterpart of the JAX
    package's ``TenantGovernor``): a token-bucket RATE limit plus a
    queued+in-flight op quota, enforced at the engine's submit boundary — an over-quota
    tenant is shed there (TenantThrottledError, strictly pre-dispatch)
    BEFORE its ops can build the queue wait every other tenant would
    share.  Within-quota tenants never trip this layer, which is the
    fairness guarantee: during one tenant's burst, the burst is what
    gets shed.

    Limits are live-settable (``set_limits``); a rate or quota of 0
    disables that check.  All
    state is host-side and O(active tenants)."""

    def __init__(self, *, rate_limit: float = 0.0, burst: float = 0.0,
                 max_inflight: int = 0, obs=None,
                 clock=time.monotonic):
        self._lock = _witness.named(threading.Lock(), "tenancy.governor")
        self._clock = clock
        self._buckets: dict[str, _TokenBucket] = {}
        self._inflight: dict[str, int] = {}
        self.obs = obs
        self.throttled_ops = 0  # lifetime shed ops (stats)
        self.set_limits(rate_limit=rate_limit, burst=burst,
                        max_inflight=max_inflight)

    @property
    def active(self) -> bool:
        return self.rate_limit > 0 or self.max_inflight > 0

    def set_limits(self, rate_limit: Optional[float] = None,
                   burst: Optional[float] = None,
                   max_inflight: Optional[int] = None) -> None:
        """Apply new limits; buckets AND in-flight charges reset so a
        limit change takes effect immediately (a tenant throttled under
        the old limits starts the new ones clean — generous, never
        unfair).  The in-flight reset matters for a disable/re-enable
        cycle: release() is skipped while max_inflight is 0, so charges
        left from before the disable would otherwise throttle the
        tenant forever once re-enabled (stale releases after the reset
        are harmless — release() clamps at zero)."""
        with self._lock:
            if rate_limit is not None:
                self.rate_limit = max(0.0, float(rate_limit))
            if burst is not None:
                self._burst_cfg = max(0.0, float(burst))
            if max_inflight is not None:
                self.max_inflight = max(0, int(max_inflight))
            self.burst = (
                self._burst_cfg if self._burst_cfg > 0
                else 2.0 * self.rate_limit
            )
            self._buckets.clear()
            self._inflight.clear()

    def admit(self, tenant: str, n: int) -> None:
        """Charge ``n`` ops to ``tenant``; raises TenantThrottledError
        when a quota refuses.  On success the tenant's in-flight count
        is raised — pair with release() when the ops resolve."""
        with self._lock:
            if self.max_inflight > 0:
                cur = self._inflight.get(tenant, 0)
                # An oversize single submit is admitted when the tenant
                # has NOTHING in flight (the same carve-out the token
                # bucket and the coalescer queue bound make) — without
                # it a bulk op larger than the quota could never
                # succeed at any retry rate.
                if cur > 0 and cur + n > self.max_inflight:
                    self._note_shed(tenant, n)
                    raise TenantThrottledError(
                        tenant, "inflight",
                        f"{cur} queued+in-flight + {n} > quota "
                        f"{self.max_inflight}",
                    )
            if self.rate_limit > 0:
                now = self._clock()
                b = self._buckets.get(tenant)
                if b is None:
                    b = self._buckets[tenant] = _TokenBucket(
                        self.burst, now
                    )
                if not b.take(n, self.rate_limit, self.burst, now):
                    self._note_shed(tenant, n)
                    raise TenantThrottledError(
                        tenant, "rate",
                        f"{n} ops over the {self.rate_limit:g} ops/s "
                        f"bucket (burst {self.burst:g})",
                    )
            if self.max_inflight > 0:
                self._inflight[tenant] = self._inflight.get(tenant, 0) + n

    def peek_over_quota(self, tenant: str) -> bool:
        """Non-consuming quota probe: True when ``tenant`` would be
        refused right now — its token bucket is empty after refill, or its
        in-flight quota is full.  Reads only; no tokens are taken and no
        shed is counted, so a peek never penalizes a tenant that then
        does not submit."""
        if not self.active:
            return False
        with self._lock:
            if self.max_inflight > 0:
                if self._inflight.get(tenant, 0) >= self.max_inflight:
                    return True
            if self.rate_limit > 0:
                b = self._buckets.get(tenant)
                if b is None:  # fresh tenant: full burst available
                    return False
                now = self._clock()
                tokens = min(
                    self.burst,
                    b.tokens + (now - b.stamp) * self.rate_limit,
                )
                # Mirrors take(): a FULL bucket admits anything; below
                # full, at least one token must be available.
                return tokens < 1.0 and tokens < self.burst
        return False

    def release(self, tenant: str, n: int) -> None:
        """Return ``n`` in-flight ops (the submit's futures resolved —
        success or failure, both free the quota)."""
        if self.max_inflight <= 0:
            return
        with self._lock:
            cur = self._inflight.get(tenant, 0) - n
            if cur > 0:
                self._inflight[tenant] = cur
            else:
                self._inflight.pop(tenant, None)

    def _note_shed(self, tenant: str, n: int) -> None:
        self.throttled_ops += n
        if self.obs is not None:
            self.obs.tenant_throttled.inc((tenant,), n)
            self.obs.shed_ops.inc(("tenant",), n)

    def stats(self) -> dict:
        with self._lock:
            return {
                "rate_limit": self.rate_limit,
                "burst": self.burst,
                "max_inflight": self.max_inflight,
                "throttled_ops": self.throttled_ops,
                "tenants_tracked": max(
                    len(self._buckets), len(self._inflight)
                ),
            }


@dataclass
class TenantEntry:
    """One named sketch object's placement + parameters.  ``expire_at``:
    absolute wall-clock deadline (``time.time()``) after which the object
    no longer exists; None = no TTL.  ``replica_rows``: the rows of a
    read-replicated Bloom filter, one per shard (None unless
    ``bloom_replicate`` ran on a sharded engine).  ``residency`` (storage/residency.py):
    "device" — ``row`` is live; "host" — row is ROW_NONE (-1) and the
    truth is a golden mirror; "disk" — row is ROW_NONE and the truth is
    a blob."""

    name: str
    kind: str
    pool: SizeClassPool
    row: int
    params: dict = field(default_factory=dict)
    expire_at: Optional[float] = None
    replica_rows: Optional[list] = None
    residency: str = "device"


class TenantRegistry:
    def __init__(self, factory, initial_capacity: int = 8, dispatch_lock=None):
        self._factory = factory
        self._initial_capacity = initial_capacity
        self._dispatch_lock = dispatch_lock
        self._lock = _witness.named(threading.RLock(), "tenancy.registry")
        self._tenants: dict[str, TenantEntry] = {}
        self._pools: dict[tuple, SizeClassPool] = {}
        # Residency alloc gate: when set and True at create time,
        # try_create births the tenant HOST-resident (row -1, a
        # zero-seeded mirror installs on first touch) instead of growing
        # a pool past the device-rows budget — the card holds the
        # working set, not the keyspace.
        self.alloc_gate = None
        # Load attribution: wired by the serve layer to the loadmap's
        # exact per-slot key counters.  Called as ``on_keyspace(name,
        # +1/-1)`` wherever the set of live tenant names changes, UNDER
        # ``self._lock`` — must be leaf-safe.
        self.on_keyspace = None

    def _note_keyspace(self, name: str, delta: int) -> None:
        hook = self.on_keyspace
        if hook is not None:
            hook(name, delta)

    def lookup(self, name: str) -> Optional[TenantEntry]:
        with self._lock:
            return self._tenants.get(name)

    def detach(self, name: str) -> Optional[TenantEntry]:
        """Unregister ``name`` WITHOUT freeing its row: the caller zeroes
        the row and then frees it, so only one concurrent deleter wins the
        pop and the row is never reallocated while still dirty."""
        with self._lock:
            entry = self._tenants.pop(name, None)
            if entry is not None:
                self._note_keyspace(name, -1)
            return entry

    def detach_if(self, name: str, entry: TenantEntry) -> Optional[TenantEntry]:
        """detach() guarded on entry identity: a no-op if ``name`` was
        deleted and re-created since the caller captured ``entry`` (an
        expiry reaper never removes a fresh successor)."""
        with self._lock:
            if self._tenants.get(name) is not entry:
                return None
            popped = self._tenants.pop(name)
            self._note_keyspace(name, -1)
            return popped

    def rename_detach_dest(self, old: str, new: str):
        """Atomic rename -> (renamed, displaced destination or None).  The
        displaced entry's row is NOT freed (the caller zeroes it first).
        A missing ``old`` leaves the destination untouched."""
        with self._lock:
            entry = self._tenants.pop(old, None)
            if entry is None:
                return False, None
            dest = self._tenants.pop(new, None)
            entry.name = new
            self._tenants[new] = entry
            self._note_keyspace(old, -1)
            if dest is None:  # an overwrite transfers the displaced +1
                self._note_keyspace(new, +1)
            return True, dest

    def names(self, kind: Optional[str] = None) -> list[str]:
        with self._lock:
            return [n for n, e in self._tenants.items() if kind is None or e.kind == kind]

    def pools(self) -> list[SizeClassPool]:
        with self._lock:
            return list(self._pools.values())

    def entries(self) -> list[TenantEntry]:
        with self._lock:
            return list(self._tenants.values())

    def stats(self) -> dict:
        """Occupancy snapshot for the observability gauges: tenant counts
        by kind and per-pool row capacity/usage.  One lock hold, no
        device access — safe to call from a scrape handler."""
        with self._lock:
            tenants: dict[str, int] = {}
            for e in self._tenants.values():
                tenants[e.kind] = tenants.get(e.kind, 0) + 1
            pools = {
                key: {"capacity": p.capacity, "used_rows": p.used_rows()}
                for key, p in self._pools.items()
            }
        return {"tenants_by_kind": tenants, "pools": pools}

    def pool_for(self, kind: str, class_key: tuple) -> SizeClassPool:
        with self._lock:
            spec = spec_for(kind, class_key)
            pool = self._pools.get(spec.key)
            if pool is None:
                pool = SizeClassPool(
                    spec, self._initial_capacity, self._factory,
                    dispatch_lock=self._dispatch_lock,
                )
                self._pools[spec.key] = pool
            return pool

    def try_create(self, name: str, kind: str, class_key: tuple, params: dict):
        """tryInit semantics: create if absent -> (entry, True); if present
        -> (existing, False) whatever the params."""
        with self._lock:
            entry = self._tenants.get(name)
            if entry is not None:
                if entry.kind != kind:
                    raise TypeError(
                        f"object {name!r} holds a {entry.kind}, not a {kind}"
                    )
                return entry, False
            pool = self.pool_for(kind, class_key)
            gate = self.alloc_gate
            if gate is not None and gate():
                # Born cold: device budget full — no row; the engine's
                # first-touch load installs a zero-seeded host mirror.
                entry = TenantEntry(name, kind, pool, -1, dict(params),
                                    residency="host")
            else:
                entry = TenantEntry(name, kind, pool, pool.alloc_row(), dict(params))
            self._tenants[name] = entry
            self._note_keyspace(name, +1)
            return entry, True

