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
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

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
        self.capacity = factory.round_capacity(capacity, row_units=spec.row_units)
        self._dispatch_lock = dispatch_lock or threading.RLock()
        self.state = factory.make_pool_state(
            self.capacity, spec.row_units, spec.dtype
        )
        self._free: list[int] = list(range(self.capacity - 1, -1, -1))
        self.generation = 0  # bumped on every growth and snapshot restore

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

    def _grow(self) -> None:
        old_cap = self.capacity
        new_cap = old_cap * 2
        self.state = self._factory.grow_pool_state(
            self.state, old_cap, new_cap, self.spec.row_units
        )
        self.capacity = new_cap
        self.generation += 1
        self._free.extend(range(new_cap - 1, old_cap - 1, -1))


@dataclass
class TenantEntry:
    """One named sketch object's placement + parameters.  ``expire_at``:
    absolute wall-clock deadline (``time.time()``) after which the object
    no longer exists; None = no TTL.  ``replica_rows`` (read replicas on
    a mesh) is always None on one card and ``residency`` always
    "device"; both are kept so snapshots carry the JAX package's keys."""

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
        self._lock = threading.RLock()
        self._tenants: dict[str, TenantEntry] = {}
        self._pools: dict[tuple, SizeClassPool] = {}

    def lookup(self, name: str) -> Optional[TenantEntry]:
        with self._lock:
            return self._tenants.get(name)

    def detach(self, name: str) -> Optional[TenantEntry]:
        """Unregister ``name`` WITHOUT freeing its row: the caller zeroes
        the row and then frees it, so only one concurrent deleter wins the
        pop and the row is never reallocated while still dirty."""
        with self._lock:
            return self._tenants.pop(name, None)

    def detach_if(self, name: str, entry: TenantEntry) -> Optional[TenantEntry]:
        """detach() guarded on entry identity: a no-op if ``name`` was
        deleted and re-created since the caller captured ``entry`` (an
        expiry reaper never removes a fresh successor)."""
        with self._lock:
            if self._tenants.get(name) is not entry:
                return None
            return self._tenants.pop(name)

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
            entry = TenantEntry(name, kind, pool, pool.alloc_row(), dict(params))
            self._tenants[name] = entry
            return entry, True

