"""Multimaps — → org/redisson/RedissonListMultimap.java,
RedissonSetMultimap.java (+ the *Cache variants with per-KEY TTL,
→ RedissonListMultimapCache.java / RedissonSetMultimapCache.java).

Reference layout: one Redis hash mapping key→bucket-id plus one
list/set per bucket; here one entry holds key-bytes → container of value
bytes.  Cache variants carry a per-key expiry (RMultimapCache#expireKey),
pruned lazily and by the grid sweeper.

The port's copy of ``redisson_tpu/grid/multimaps.py``.
"""

from __future__ import annotations

import time
from typing import Any, Iterable, Optional

from redisson_tpu_torch.grid.base import GridObject


class _MultimapValue:
    """key bytes -> {"vals": list[bytes] | list-as-set, "expire_at": float|None}."""

    __slots__ = ("data",)

    def __init__(self):
        self.data: dict[bytes, dict] = {}

    def live(self, kb: bytes, now: Optional[float] = None):
        slot = self.data.get(kb)
        if slot is None:
            return None
        if slot["expire_at"] is not None and (now or time.time()) >= slot["expire_at"]:
            del self.data[kb]
            return None
        return slot

    def prune_expired(self, now: float) -> None:
        for kb in list(self.data.keys()):
            self.live(kb, now)


class _BaseMultimap(GridObject):
    SET_SEMANTICS = False

    @staticmethod
    def _new_value():
        return _MultimapValue()

    def _slot(self, kb: bytes, create: bool):
        e = self._entry(create=create)
        if e is None:
            return None
        slot = e.value.live(kb)
        if slot is None and create:
            # Set semantics: value-bytes -> count-of-1 dict (insertion-
            # ordered, O(1) membership).  List semantics: plain list with
            # duplicates.
            slot = {
                "vals": {} if self.SET_SEMANTICS else [],
                "expire_at": None,
            }
            e.value.data[kb] = slot
        return slot

    # -- core --------------------------------------------------------------

    def _add_locked(self, slot, vb: bytes) -> bool:
        vals = slot["vals"]
        if self.SET_SEMANTICS:
            if vb in vals:
                return False
            vals[vb] = None
            return True
        vals.append(vb)
        return True

    def put(self, key: Any, value: Any) -> bool:
        """→ RMultimap#put: True if the multimap changed."""
        with self._store.lock:
            slot = self._slot(self._enc_key(key), create=True)
            return self._add_locked(slot, self._enc(value))

    def put_all(self, key: Any, values: Iterable[Any]) -> bool:
        with self._store.lock:
            slot = self._slot(self._enc_key(key), create=True)
            changed = False
            for v in values:
                changed |= self._add_locked(slot, self._enc(v))
            return changed

    def get_all(self, key: Any) -> list:
        """→ RMultimap#getAll (a snapshot copy, like the reference's
        readAll on the bucket)."""
        with self._store.lock:
            slot = self._slot(self._enc_key(key), create=False)
            return [] if slot is None else [self._dec(v) for v in slot["vals"]]

    get = get_all  # reference's live-view get(); snapshot here

    def remove(self, key: Any, value: Any) -> bool:
        """→ RMultimap#remove: removes ONE occurrence."""
        with self._store.lock:
            slot = self._slot(self._enc_key(key), create=False)
            if slot is None:
                return False
            vb = self._enc(value)
            if self.SET_SEMANTICS:
                if vb not in slot["vals"]:
                    return False
                del slot["vals"][vb]
            else:
                try:
                    slot["vals"].remove(vb)
                except ValueError:
                    return False
            if not slot["vals"]:
                self._drop_key(self._enc_key(key))
            return True

    def remove_all(self, key: Any) -> list:
        """→ RMultimap#removeAll: drops the key, returns its old values."""
        with self._store.lock:
            kb = self._enc_key(key)
            slot = self._slot(kb, create=False)
            if slot is None:
                return []
            vals = [self._dec(v) for v in slot["vals"]]
            self._drop_key(kb)
            return vals

    def _drop_key(self, kb: bytes) -> None:
        e = self._entry(create=False)
        if e is not None:
            e.value.data.pop(kb, None)

    def contains_key(self, key: Any) -> bool:
        with self._store.lock:
            return self._slot(self._enc_key(key), create=False) is not None

    def contains_value(self, value: Any) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return False
            vb = self._enc(value)
            now = time.time()
            return any(
                vb in slot["vals"]
                for kb, slot in list(e.value.data.items())
                if e.value.live(kb, now) is not None
            )

    def contains_entry(self, key: Any, value: Any) -> bool:
        with self._store.lock:
            slot = self._slot(self._enc_key(key), create=False)
            return slot is not None and self._enc(value) in slot["vals"]

    def key_set(self) -> list:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return []
            now = time.time()
            return [
                self._dec_key(kb)
                for kb in list(e.value.data.keys())
                if e.value.live(kb, now) is not None
            ]

    def key_size(self) -> int:
        # Count live keys WITHOUT decoding them (a decode per key just to
        # take a len() pays full codec cost under the store lock).
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return 0
            now = time.time()
            return sum(
                1
                for kb in list(e.value.data.keys())
                if e.value.live(kb, now) is not None
            )

    def values(self) -> list:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return []
            now = time.time()
            out = []
            for kb in list(e.value.data.keys()):
                slot = e.value.live(kb, now)
                if slot is not None:
                    out.extend(self._dec(v) for v in slot["vals"])
            return out

    def entries(self) -> list:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return []
            now = time.time()
            out = []
            for kb in list(e.value.data.keys()):
                slot = e.value.live(kb, now)
                if slot is not None:
                    k = self._dec_key(kb)
                    out.extend((k, self._dec(v)) for v in slot["vals"])
            return out

    def size(self) -> int:
        """→ RMultimap#size: total number of (key, value) pairs —
        counted from the slots directly (decoding every value only to
        discard it paid full codec cost under the store lock)."""
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return 0
            now = time.time()
            return sum(
                len(e.value.live(kb, now)["vals"])
                for kb in list(e.value.data.keys())
                if e.value.live(kb, now) is not None
            )

    def fast_remove(self, *keys: Any) -> int:
        """→ RMultimap#fastRemove(K...): number of keys dropped."""
        with self._store.lock:
            n = 0
            for k in keys:
                kb = self._enc_key(k)
                if self._slot(kb, create=False) is not None:
                    self._drop_key(kb)
                    n += 1
            return n


class ListMultimap(_BaseMultimap):
    """→ RListMultimap: duplicate values per key, insertion order."""

    KIND = "listmultimap"
    SET_SEMANTICS = False


class SetMultimap(_BaseMultimap):
    """→ RSetMultimap: distinct values per key (serialized-bytes equality)."""

    KIND = "setmultimap"
    SET_SEMANTICS = True


class _MultimapCacheMixin:
    """→ RMultimapCache#expireKey: per-KEY TTL."""

    def expire_key(self, key: Any, ttl_seconds: float) -> bool:
        with self._store.lock:
            slot = self._slot(self._enc_key(key), create=False)
            if slot is None:
                return False
            slot["expire_at"] = time.time() + float(ttl_seconds)
            return True

    def remain_key_ttl_ms(self, key: Any) -> int:
        with self._store.lock:
            slot = self._slot(self._enc_key(key), create=False)
            if slot is None:
                return -2
            if slot["expire_at"] is None:
                return -1
            return max(0, int((slot["expire_at"] - time.time()) * 1000))


class ListMultimapCache(_MultimapCacheMixin, ListMultimap):
    KIND = "listmultimapcache"


class SetMultimapCache(_MultimapCacheMixin, SetMultimap):
    KIND = "setmultimapcache"
