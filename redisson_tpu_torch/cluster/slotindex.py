"""Write-time slot→key index.

cluster/door.py's ``keys_in_slot`` documents its own upgrade path: the
keyspace kept no slot index, so ``CLUSTER GETKEYSINSLOT`` — and with
it every batch of the migration pump — re-hashed EVERY key name per
call.  That O(total keys) scan was fine while migration was a rare
operator action; the autonomous rebalancer makes many-slot migration
the common case, turning the scan quadratic (scan per pump batch ×
batches per slot × slots per wave).

This index maintains the inverse map at write time instead: the same
keyspace hooks that feed the load map's exact per-slot key COUNTS
(``LoadMap.note_key``) feed per-slot key NAME sets here, so
``GETKEYSINSLOT`` becomes O(keys actually in the slot).  Sparse on
purpose — a dict of sets, not 16384 preallocated buckets — because a
node owns a contiguous fraction of slots and most hold nothing.

The old scan survives as ``ClusterDoor.keys_in_slot_scan`` and is
served by ``DEBUG GETKEYSINSLOT``/``DEBUG COUNTKEYSINSLOT`` as the
ground-truth cross-check (the differential the index tests assert).

The port's copy of ``redisson_tpu/cluster/slotindex.py``, byte formats and
semantics unchanged; its locks are plain ``threading`` locks (the JAX
package wraps them in its lock-order witness).
"""

from __future__ import annotations

import threading

from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch.cluster.slots import key_slot


class SlotKeyIndex:
    """Exact per-slot key-name sets, maintained by keyspace hooks.

    ``note`` mirrors ``LoadMap.note_key``'s signature (name, ±delta)
    so one fan-out hook feeds both planes; it is called under the
    store/registry lock, and takes its own LEAF lock only for the set
    mutation — same discipline as ``obs.loadmap``."""

    def __init__(self):
        self._lock = _witness.named(threading.Lock(), "cluster.slotindex")
        self._by_slot: dict = {}  # slot -> set of key names (str)

    def note(self, name, delta: int) -> None:
        if isinstance(name, bytes):
            name = name.decode("utf-8", "replace")
        slot = key_slot(name)
        with self._lock:
            bucket = self._by_slot.get(slot)
            if delta > 0:
                if bucket is None:
                    bucket = self._by_slot[slot] = set()
                bucket.add(name)
            elif bucket is not None:
                bucket.discard(name)
                if not bucket:
                    del self._by_slot[slot]

    def seed(self, names) -> None:
        """Replace the index from one authoritative keyspace scan
        (server boot, after restore) — the ``seed_keys`` analog."""
        by_slot: dict = {}
        for name in names:
            if isinstance(name, bytes):
                name = name.decode("utf-8", "replace")
            by_slot.setdefault(key_slot(name), set()).add(name)
        with self._lock:
            self._by_slot = by_slot

    def keys(self, slot: int, count=None) -> list:
        """Sorted key names in ``slot`` (sorted: GETKEYSINSLOT callers
        — the pump, tests — get a deterministic order where the scan's
        order was insertion-dependent)."""
        with self._lock:
            bucket = self._by_slot.get(slot)
            out = sorted(bucket) if bucket else []
        if count is not None:
            return out[:count]
        return out

    def count(self, slot: int) -> int:
        with self._lock:
            bucket = self._by_slot.get(slot)
            return len(bucket) if bucket else 0

    def nonempty_slots(self) -> list:
        with self._lock:
            return sorted(self._by_slot)
