"""Load-attribution plane: per-slot, per-key and
per-tenant heat telemetry — the sensing layer the future slot
rebalancer (ROADMAP direction 3, Slicer's assigner half) polls.

Slicer's core lesson is that slot load != key count: assignment must be
weighted by *observed work*.  One ``LoadMap`` per serving process
accumulates exactly that, in three planes:

- **Per-slot accounting** — fixed 16384-wide flat arrays (ops,
  read/write split, bytes in/out, shed ops, cumulative device-launch
  microseconds, live key count), bumped O(1) per command at the RESP
  dispatch point (slot stashed by the cluster door's route decision)
  and at span retirement.  Standalone mode degrades to slot 0, so the
  totals stay meaningful without a cluster.  The count/byte bumps are
  LOCK-FREE on purpose (the storage/heat.py discipline): an element
  ``+=`` is a read-modify-write that can lose a concurrent bump, which
  is benign for an advisory load signal — structural reads
  (``snapshot``/``top_slots``) and the EXACT key counters serialize on
  the leaf lock ``obs.loadmap`` instead.
- **Hot-key detection, dogfooding our own sketches** — a host-side
  *decayed* count-min sketch plus a space-saving top-k (the very
  structures this engine serves) fed by a sampled key stream at RESP
  ingress (``loadmap_key_sample_rate``).  Sampling keeps the hot path
  out of the sketches entirely at low rates; the CMS estimate feeds the
  top-k's counts so reported hotness survives candidate churn.  Both
  structures decay by the same half-life, so "hot" means *recently*
  hot, not hot-ever (redis-cli --hotkeys over LFU has the same
  recency shape).
- **Per-tenant device-time attribution** — the launch timer
  (obs/spans.py ``LaunchTimer``) hands each retiring launch's device
  microseconds, from timing events that bracket the launch on its
  stream (host issue gaps between its kernels included), here
  together with the (tenant, nops) composition the coalescer stashed on
  the launch's span; the
  time is split proportionally to each tenant's op share.  Tenant
  cardinality is bounded: past ``max_tenants`` the coldest entries fold
  into one ``"other"`` bucket (never evicted), and the exported
  ``rtpu_tenant_device_us`` series uses the folded label — top-N +
  other, never one series per tenant name.

The whole module is host-side stdlib + the pure slot math — no torch, no
I/O — so client processes and tests import it for free.
"""

from __future__ import annotations

import math
import threading
import time
from array import array

from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch.cluster.slots import NSLOTS, key_slot

# Reserved fold bucket for the bounded tenant table — a real tenant
# named "other" would merge into it, which only blurs an advisory
# attribution signal.
OTHER_TENANT = "other"


def _as_text(key) -> str:
    if isinstance(key, bytes):
        return key.decode("utf-8", "replace")
    return str(key)


class DecayedCMS:
    """Count-min sketch over the sampled key stream with lazy
    exponential decay: every ``half_life_s`` of wall time halves every
    cell (applied in one vectorized-ish pass when the elapsed time
    crosses the half-life, so the amortized per-add cost stays O(depth)).

    NOT thread-safe on its own — the owning :class:`LoadMap` serializes
    all calls under its leaf lock (the sampled path is already off the
    per-command fast path).
    """

    def __init__(self, width: int = 1024, depth: int = 4,
                 half_life_s: float = 30.0, clock=time.monotonic):
        self.width = int(width)
        self.depth = int(depth)
        self.half_life_s = float(half_life_s)
        self._clock = clock
        self._rows = [array("d", bytes(8 * self.width))
                      for _ in range(self.depth)]
        self._last_decay = clock()

    def _indices(self, key: str):
        # In-process hashing only (never serialized): salting Python's
        # string hash per row gives depth independent functions.
        return [hash((d, key)) % self.width for d in range(self.depth)]

    def maybe_decay(self, now: float) -> float:
        """Apply pending decay; returns the factor applied (1.0 when
        none was due).  Shared by the owning LoadMap so the top-k decays
        in lockstep with the CMS (estimates must stay comparable)."""
        hl = self.half_life_s
        if hl <= 0.0:
            return 1.0
        dt = now - self._last_decay
        if dt < hl:
            return 1.0
        factor = math.pow(2.0, -dt / hl)
        for row in self._rows:
            for i in range(self.width):
                if row[i]:
                    row[i] *= factor
        self._last_decay = now
        return factor

    def add(self, key: str, n: float = 1.0) -> float:
        """Add ``n`` and return the post-add point estimate (min over
        rows — the classic CMS overestimate bound)."""
        est = float("inf")
        for d, i in enumerate(self._indices(key)):
            row = self._rows[d]
            row[i] += n
            if row[i] < est:
                est = row[i]
        return est

    def estimate(self, key: str) -> float:
        est = float("inf")
        for d, i in enumerate(self._indices(key)):
            v = self._rows[d][i]
            if v < est:
                est = v
        return est


class SpaceSavingTopK:
    """Metwally space-saving candidate table: bounded at ``capacity``
    monitored keys; a new key past capacity evicts the minimum-count
    entry and inherits its count (the algorithm's overestimate floor),
    so a genuinely hot newcomer climbs instead of thrashing.

    NOT thread-safe on its own — serialized by the owning LoadMap.
    """

    def __init__(self, capacity: int = 128):
        self.capacity = int(capacity)
        self._counts: dict[str, float] = {}

    def offer(self, key: str, n: float = 1.0) -> None:
        c = self._counts
        cur = c.get(key)
        if cur is not None:
            c[key] = cur + n
            return
        if len(c) < self.capacity:
            c[key] = n
            return
        # Evict the minimum; the newcomer inherits its count (bounded
        # table: this del is the RT006-visible shrink path).
        victim = min(c, key=c.get)
        floor = c[victim]
        del c[victim]
        c[key] = floor + n

    def scale(self, factor: float) -> None:
        for k in self._counts:
            self._counts[k] *= factor

    def top(self, count: int) -> list:
        return sorted(
            self._counts.items(), key=lambda kv: kv[1], reverse=True
        )[: max(0, int(count))]

    def __contains__(self, key) -> bool:
        return key in self._counts

    def __len__(self) -> int:
        return len(self._counts)


# Per-slot vector field order — the wire order of CLUSTER LOADMAP slot
# rows and the snapshot()/merge contract (cluster/client.py
# fleet_loadmap re-exposes it; keep docs/observability.md in sync).
SLOT_FIELDS = (
    "ops", "reads", "writes", "bytes_in", "bytes_out", "shed",
    "device_us", "keys",
)


class LoadMap:
    def __init__(self, *, sample_rate: float = 0.0, cluster: bool = False,
                 max_tenants: int = 32, topk_capacity: int = 128,
                 cms_width: int = 1024, cms_depth: int = 4,
                 half_life_s: float = 30.0, clock=time.monotonic):
        self.enabled = True
        self.sample_rate = float(sample_rate)
        # Slot attribution only means something under the cluster door;
        # standalone keeps everything in slot 0 (totals stay right).
        self.cluster = bool(cluster)
        self.max_tenants = int(max_tenants)
        self._clock = clock
        # LEAF lock by design: the keyspace hooks call note_key() under
        # grid-store / tenancy-registry locks, so nothing may be
        # acquired while this is held.
        self._lock = _witness.named(threading.Lock(), "obs.loadmap")
        # Per-slot planes.  'Q' = uint64 counters, 'd' = float
        # microseconds; bumped lock-free (see module doc).
        self.ops = array("Q", bytes(8 * NSLOTS))
        self.reads = array("Q", bytes(8 * NSLOTS))
        self.writes = array("Q", bytes(8 * NSLOTS))
        self.bytes_in = array("Q", bytes(8 * NSLOTS))
        self.bytes_out = array("Q", bytes(8 * NSLOTS))
        self.shed = array("Q", bytes(8 * NSLOTS))
        self.device_us = array("d", bytes(8 * NSLOTS))
        # EXACT live key count per slot ('q': a racing seed/hook pair
        # may transiently dip a slot below zero; clamped on read).
        self.key_count = array("q", bytes(8 * NSLOTS))
        # Hot-key sketches (dogfooded CMS + space-saving top-k).
        self._cms = DecayedCMS(cms_width, cms_depth, half_life_s, clock)
        self._topk = SpaceSavingTopK(topk_capacity)
        self._sampled = 0  # keys offered to the sketches, lifetime
        # Bounded tenant attribution table:
        # tenant -> [device_us, ops]; folds into OTHER_TENANT past
        # max_tenants (see _fold_tenants_locked).
        self._tenants: dict[str, list] = {}
        # Optional counter Family (created by Observability — RT005
        # keeps Family construction inside obs/) bumped with the
        # bounded tenant label at attribution time.
        self.tenant_device_us_family = None

    # -- per-slot accounting (lock-free hot path) --------------------------

    def note_command(self, slot, write: bool, bytes_in: int,
                     bytes_out: int, nops: int = 1) -> None:
        """One executed command (or one fused run): O(1) array bumps.
        ``slot`` is the door's routing decision (None = not served
        here — redirected/errored, nothing to attribute)."""
        if not self.enabled or slot is None:
            return
        self.ops[slot] += nops
        if write:
            self.writes[slot] += nops
        else:
            self.reads[slot] += nops
        if bytes_in:
            self.bytes_in[slot] += bytes_in
        if bytes_out:
            self.bytes_out[slot] += bytes_out

    def note_shed(self, slot) -> None:
        if not self.enabled or slot is None:
            return
        self.shed[slot] += 1

    # -- hot-key sampling ---------------------------------------------------

    def sample_keys(self, keys, n: int = 1) -> int:
        """Feed already-sampled keys into the sketches (the caller owns
        the sampling coin so the unsampled fast path never reaches this
        module).  Returns how many keys were offered."""
        if not self.enabled or not keys:
            return 0
        now = self._clock()
        offered = 0
        with self._lock:
            factor = self._cms.maybe_decay(now)
            if factor != 1.0:
                self._topk.scale(factor)
            for key in keys:
                k = _as_text(key)
                est = self._cms.add(k, n)
                # The CMS estimate (not the raw increment) feeds the
                # candidate table: a key re-entering after eviction
                # competes with its full observed weight.
                if k in self._topk:
                    self._topk.offer(k, n)
                else:
                    self._topk.offer(k, est)
                offered += 1
            self._sampled += offered
        return offered

    def hot_keys(self, count: int = 16) -> list:
        """[(key, estimated_decayed_count), ...] hottest first."""
        now = self._clock()
        with self._lock:
            factor = self._cms.maybe_decay(now)
            if factor != 1.0:
                self._topk.scale(factor)
            return [(k, c) for k, c in self._topk.top(count)]

    def sampled_keys(self) -> int:
        with self._lock:
            return self._sampled

    def tracked_keys(self) -> int:
        with self._lock:
            return len(self._topk)

    # -- exact per-slot key counters ---------------------------------------

    def note_key(self, name, delta: int) -> None:
        """Keyspace hook: ±1 per create/drop, called UNDER the store /
        registry lock — exact, so CLUSTER COUNTKEYSINSLOT is O(1)."""
        slot = key_slot(name) if self.cluster else 0
        with self._lock:
            self.key_count[slot] += delta

    def seed_keys(self, names) -> None:
        """Replace the key-count plane from one authoritative keyspace
        scan (server boot, after restore)."""
        counts = array("q", bytes(8 * NSLOTS))
        if self.cluster:
            for name in names:
                counts[key_slot(name)] += 1
        else:
            counts[0] = sum(1 for _ in names)
        with self._lock:
            self.key_count = counts

    def keys_in_slot(self, slot: int) -> int:
        with self._lock:
            return max(0, self.key_count[slot])

    # -- tenant device-time attribution ------------------------------------

    def attribute_launch(self, op: str, tenants, device_us: float) -> None:
        """Split one retired launch's device-side microseconds across
        the (tenant, nops) composition the coalescer recorded.  Called
        from the completer thread (span retirement) — off every
        client-facing path."""
        if not self.enabled or not tenants or device_us <= 0.0:
            return
        total = 0
        for _t, n in tenants:
            total += n
        if total <= 0:
            return
        fam = self.tenant_device_us_family
        bumps = []
        with self._lock:
            for tenant, n in tenants:
                us = device_us * (n / total)
                # Slot plane: the tenant label IS the sketch name, so
                # its slot is the key's slot (lock-free bump is fine,
                # we only hold the lock for the tenant table).
                slot = key_slot(tenant) if self.cluster else 0
                self.device_us[slot] += us
                ent = self._tenants.get(tenant)
                if ent is None:
                    self._tenants[tenant] = [us, n]
                else:
                    ent[0] += us
                    ent[1] += n
            if len(self._tenants) > self.max_tenants:
                self._fold_tenants_locked()
            if fam is not None:
                for tenant, n in tenants:
                    label = (tenant if tenant in self._tenants
                             else OTHER_TENANT)
                    bumps.append((label, device_us * (n / total)))
        if fam is not None:
            for label, us in bumps:
                fam.inc((label, op), us)

    def _fold_tenants_locked(self) -> None:
        """Bound the attribution table: keep the top ``max_tenants - 1``
        by device time, fold the rest into the OTHER_TENANT bucket
        (which itself is never evicted)."""
        t = self._tenants
        other = t.pop(OTHER_TENANT, None) or [0.0, 0]
        ranked = sorted(t.items(), key=lambda kv: kv[1][0], reverse=True)
        keep = ranked[: max(1, self.max_tenants - 1)]
        for _name, ent in ranked[len(keep):]:
            other[0] += ent[0]
            other[1] += ent[1]
        t.clear()
        t.update(keep)
        if other[0] or other[1]:
            t[OTHER_TENANT] = other

    def tenant_shares(self) -> dict:
        """{tenant: {device_us, ops, share}} — share of total attributed
        device time (INFO loadstats' billing view)."""
        with self._lock:
            items = [(k, v[0], v[1]) for k, v in self._tenants.items()]
        total = sum(us for _k, us, _n in items)
        out = {}
        for k, us, n in sorted(items, key=lambda e: e[1], reverse=True):
            out[k] = {
                "device_us": round(us, 1),
                "ops": int(n),
                "share": round(us / total, 4) if total > 0 else 0.0,
            }
        return out

    # -- aggregate views ----------------------------------------------------

    def top_slots(self, count: int = 8) -> list:
        """[(slot, ops), ...] busiest first, non-zero slots only."""
        ops = self.ops
        nz = [(s, ops[s]) for s in range(NSLOTS) if ops[s]]
        nz.sort(key=lambda e: e[1], reverse=True)
        return nz[: max(0, int(count))]

    def totals(self) -> dict:
        return {
            "ops": sum(self.ops),
            "reads": sum(self.reads),
            "writes": sum(self.writes),
            "bytes_in": sum(self.bytes_in),
            "bytes_out": sum(self.bytes_out),
            "shed": sum(self.shed),
            "device_us": round(sum(self.device_us), 1),
            "keys": sum(max(0, k) for k in self.key_count),
        }

    def snapshot(self) -> dict:
        """The CLUSTER LOADMAP payload: non-zero slot rows (slot ->
        SLOT_FIELDS-ordered vector), hottest keys, tenant shares.  Slot
        keys are strings because the payload travels as JSON."""
        slots = {}
        for s in range(NSLOTS):
            if (self.ops[s] or self.shed[s] or self.key_count[s]
                    or self.device_us[s]):
                slots[str(s)] = [
                    int(self.ops[s]), int(self.reads[s]),
                    int(self.writes[s]), int(self.bytes_in[s]),
                    int(self.bytes_out[s]), int(self.shed[s]),
                    round(self.device_us[s], 1),
                    max(0, self.key_count[s]),
                ]
        return {
            "fields": list(SLOT_FIELDS),
            "slots": slots,
            # 32, not the HOTKEYS-default 16: fleet merges re-rank
            # across nodes, and a per-node truncation at the final list
            # size would drop keys that are mid-tail locally but head
            # fleet-wide.
            "hot_keys": [[k, round(c, 2)] for k, c in self.hot_keys(32)],
            "tenants": self.tenant_shares(),
            "sample_rate": self.sample_rate,
            "sampled_keys": self.sampled_keys(),
            "totals": self.totals(),
        }

    def stats(self) -> dict:
        """Flat scalars for INFO loadstats (plus the shares/top views
        the section formats itself)."""
        t = self.totals()
        return {
            "loadmap_enabled": 1 if self.enabled else 0,
            "loadmap_key_sample_rate": self.sample_rate,
            "loadmap_ops": t["ops"],
            "loadmap_reads": t["reads"],
            "loadmap_writes": t["writes"],
            "loadmap_bytes_in": t["bytes_in"],
            "loadmap_bytes_out": t["bytes_out"],
            "loadmap_shed_ops": t["shed"],
            "loadmap_device_us": t["device_us"],
            "loadmap_keys": t["keys"],
            "loadmap_sampled_keys": self.sampled_keys(),
            "loadmap_tracked_keys": self.tracked_keys(),
            "loadmap_tracked_tenants": len(self._tenants),
        }

    def reset(self) -> None:
        """Zero every plane (bench warmup discipline, like
        Observability.reset_op_stats)."""
        with self._lock:
            for a in (self.ops, self.reads, self.writes, self.bytes_in,
                      self.bytes_out, self.shed):
                for i in range(NSLOTS):
                    a[i] = 0
            for i in range(NSLOTS):
                self.device_us[i] = 0.0
            self._cms = DecayedCMS(
                self._cms.width, self._cms.depth,
                self._cms.half_life_s, self._clock)
            self._topk = SpaceSavingTopK(self._topk.capacity)
            self._sampled = 0
            self._tenants.clear()


__all__ = [
    "DecayedCMS",
    "LoadMap",
    "OTHER_TENANT",
    "SLOT_FIELDS",
    "SpaceSavingTopK",
]
