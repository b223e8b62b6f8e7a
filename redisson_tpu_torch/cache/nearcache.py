"""Sketch near cache: an epoch-guarded host read tier for device sketches.

Counterpart of ``redisson_tpu/cache/nearcache.py``, with the same epoch
discipline, so a cached answer here is the answer the device gives.
Redisson answers hot reads client-side (`RLocalCachedMap` +
org/redisson/cache/) and invalidates on write.  Sketches make
that discipline CHEAP, because their results fall into two classes:

- **Monotone positives**: a Bloom/bitset membership that reads True stays
  True until something *structural* happens (clear, delete, restore,
  resize/size-class migration, flip, BITOP-replace).  These cache tagged
  with the object's **structural epoch** only — ordinary adds never
  invalidate them, so the hottest entries never churn.
- **Everything else** (negatives, HLL counts, CMS estimates, bitset
  scalars): any write may change them.  These cache tagged with the
  object's **write epoch** and serve only while it still matches.

Epoch discipline (the whole correctness argument):

- Every mutating engine call bumps the write epoch **on entry** (submit
  time, not ack): the moment an add is in flight, every previously cached
  negative for that object stops matching — a hit can never race an
  acknowledged-but-unapplied write.  Structural ops bump both epochs.
- The same call bumps **again on exit**: a read that captured the epoch
  *during* the write's entry→submit window (and so may have been
  dispatched ahead of the write by the coalescer) installs with a tag
  that is already stale by the time the writer returns.  Entry bump
  guards serving; exit bump guards installing.
- Readers capture the epoch pair BEFORE submitting the miss and install
  results only if the pair is unchanged at install time (the same
  sampled-generation idiom as ``LocalCachedMap._inval_gen``).

Epochs are monotone for the lifetime of the process and survive object
deletion (a successor object under the same name continues the sequence,
so an in-flight read of the OLD object can never install as fresh).

What is never cached: multi-key unions (PFCOUNT k1 k2), top-K queries
(device re-estimation is the point), DUMP/toByteArray payloads, and any
batch larger than ``nearcache_max_batch`` (bulk passes belong to the
batched device path, not the per-op host tier).
"""

from __future__ import annotations

import threading

import numpy as np

from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch.cache.lru import MISS, ShardedLRUStore

# Per-entry host overhead estimate: dict slot + key tuple + tag ints.
_ENTRY_OVERHEAD = 96

# Resolved on first use (engines imports this module lazily, so a
# module-level import would be circular-adjacent and drag the executor
# chain into cache import time; a cached global keeps the full-hit path
# — the microseconds this tier exists for — free of per-call import
# machinery).
_ImmediateResult = None


def _immediate(value):
    global _ImmediateResult
    if _ImmediateResult is None:
        from redisson_tpu_torch.objects.engines import ImmediateResult

        _ImmediateResult = ImmediateResult
    return _ImmediateResult(value)


class _AssembledResult:
    """LazyResult merging cached hits with the miss sub-batch's future;
    installs the misses into the cache at resolve time (epoch-checked)."""

    def __init__(self, cache, name, keys, miss_idx, hit_vals, fut, dtype,
                 captured, monotone):
        self._cache = cache
        self._name = name
        self._keys = keys
        self._miss_idx = miss_idx
        self._hit_vals = hit_vals  # (idx, value) pairs
        self._fut = fut
        self._dtype = dtype
        self._captured = captured
        self._monotone = monotone
        self._done = None

    def result(self, *a, **kw):
        if self._done is None:
            sub = np.asarray(self._fut.result(*a, **kw))
            out = np.empty(len(self._keys), dtype=self._dtype)
            for i, v in self._hit_vals:
                out[i] = v
            out[self._miss_idx] = sub
            self._cache.install_batch(
                self._name,
                [
                    (self._keys[i], sub[j].item())
                    for j, i in enumerate(self._miss_idx)
                ],
                captured=self._captured, monotone=self._monotone,
            )
            self._done = out
            self._fut = None
        return self._done

    def get(self):
        return self.result()

    def done(self) -> bool:
        return self._done is not None


class _InstallingScalar:
    """LazyResult wrapper installing a scalar read at resolve time."""

    def __init__(self, cache, name, key, fut, captured):
        self._cache = cache
        self._name = name
        self._key = key
        self._fut = fut
        self._captured = captured
        self._done = False
        self._value = None

    def result(self, *a, **kw):
        if not self._done:
            self._value = self._fut.result(*a, **kw)
            self._cache.install(
                self._name, self._key, self._value,
                captured=self._captured, monotone=False,
            )
            self._done = True
            self._fut = None
        return self._value

    def get(self):
        return self.result()

    def done(self) -> bool:
        return self._done


class SketchNearCache:
    def __init__(self, store: ShardedLRUStore, obs=None, *,
                 enabled: bool = True, max_batch: int = 1024):
        self.store = store
        self.obs = obs
        self.enabled = enabled
        self.max_batch = int(max_batch)
        # Set by the engine when the cache must stay off for correctness
        # (multi-controller lockstep): a live re-enable is refused, not
        # silently acked.
        self.locked_off = False
        # Own hit/miss counters — the store's count raw probes, which
        # would score an epoch-stale probe (found, then discarded) as a
        # hit.  Torn int reads are fine for monitoring.
        self.hits = 0
        self.misses = 0
        # name -> (write_epoch, struct_epoch).  Bumps run under a lock
        # (two racing writers must never collapse into one bump — a
        # reader in the first writer's window would then install a tag
        # the second writer's exit was supposed to retire); reads are a
        # plain dict probe, atomic under the GIL.
        self._epochs: dict = {}
        # Keyspace-wide epoch FLOOR: the default pair for names with no
        # entry yet.  invalidate_all advances it, so a read of a
        # never-mutated object captured before a whole-keyspace event
        # (snapshot restore, reshard) can never install as fresh after
        # it — per-name bumps alone cannot retire names they have never
        # seen.
        self._floor = (0, 0)
        self._elock = _witness.named(threading.Lock(), "nearcache.epochs")
        # _epochs is pruned back toward the floor when it outgrows this
        # (see _prune_locked): per-name entries must survive DELETION
        # (successor coherence) but not forever — name-churn workloads
        # (TTL'd per-session sketches) would otherwise leak one dict
        # entry per name ever mutated for the process lifetime.  The
        # threshold doubles past the live-tenant count after each prune
        # so the O(n) sweep stays amortized, never per-write.
        self._epoch_cap = 1 << 16
        self._epoch_prune_at = self._epoch_cap

    def set_enabled(self, enabled: bool) -> None:
        """Live CONFIG SET path.  Disabling drops every entry (frees the
        host bytes, and a later re-enable starts from an empty — never a
        stale — store; epochs keep advancing either way because the
        engine's write hooks run unconditionally)."""
        enabled = bool(enabled)
        if enabled and self.locked_off:
            raise ValueError(
                "near cache is forced off under multi-host: a cache hit "
                "skips a device dispatch, which breaks multi-controller "
                "lockstep"
            )
        was, self.enabled = self.enabled, enabled
        # Flag first, then clear: in-flight installs observe disabled and
        # bail, so the freed bytes STAY freed (clear-then-flag left a
        # window where a racing install repopulated a "disabled" store —
        # entries no probe would ever evict).
        if was and not enabled:
            self.store.clear()

    # -- epoch API (the engine's write hooks) ------------------------------

    def epochs(self, name: str) -> tuple:
        return self._epochs.get(name, self._floor)

    def note_write(self, name: str) -> None:
        with self._elock:
            w, s = self._epochs.get(name, self._floor)
            self._epochs[name] = (w + 1, s)
            if len(self._epochs) > self._epoch_prune_at:
                self._prune_locked()

    def note_structural(self, name: str) -> None:
        with self._elock:
            w, s = self._epochs.get(name, self._floor)
            self._epochs[name] = (w + 1, s + 1)
            if len(self._epochs) > self._epoch_prune_at:
                self._prune_locked()

    def _prune_locked(self) -> None:
        """Fold the epoch entries of names with NO live cached entries
        back into the floor — bounding ``_epochs`` by the store's live
        tenant count (itself byte-bounded).  The floor rises past every
        pruned pair, so an in-flight read of a pruned name can neither
        serve nor install (its captured pair no longer matches → a miss,
        never a stale hit), and per-name epoch sequences stay monotone:
        a pruned name that returns resumes FROM the raised floor.  The
        raise also retires floor-tagged entries of untouched names —
        a rare, performance-only refetch, priced against an unbounded
        host leak."""
        fw, fs = self._floor
        keep = {}
        for name, (w, s) in self._epochs.items():
            if self.store.tenant_entry_count(name):
                keep[name] = (w, s)
            else:
                fw = max(fw, w)
                fs = max(fs, s)
        if len(keep) < len(self._epochs):
            self._floor = (fw + 1, fs + 1)
            self._epochs = keep
        self._epoch_prune_at = max(self._epoch_cap, 2 * len(keep))

    def drop_object(self, name: str) -> None:
        """Delete/rename/restore: drop the object's entries and advance
        the structural epoch (epochs never reset — see module doc)."""
        self.note_structural(name)
        self.store.invalidate_tenant(name)

    def invalidate_all(self) -> None:
        """Whole-keyspace events (snapshot restore, topology change,
        FLUSHALL): every cached entry and every epoch moves on — the
        FLOOR included, so names this process never mutated (and so has
        no per-name entry for) also stop matching pre-event captures."""
        with self._elock:
            fw, fs = self._floor
            self._floor = (fw + 1, fs + 1)
            for name, (w, s) in list(self._epochs.items()):
                self._epochs[name] = (w + 1, s + 1)
        self.store.clear()

    # -- read-side plumbing ------------------------------------------------

    def active(self, batch_len: int) -> bool:
        return self.enabled and 0 < batch_len <= self.max_batch

    def probe(self, name: str, key):
        """Cached value or MISS, honoring the entry's epoch tag."""
        ent = self.store.get(name, key)
        if ent is MISS:
            return MISS
        value, wtag, stag = ent
        w, s = self.epochs(name)
        if (wtag is not None and wtag != w) or (
            stag is not None and stag != s
        ):
            self.store.discard(name, key)
            return MISS
        return value

    def install(self, name: str, key, value, *, captured, monotone) -> None:
        """Install a read result tagged by the policy.  ``captured`` is
        the epoch pair sampled BEFORE the read was submitted; a write
        since then makes a TAGGED result unsafe to cache (it may have
        been dispatched ahead of that write).  A monotone POSITIVE only
        needs the structural epoch unmoved: ordinary writes can set bits
        but never clear them, so a True observed at struct epoch s stays
        True for as long as s holds — in-window adds included."""
        if not self.enabled:
            # A future created before CONFIG SET nearcache no resolves
            # after it: installing would hold bytes the operator just
            # asked to free (and nothing would ever evict them).
            return
        w, s = self.epochs(name)
        if monotone and bool(value):
            if captured[1] != s:
                return
            ent = (value, None, s)  # positive: survives ordinary writes
        else:
            if (w, s) != captured:
                return
            ent = (value, w, None)
        nbytes = _ENTRY_OVERHEAD + _key_nbytes(key)
        self.store.put(name, key, ent, nbytes)

    def install_batch(self, name: str, items, *, captured,
                      monotone) -> None:
        """Batch install for assembled partial-hit results (the fused
        front-door runs make these hundreds of ops long): ONE epoch
        sample covers every miss of the object — per-key re-sampling in
        install() is redundant inside a single resolve, and the epoch
        rules applied here are install()'s exactly."""
        if not self.enabled:
            return
        w, s = self.epochs(name)
        tagged_ok = (w, s) == captured
        monotone_ok = monotone and captured[1] == s
        for key, value in items:
            if monotone and bool(value):
                if not monotone_ok:
                    continue
                ent = (value, None, s)  # positive: survives plain writes
            else:
                if not tagged_ok:
                    continue
                ent = (value, w, None)
            self.store.put(
                name, key, ent, _ENTRY_OVERHEAD + _key_nbytes(key)
            )

    def _count(self, kind: str, hits: int, misses: int) -> None:
        self.hits += hits
        self.misses += misses
        if self.obs is None:
            return
        if hits:
            self.obs.nearcache_hits.inc((kind,), hits)
        if misses:
            self.obs.nearcache_misses.inc((kind,), misses)

    def lookup_batch(self, kind: str, name: str, keys, dtype,
                     fetch_misses, *, monotone, captured=None):
        """Partial-hit split for element-wise reads: cached ops answer
        immediately, only the misses travel to ``fetch_misses`` (a
        callable taking the miss index array — or None for "the whole
        batch missed", so the caller can reuse its original arrays
        without a gather — and returning a LazyResult over that
        sub-batch).  Returns a LazyResult over the full batch; miss
        results install into the cache at resolve time.

        ``captured``: epoch pair the CALLER sampled before resolving the
        object's registry entry — a delete/drop racing the entry lookup
        bumps the epochs between the two, and sampling here (after) would
        tag results read from the OLD object's reaped row as fresh for
        the successor.  None → sample now (callers with no entry-
        resolution window)."""
        if captured is None:
            captured = self.epochs(name)
        hit_vals = []
        miss_idx = []
        for i, k in enumerate(keys):
            v = self.probe(name, k)
            if v is MISS:
                miss_idx.append(i)
            else:
                hit_vals.append((i, v))
        self._count(kind, len(hit_vals), len(miss_idx))
        if not miss_idx:
            out = np.empty(len(keys), dtype=dtype)
            for i, v in hit_vals:
                out[i] = v
            return _immediate(out)
        idx = np.asarray(miss_idx, np.int64)
        fut = fetch_misses(None if len(miss_idx) == len(keys) else idx)
        return _AssembledResult(
            self, name, keys, idx, hit_vals, fut, dtype, captured, monotone,
        )

    def lookup_scalar(self, kind: str, name: str, key, fetch, *,
                      captured=None):
        """Scalar read-through (counts, cardinality, bitpos): cached
        LazyResult on hit, else ``fetch()``'s future wrapped to install
        at resolve time.  Scalars are never monotone.  ``captured``: see
        lookup_batch."""
        if captured is None:
            captured = self.epochs(name)
        v = self.probe(name, key)
        if v is not MISS:
            self._count(kind, 1, 0)
            return _immediate(v)
        self._count(kind, 0, 1)
        return _InstallingScalar(self, name, key, fetch(), captured)

    # -- cache keys --------------------------------------------------------

    @staticmethod
    def encoded_keys(blocks, lengths) -> list:
        """Canonical per-op cache keys from codec lane blocks: the key's
        own bytes, trimmed of lane padding — identical whatever lane
        width the batch happened to pad to."""
        blocks = np.ascontiguousarray(blocks)
        B = blocks.shape[0]
        if np.ndim(lengths) == 0:
            n = int(lengths)
            return [blocks[i].tobytes()[:n] for i in range(B)]
        return [
            blocks[i].tobytes()[: int(lengths[i])] for i in range(B)
        ]

    @staticmethod
    def hashed_keys(H1, H2) -> list:
        return [
            (int(a), int(b)) for a, b in zip(np.asarray(H1), np.asarray(H2))
        ]

    def stats(self) -> dict:
        st = self.store.stats()
        # Epoch-aware hit/miss (the store's raw counters score a stale
        # probe — found, then epoch-discarded — as a hit).
        hits, misses = self.hits, self.misses
        st["hits"] = hits
        st["misses"] = misses
        st["hit_rate"] = (
            round(hits / (hits + misses), 4) if hits + misses else 0.0
        )
        st["enabled"] = self.enabled
        st["max_batch"] = self.max_batch
        return st


def _key_nbytes(key) -> int:
    if isinstance(key, bytes):
        return len(key)
    if isinstance(key, tuple):
        return 16 * len(key)
    return 16
