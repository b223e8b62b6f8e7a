"""TorchSketchEngine — the backend behind the port's sketch objects
(BloomFilter, HyperLogLog, BitSet, CountMinSketch).

Counterpart of ``TpuSketchEngine`` in ``redisson_tpu/objects/engines.py``
for this package's slice: tenant registry + size-class pools +
TorchCommandExecutor, with the BatchCoalescer in front when
``coalesce`` is on.  The routing and the ops each call becomes follow
the JAX engine, so both packages return the same answers and hold the
same pool bytes.  The object lifecycle (TTL, exists/delete/rename,
DUMP/RESTORE, snapshots) comes from ``objects/durability.py``.  The
journal, near cache, degraded mirrors, residency tiers and replicas are
not part of the port yet.
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
import warnings
from typing import Optional

import numpy as np

from redisson_tpu_torch.executor.coalescer import BatchCoalescer, HintedFuture
from redisson_tpu_torch.executor.torch_executor import (
    LazyResult,
    TorchCommandExecutor,
)
from redisson_tpu_torch.objects.base import MappedFuture
from redisson_tpu_torch.objects.durability import SketchDurabilityMixin
from redisson_tpu_torch.ops import bitset as bitset_ops, golden
from redisson_tpu_torch.tenancy import PoolKind, TenantRegistry
from redisson_tpu_torch.tenancy.registry import class_words_for_bits
from redisson_tpu_torch.utils import hashing

# Initial rows per size-class pool (the JAX package's default; pools then
# double, so both packages' pools keep one shape).
INITIAL_TENANTS_PER_CLASS = 8


class ImmediateResult(LazyResult):
    """A result already materialized on the host."""

    def __init__(self, value):
        super().__init__(value)


class _ConcatLazy:
    """Result of a coalesced bitset launch that a size-class migration
    split into consecutive per-pool launches: the parts' results
    concatenated in op order."""

    def __init__(self, parts):
        self._parts = parts
        self._done = None

    def result(self, timeout=None):
        if self._done is None:
            self._done = np.concatenate([p.result() for p in self._parts])
            self._parts = None
        return self._done

    def get(self):
        return self.result()

    def done(self) -> bool:
        return self._done is not None


class TopKStore:
    """Engine-shared heavy-hitter candidate tables, name-addressed: every
    CountMinSketch handle for ``name`` sees ONE table of candidate keys
    with their last-seen estimates, max-merged and pruned; ``top_k()``
    re-estimates candidates on the device, so the table only needs to
    not LOSE heavy keys."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tables: dict[str, dict] = {}

    def configure(self, name: str, k: int) -> None:
        with self._lock:
            t = self._tables.get(name)
            if t is None:
                self._tables[name] = {"k": int(k), "cands": {}}
            else:
                t["k"] = max(t["k"], int(k))

    def track(self, name: str) -> int:
        with self._lock:
            t = self._tables.get(name)
            return 0 if t is None else t["k"]

    def offer(self, name: str, keys, estimates) -> None:
        """Max-merge a batch's estimates (callers offer only the batch's
        heaviest 4k unique keys)."""
        with self._lock:
            t = self._tables.get(name)
            if t is None:
                return
            cands = t["cands"]
            for key, est in zip(keys, estimates):
                e = int(est)
                if cands.get(key, 0) < e:
                    cands[key] = e
            cap = 4 * max(t["k"], 16)
            if len(cands) > 2 * cap:
                keep = heapq.nlargest(cap, cands.items(), key=lambda kv: kv[1])
                t["cands"] = dict(keep)

    def drop(self, name: str) -> None:
        with self._lock:
            self._tables.pop(name, None)

    def candidates(self, name: str) -> list:
        with self._lock:
            t = self._tables.get(name)
            return [] if t is None else list(t["cands"])

    def rename(self, old: str, new: str) -> None:
        with self._lock:
            self._tables.pop(new, None)
            t = self._tables.pop(old, None)
            if t is not None:
                self._tables[new] = t

    # -- durability: snapshots and CMS dumps carry the candidate tables,
    # data-only (losing them would forget every heavy hitter while the
    # counters survive) --------------------------------------------------

    # Candidate keys round-trip with their ORIGINAL scalar type: codecs
    # encode np.uint64(5) and 5 to different bytes, so a type-collapsing
    # export would make a restored top_k() re-estimate the wrong cells.
    _KEY_TAGS = {
        int: ("i", int),
        np.uint64: ("u8", int),
        np.uint32: ("u4", int),
        np.int64: ("i8", int),
        np.int32: ("i4", int),
        str: ("s", str),
    }
    _TAG_DECODE = {
        "i": int,
        "u8": np.uint64,
        "u4": np.uint32,
        "i8": np.int64,
        "i4": np.int32,
        "s": str,
        "b": bytes.fromhex,
    }
    MAX_K = 1 << 20  # sanity bound on an imported table's k

    @classmethod
    def _encode_cands(cls, name: str, t: dict) -> dict:
        cands = []
        skipped = set()
        for key, est in t["cands"].items():
            enc = cls._KEY_TAGS.get(type(key))
            if enc is not None:
                cands.append([enc[0], enc[1](key), int(est)])
            elif isinstance(key, bytes):
                cands.append(["b", key.hex(), int(est)])
            else:
                skipped.add(type(key).__name__)
        if skipped:
            warnings.warn(
                f"top-K candidates of {name!r} with non-serializable key "
                f"types {sorted(skipped)} were not exported; they will "
                f"re-enter the table from future traffic"
            )
        return {"k": int(t["k"]), "cands": cands}

    @classmethod
    def _decode_cands(cls, d: dict) -> dict:
        """Strict decode of an UNTRUSTED table: unknown tags or malformed
        values raise ValueError, and so does a k past ``MAX_K``."""
        cands = {}
        for entry in d.get("cands", []):
            if not isinstance(entry, (list, tuple)) or len(entry) != 3:
                raise ValueError(f"bad topk entry: {entry!r}")
            tag, val, est = entry
            dec = cls._TAG_DECODE.get(tag)
            if dec is None:
                raise ValueError(f"bad topk key tag: {tag!r}")
            cands[dec(val)] = int(est)
        k = int(d.get("k", 0))
        if not 0 <= k <= cls.MAX_K:
            raise ValueError(f"topk k={k} out of range")
        return {"k": k, "cands": cands}

    def export_state(self, name: Optional[str] = None):
        """JSON-safe copy of one table (None if absent) or of all."""
        with self._lock:
            if name is not None:
                t = self._tables.get(name)
                return None if t is None else self._encode_cands(name, t)
            return {n: self._encode_cands(n, t) for n, t in self._tables.items()}

    @classmethod
    def decode_state(cls, state, name: Optional[str] = None):
        """Validate and decode an untrusted export WITHOUT touching the
        store: restore paths call this before any mutation, then install
        the value with ``import_decoded``."""
        if name is not None:
            return cls._decode_cands(state) if state else None
        return {n: cls._decode_cands(d) for n, d in (state or {}).items()}

    def import_decoded(self, decoded, name: Optional[str] = None) -> None:
        with self._lock:
            if name is not None:
                self._tables.pop(name, None)  # never keep a ghost table
                if decoded:
                    self._tables[name] = decoded
                return
            self._tables.update(decoded or {})

    def import_state(self, state, name: Optional[str] = None) -> None:
        self.import_decoded(self.decode_state(state, name), name)


_log = logging.getLogger(__name__)


class TorchSketchEngine(SketchDurabilityMixin):
    # Per-launch op cap of the sequential CMS path: the JAX engine chunks
    # at this size and carries state across chunks, so sequential
    # semantics are exact either way; the same chunks keep the per-op
    # results and the launch count of both packages aligned.
    _SEQ_CHUNK = 1 << 15

    def __init__(self, config):
        self.config = config
        cfg = config.gpu_sketch
        self.executor = TorchCommandExecutor(config)
        self.registry = TenantRegistry(
            self.executor,
            initial_capacity=INITIAL_TENANTS_PER_CLASS,
            dispatch_lock=self.executor._dispatch_lock,
        )
        self.topk = TopKStore()
        self.coalescer = None
        if cfg.coalesce:
            self.coalescer = BatchCoalescer(
                batch_window_us=cfg.batch_window_us,
                max_batch=cfg.max_batch,
                max_inflight=cfg.max_inflight,
                max_queued_ops=cfg.max_queued_ops,
                group_collect=(
                    self.executor.collect_group if cfg.mailbox_collect else None
                ),
            )
        self._sweeper = None
        self._snapshotter = None
        # One snapshot at a time: the periodic snapshotter, explicit calls
        # and shutdown write the same tmp files.  Strictly outermost.
        self._snapshot_lock = threading.Lock()
        # Checkpoint/resume: restore from the configured directory, then
        # arm periodic snapshots (never while the restore runs).
        if config.snapshot_dir:
            try:
                self.restore_snapshot(config.snapshot_dir)
            except Exception:
                self._stop_coalescer()
                raise
            if config.snapshot_interval_s > 0:
                self._start_snapshotter(config.snapshot_dir, config.snapshot_interval_s)

    def shutdown(self) -> None:
        """Stop the snapshotter and the sweeper, write the final snapshot
        (best effort, logged on failure), then stop the coalescer."""
        self._stop_snapshotter()
        self._stop_sweeper()
        if self.config.snapshot_dir:
            try:
                self.snapshot(self.config.snapshot_dir)
            except Exception:
                _log.exception("snapshot on shutdown to %s failed", self.config.snapshot_dir)
        self._stop_coalescer()

    def _stop_coalescer(self) -> None:
        if self.coalescer is not None:
            self.coalescer.shutdown()

    def _drain(self) -> None:
        """Direct state reads must observe all queued coalesced ops."""
        if self.coalescer is not None:
            self.coalescer.drain()

    def _submit(self, key, dispatch, arrays, nops, pool_key=None, meta=None):
        fut = self.coalescer.submit(
            key, dispatch, arrays, nops, pool_key=pool_key, meta=meta
        )
        return HintedFuture(fut, self.coalescer)

    def collect_results(self, lazies) -> None:
        """Mailbox collect for the bulk APIs: honors ``mailbox_collect``;
        a failed group fetch leaves each item to its own ``.result()``."""
        if not self.config.gpu_sketch.mailbox_collect:
            return
        try:
            self.executor.collect_group(lazies)
        except Exception:
            pass

    # -- generic -----------------------------------------------------------

    def params(self, name: str) -> Optional[dict]:
        entry = self._live_lookup(name)
        return None if entry is None else entry.params

    def _lookup_kind(self, name: str, kind: str):
        """None if absent or expired; TypeError on a kind mismatch."""
        entry = self._live_lookup(name)
        if entry is not None and entry.kind != kind:
            raise TypeError(f"object {name!r} holds a {entry.kind}, not a {kind}")
        return entry

    def exists(self, name: str) -> bool:
        return self._live_lookup(name) is not None

    def delete(self, name: str) -> bool:
        """Drop ``name``: detach, then zero, then free the row, so only one
        concurrent deleter (a user, the sweeper, a lazy expiry) wins and
        the row is reusable only once clean.  An expired but unswept
        entry is freed too, but reports False (Redis DEL on an expired
        key)."""
        entry = self.registry.detach(name)
        if entry is None:
            return False
        was_expired = entry.expire_at is not None and time.time() >= entry.expire_at
        self._drain()
        self._reap_row(entry.pool, entry.row)
        self.topk.drop(name)
        return not was_expired

    def rename(self, old: str, new: str) -> bool:
        """RENAME: False (nothing changes) when ``old`` is missing or
        expired.  Queued ops are drained first: queued bitset ops resolve
        their row by entry at flush time, and must land before the names
        move.  A displaced destination's row is zeroed before reuse."""
        if old == new or self._live_lookup(old) is None:
            return False
        self._drain()
        ok, dest = self.registry.rename_detach_dest(old, new)
        if not ok:  # the source expired since the check
            return False
        if dest is not None:
            self._reap_row(dest.pool, dest.row)
        self.topk.rename(old, new)
        return True

    def names(self, kind=None) -> list:
        for e in self.registry.entries():
            if e.expire_at is not None:
                self._expire_if_due(e)
        return self.registry.names(kind)

    def _require(self, name: str, kind: str):
        entry = self._lookup_kind(name, kind)
        if entry is None:
            raise RuntimeError(f"{kind} object {name!r} is not initialized")
        return entry

    # -- bloom -------------------------------------------------------------

    def bloom_try_init(self, name, expected_insertions, false_probability) -> bool:
        m = golden.optimal_num_of_bits(expected_insertions, false_probability)
        k = golden.optimal_num_of_hash_functions(expected_insertions, m)
        params = {
            "size": m,
            "hash_iterations": k,
            "expected_insertions": expected_insertions,
            "false_probability": false_probability,
        }
        self._live_lookup(name)  # reap an expired holder before tryInit
        _, created = self.registry.try_create(
            name, PoolKind.BLOOM, (class_words_for_bits(m),), params
        )
        return created

    def bloom_count(self, name) -> LazyResult:
        entry = self._require(name, PoolKind.BLOOM)
        self._drain()
        return self.executor.bloom_count(
            entry.pool, entry.row, entry.params["size"], entry.params["hash_iterations"]
        )

    def bloom_replicate(self, name: str) -> bool:
        """Read replication spreads a filter's row over mesh shards; one
        card has nothing to spread over, so this is False (the JAX
        engine's answer at one shard)."""
        return False

    def bloom_is_replicated(self, name: str) -> bool:
        entry = self._lookup_kind(name, PoolKind.BLOOM)
        return bool(entry is not None and entry.replica_rows)

    def _runs_dispatch(self, pool, k):
        """Flush-time dispatch for the run-length mixed path: folds the
        segment's per-chunk metas into per-RUN arrays (row, m, is_add once
        per chunk + cumulative starts) and ships them with the
        concatenated key blocks.  Key lengths collapse to one scalar when
        every chunk is const-length."""

        def dispatch(cols, metas):
            C = len(metas)
            run_rows = np.empty(C, np.int32)
            run_m = np.empty(C, np.uint32)
            run_flags = np.empty(C, np.bool_)
            starts = np.zeros(C + 1, np.int32)
            const_val = None
            all_const = True
            for i, (nops, (row, m, flag, ln)) in enumerate(metas):
                run_rows[i] = row
                run_m[i] = m
                run_flags[i] = flag
                starts[i + 1] = starts[i] + nops
                if isinstance(ln, (int, np.integer)):
                    if const_val is None:
                        const_val = int(ln)
                    elif const_val != int(ln):
                        all_const = False
                else:
                    all_const = False
            if all_const:
                lengths = np.uint32(0 if const_val is None else const_val)
            else:
                lengths = np.concatenate([
                    np.full(nops, ln, np.uint32)
                    if isinstance(ln, (int, np.integer))
                    else np.asarray(ln, np.uint32)
                    for nops, (_, _, _, ln) in metas
                ])
            if C > 1024:
                # A degenerate many-tiny-chunk segment expands its runs on
                # the host and takes the per-op path, as in the JAX engine
                # (which caps its compiled run-table size at 1024).
                counts = np.diff(starts)
                if np.ndim(lengths) == 0:
                    lengths = np.full(int(starts[-1]), lengths, np.uint32)
                return self.executor.bloom_mixed_keys(
                    pool, np.repeat(run_rows, counts), np.repeat(run_m, counts),
                    k, cols[0], lengths, np.repeat(run_flags, counts),
                )
            return self.executor.bloom_mixed_keys_runs(
                pool, k, cols[0], lengths, run_rows, run_m, run_flags, starts
            )

        return dispatch

    def _bloom_submit_mixed_keys(self, entry, blocks, lengths, is_add):
        """Device-hash path: raw codec lanes ride the mixed kernel, so
        producer threads never hash.  ``is_add`` is a scalar for uniform
        batches or a per-op bool array for an ordered add/contains mix;
        uniform coalesced batches ride the run-length path.  The lane
        count is part of the segment key, so concatenated chunks agree on
        shape."""
        m, k = entry.params["size"], entry.params["hash_iterations"]
        pool = entry.pool
        B, L = blocks.shape
        lengths = np.asarray(lengths, np.uint32)
        uniform = np.ndim(is_add) == 0
        if self.coalescer is not None and uniform:
            if lengths.ndim == 0:
                len_meta = int(lengths)
            else:
                const = B > 0 and bool(np.all(lengths == lengths[0]))
                len_meta = int(lengths[0]) if const else lengths
            return self._submit(
                ("bloom_mixkr", id(pool), k, L),
                self._runs_dispatch(pool, k),
                (blocks,),
                B,
                pool_key=id(pool),
                meta=(entry.row, m, bool(is_add), len_meta),
            )
        lengths = np.broadcast_to(lengths, (B,))
        flags = np.full(B, bool(is_add)) if uniform else np.asarray(is_add, bool)
        rows = np.full(B, entry.row, np.int32)
        m_arr = np.full(B, m, np.uint32)
        if self.coalescer is not None:
            return self._submit(
                ("bloom_mixk", id(pool), k, L),
                lambda cols: self.executor.bloom_mixed_keys(
                    pool, cols[0], cols[1], k, cols[2], cols[3], cols[4]
                ),
                (rows, m_arr, blocks, lengths, flags),
                B,
                pool_key=id(pool),
            )
        return self.executor.bloom_mixed_keys(
            pool, rows, m_arr, k, blocks, lengths, flags
        )

    def bloom_add_encoded(self, name, blocks, lengths):
        entry = self._require(name, PoolKind.BLOOM)
        if self.config.gpu_sketch.exact_add_semantics:
            return self._bloom_submit_mixed_keys(entry, blocks, lengths, True)
        m, k = entry.params["size"], entry.params["hash_iterations"]
        self._drain()
        return self.executor.bloom_add_keys_st(
            entry.pool, entry.row, m, k, blocks,
            np.broadcast_to(np.asarray(lengths, np.uint32), (blocks.shape[0],)),
        )

    def bloom_contains_encoded(self, name, blocks, lengths):
        entry = self._require(name, PoolKind.BLOOM)
        if self.coalescer is not None:
            return self._bloom_submit_mixed_keys(entry, blocks, lengths, False)
        m, k = entry.params["size"], entry.params["hash_iterations"]
        return self.executor.bloom_contains_keys_st(
            entry.pool, entry.row, m, k, blocks,
            np.broadcast_to(np.asarray(lengths, np.uint32), (blocks.shape[0],)),
        )

    def bloom_mixed_encoded(self, name, blocks, lengths, flags):
        """One ordered add/contains mix on one filter as ONE engine call;
        per-op results come back in command order."""
        flags = np.asarray(flags, bool)
        if not flags.any():
            return self.bloom_contains_encoded(name, blocks, lengths)
        if flags.all():
            return self.bloom_add_encoded(name, blocks, lengths)
        entry = self._require(name, PoolKind.BLOOM)
        return self._bloom_submit_mixed_keys(entry, blocks, lengths, flags)

    # -- hll ---------------------------------------------------------------

    def hll_ensure(self, name):
        self._live_lookup(name)  # reap an expired holder first
        entry, _ = self.registry.try_create(name, PoolKind.HLL, (), {})
        return entry

    def hll_add(self, name, c0, c1, c2):
        """PFADD of host-hashed lanes; the result is True iff a register
        grew.  Coalesced: one segment per HLL pool, per-op changed flags
        reduced with ``any``."""
        entry = self.hll_ensure(name)
        if self.coalescer is not None:
            pool = entry.pool
            rows = np.full(len(c0), entry.row, np.int32)
            fut = self._submit(
                ("hll_add", id(pool)),
                lambda cols: self.executor.hll_add_changed(
                    pool, cols[0], cols[1], cols[2], cols[3]
                ),
                (rows, c0, c1, c2),
                len(c0),
                pool_key=id(pool),
            )
            return MappedFuture(fut, lambda v: bool(np.any(v)))
        return self.executor.hll_add_single(entry.pool, entry.row, c0, c1, c2)

    def hll_add_encoded(self, name, blocks, lengths):
        """PFADD of raw codec lanes: without the coalescer the device
        hashes them (``hll_add_keys_single``); with it, the host does."""
        if self.coalescer is None:
            entry = self.hll_ensure(name)
            return self.executor.hll_add_keys_single(
                entry.pool, entry.row, blocks,
                np.broadcast_to(np.asarray(lengths, np.uint32), (blocks.shape[0],)),
            )
        c0, c1, c2, _ = hashing.murmur3_x86_128(blocks, lengths)
        return self.hll_add(name, c0, c1, c2)

    def hll_count(self, name):
        entry = self._lookup_kind(name, PoolKind.HLL)
        if entry is None:
            return ImmediateResult(0)
        self._drain()
        return self.executor.hll_count(entry.pool, entry.row)

    def hll_count_with(self, name, other_names) -> int:
        """PFCOUNT over several keys (the union's cardinality) without
        changing any: host max of the rows (16 KiB each), then the
        histogram and the Ertl estimate."""
        entries = [self._lookup_kind(n, PoolKind.HLL) for n in (name, *other_names)]
        entries = [e for e in entries if e is not None]
        if not entries:
            return 0
        self._drain()
        regs = None
        for e in entries:
            r = self.executor.read_row(e.pool, e.row)
            regs = r if regs is None else np.maximum(regs, r)
        hist = np.bincount(regs, minlength=golden.HLL_Q + 2)
        return int(round(golden.ertl_estimate(hist)))

    def hll_merge_with(self, name, other_names) -> None:
        """PFMERGE: this = max(this, sources)."""
        entry = self.hll_ensure(name)
        srcs = [e for e in (self._lookup_kind(n, PoolKind.HLL) for n in other_names)
                if e is not None]
        if not srcs:
            return
        self._drain()
        self.executor.hll_merge(entry.pool, entry.row, [e.row for e in srcs])

    # -- bitset ------------------------------------------------------------

    def _bitset_entry_with_capacity(self, name, min_bits: int):
        """Placement only: create the bitset, or migrate it to a size class
        that holds ``min_bits``, without extending its logical length
        (BITOP operands keep their true lengths)."""
        self._live_lookup(name)  # reap an expired holder first
        entry, created = self.registry.try_create(
            name, PoolKind.BITSET, (class_words_for_bits(min_bits),), {"nbits": 0}
        )
        if not created:
            self._bitset_grow(entry, min_bits)
        return entry

    def bitset_ensure(self, name, min_bits: int = 1):
        entry = self._bitset_entry_with_capacity(name, min_bits)
        # Logical length: Redis string-length semantics (SETBIT grows the
        # value to cover the highest index ever touched).
        entry.params["nbits"] = max(entry.params.get("nbits", 0), int(min_bits))
        return entry

    def _bitset_grow(self, entry, min_bits: int) -> None:
        """Auto-grow of Redis bitmaps: migrate the tenant to a larger size
        class."""
        need_words = class_words_for_bits(min_bits)
        if need_words > entry.pool.row_units:
            self._bitset_migrate(entry, need_words)

    def _bitset_migrate(self, entry, need_words: int) -> None:
        """Copy the row into a row of the larger class on the device, then
        zero and free the old row, all under the dispatch lock, so no
        flush applies ops to the old row in between.  Queued ops resolve
        their row at flush time (``_bitset_submit_mixed``), so they follow
        the move."""
        self._drain()
        while True:
            old_pool, old_row = entry.pool, entry.row
            new_pool = self.registry.pool_for(PoolKind.BITSET, (need_words,))
            with self.executor._dispatch_lock:
                if entry.pool is not old_pool or entry.row != old_row:
                    # A concurrent grow moved the entry first.
                    if entry.pool.row_units >= need_words:
                        return
                    continue
                new_row = new_pool.alloc_row()
                self.executor.copy_row(old_pool, old_row, new_pool, new_row)
                self.executor.zero_row(old_pool, old_row)
                old_pool.free_row(old_row)
                entry.pool, entry.row = new_pool, new_row
                return

    def bitset_capacity_bits(self, name) -> int:
        entry = self._lookup_kind(name, PoolKind.BITSET)
        return 0 if entry is None else entry.pool.row_units * 32

    def _bitset_dispatch_group(self, pool, gidx, runs):
        """One resolved-placement group of a mixed-bit segment -> one
        launch: the run-length form up to 1024 runs (the JAX package's
        run-table size), per-op arrays above that."""
        if len(runs) <= 1024:
            run_rows = np.array([r for _, r, _ in runs], np.int32)
            run_ops = np.array([o for _, _, o in runs], np.uint32)
            starts = np.zeros(len(runs) + 1, np.int32)
            starts[1:] = np.cumsum([n for n, _, _ in runs])
            return self.executor.bitset_mixed_runs(pool, gidx, run_rows, run_ops, starts)
        rows = np.concatenate([np.full(n, r, np.int32) for n, r, _ in runs])
        ops_col = np.concatenate([np.full(n, o, np.uint32) for n, _, o in runs])
        return self.executor.bitset_mixed(pool, rows, gidx, ops_col)

    def _bitset_submit_mixed(self, entry, idx, opcode: int):
        """Coalesced path: every single-bit opcode rides ONE segment per
        pool through the affine op (exact sequential semantics), so
        interleaved set/clear/flip/get never fragment.

        Placement resolves at FLUSH time, under the dispatch lock, from
        the per-chunk metas: a migration committing while ops sit queued
        repoints the entry, and rows fixed at submit would land writes in
        the old, freed row."""

        def dispatch(cols, metas):
            with self.executor._dispatch_lock:  # atomic vs a migration commit
                # Consecutive chunks grouped by their resolved pool (more
                # than one group only when a migration committed
                # mid-segment); op order is kept.
                groups = []  # [pool, runs, lo, hi]
                off = 0
                for nops, (e, op) in metas:
                    if groups and groups[-1][0] is e.pool:
                        groups[-1][1].append((nops, e.row, op))
                        groups[-1][3] = off + nops
                    else:
                        groups.append([e.pool, [(nops, e.row, op)], off, off + nops])
                    off += nops
                results = [
                    self._bitset_dispatch_group(pool, cols[0][lo:hi], runs)
                    for pool, runs, lo, hi in groups
                ]
            return results[0] if len(results) == 1 else _ConcatLazy(results)

        return self._submit(
            ("bs_mix", id(entry.pool)),
            dispatch,
            (np.asarray(idx, np.uint32),),
            len(idx),
            pool_key=id(entry.pool),
            meta=(entry, opcode),
        )

    def _bitset_rw(self, opcode: int, method, entry, idx):
        if self.coalescer is not None:
            return self._bitset_submit_mixed(entry, idx, opcode)
        # Placement and dispatch atomic vs a concurrent migration.
        with self.executor._dispatch_lock:
            rows = np.full(len(idx), entry.row, np.int32)
            return method(entry.pool, rows, idx)

    def bitset_set(self, name, idx, value: bool):
        """SETBIT of every index to ``value``; previous bit per op."""
        idx = np.asarray(idx, np.uint32)
        entry = self.bitset_ensure(name, int(idx.max()) + 1 if idx.size else 1)
        if value:
            return self._bitset_rw(bitset_ops.OP_SET, self.executor.bitset_set, entry, idx)
        return self._bitset_rw(
            bitset_ops.OP_CLEAR, self.executor.bitset_clear_bits, entry, idx
        )

    def bitset_flip(self, name, idx):
        idx = np.asarray(idx, np.uint32)
        entry = self.bitset_ensure(name, int(idx.max()) + 1 if idx.size else 1)
        return self._bitset_rw(bitset_ops.OP_FLIP, self.executor.bitset_flip, entry, idx)

    def bitset_get(self, name, idx):
        """GETBIT; an index past the row's capacity reads 0 (it is sent as
        index 0 and its result masked)."""
        idx = np.asarray(idx, np.uint32)
        entry = self._lookup_kind(name, PoolKind.BITSET)
        if entry is None:
            return ImmediateResult(np.zeros(len(idx), bool))
        in_range = idx < entry.pool.row_units * 32
        safe_idx = np.where(in_range, idx, 0).astype(np.uint32)
        if self.coalescer is not None:
            fut = self._bitset_submit_mixed(entry, safe_idx, bitset_ops.OP_GET)
            return MappedFuture(fut, lambda v: v & in_range)
        rows = np.full(len(idx), entry.row, np.int32)
        res = self.executor.bitset_get(entry.pool, rows, safe_idx)
        return MappedFuture(res, lambda v: v & in_range)

    def bitset_set_range(self, name, from_bit, to_bit, value: bool):
        entry = self.bitset_ensure(name, int(to_bit))
        self._drain()
        return self.executor.bitset_set_range(
            entry.pool, entry.row, int(from_bit), int(to_bit), value
        )

    def _bitset_scalar(self, name, empty: int, method, *args) -> int:
        entry = self._lookup_kind(name, PoolKind.BITSET)
        if entry is None:
            return empty
        self._drain()
        return int(method(entry.pool, entry.row, *args).result())

    def bitset_cardinality(self, name) -> int:
        return self._bitset_scalar(name, 0, self.executor.bitset_cardinality)

    def bitset_length(self, name) -> int:
        return self._bitset_scalar(name, 0, self.executor.bitset_length)

    def bitset_bitpos(self, name, target_bit: int) -> int:
        return self._bitset_scalar(
            name, -1 if target_bit else 0, self.executor.bitset_bitpos, target_bit
        )

    def bitset_bitop(self, dest: str, src_names, op: str) -> None:
        """BITOP dest = op(srcs).  Every operand (dest included) is grown
        into one size class first, so their rows share a pool.  Redis
        semantics: dest is replaced, and the result's length is the
        longest source's; unary NOT complements the source's whole
        byte-aligned string and is masked there, so the row's tail bits
        stay 0."""
        max_bits = max(
            (self.bitset_capacity_bits(n) for n in (dest, *src_names)), default=0
        ) or 32 * 32
        dst = self._bitset_entry_with_capacity(dest, max_bits)
        srcs, src_nbits = [], []
        for n in src_names:
            e = self._bitset_entry_with_capacity(n, max_bits)
            srcs.append(e.row)
            src_nbits.append(e.params.get("nbits", 0))
        nbits = -(-src_nbits[0] // 8) * 8 if op == "not" else max(src_nbits, default=0)
        self._drain()
        self.executor.bitset_bitop(
            dst.pool, dst.row, srcs, op, limit_bits=nbits if op == "not" else None
        )
        dst.params["nbits"] = nbits

    def bitset_to_bytes(self, name) -> bytes:
        """The row's bytes trimmed to the logical length (Redis STRLEN
        semantics), so both packages return identical bytes."""
        entry = self._lookup_kind(name, PoolKind.BITSET)
        if entry is None:
            return b""
        nbytes = -(-entry.params.get("nbits", 0) // 8)
        self._drain()
        return self.executor.read_row(entry.pool, entry.row).tobytes()[:nbytes]

    # -- cms ---------------------------------------------------------------

    def cms_try_init(self, name, depth: int, width: int) -> bool:
        self._live_lookup(name)  # reap an expired holder before tryInit
        _, created = self.registry.try_create(
            name, PoolKind.CMS, (depth, width),
            {"depth": depth, "width": width},
        )
        return created

    def cms_total(self, name) -> int:
        """Total inserted weight: every increment adds its weight to one
        cell per depth row, so row 0's sum is the total."""
        entry = self._require(name, PoolKind.CMS)
        self._drain()
        row = self.executor.read_row(entry.pool, entry.row)
        return int(np.asarray(row[: entry.params["width"]], np.uint64).sum())

    def cms_reset(self, name) -> None:
        """Zero a CMS's counters in place; the object and its top-K
        configuration stay."""
        entry = self._require(name, PoolKind.CMS)
        self._drain()
        self.executor.zero_row(entry.pool, entry.row)

    def cms_merge(self, name, other_names) -> None:
        """CMS.MERGE: this += each source, counter for counter (mod 2**32);
        every source must share this sketch's geometry."""
        entry = self._require(name, PoolKind.CMS)
        srcs = []
        for n in other_names:
            e = self._require(n, PoolKind.CMS)
            if (e.params["depth"], e.params["width"]) != (
                entry.params["depth"], entry.params["width"]
            ):
                raise ValueError("cannot merge CMS with different geometry")
            srcs.append(e)
        if not srcs:
            return
        self._drain()
        self.executor.cms_merge(entry.pool, entry.row, [e.row for e in srcs])

    def cms_add(self, name, H1, H2, weights):
        entry = self._require(name, PoolKind.CMS)
        d, w = entry.params["depth"], entry.params["width"]
        h1w, h2w = hashing.km_reduce_mod(H1, H2, w)
        rows = np.full(len(H1), entry.row, np.int32)
        wts = np.asarray(weights, np.uint32)
        if self.coalescer is not None:
            # Updates and estimates share one segment per (pool, d, w);
            # estimate ops ride with weight 0.
            pool = entry.pool
            return self._submit(
                ("cms_mix", id(pool), d, w),
                lambda cols: self.executor.cms_update_estimate(
                    pool, cols[0], cols[1], cols[2], cols[3], d, w
                ),
                (rows, h1w, h2w, wts),
                len(H1),
                pool_key=id(pool),
            )
        return self.executor.cms_update_estimate(
            entry.pool, rows, h1w, h2w, wts, d, w
        )

    def cms_estimate(self, name, H1, H2):
        entry = self._require(name, PoolKind.CMS)
        d, w = entry.params["depth"], entry.params["width"]
        h1w, h2w = hashing.km_reduce_mod(H1, H2, w)
        rows = np.full(len(H1), entry.row, np.int32)
        if self.coalescer is not None:
            pool = entry.pool
            return self._submit(
                ("cms_mix", id(pool), d, w),
                lambda cols: self.executor.cms_update_estimate(
                    pool, cols[0], cols[1], cols[2], cols[3], d, w
                ),
                (rows, h1w, h2w, np.zeros(len(H1), np.uint32)),
                len(H1),
                pool_key=id(pool),
            )
        return self.executor.cms_estimate(entry.pool, rows, h1w, h2w, d, w)

    def cms_add_seq(self, name, H1, H2, weights):
        """Streaming add+estimate via kernel K1: op j's estimate is its
        at-sequence-point value.  Falls back to the vectorized path (whose
        estimates include the whole batch) in exactly the JAX engine's
        cases: no sequential kernel, ``(d*w) % 128 != 0``,
        ``d*w*4 > 8 MiB``, or an empty batch.  K1 itself has none of these
        limits; the gate keeps both packages' answers the same."""
        entry = self._require(name, PoolKind.CMS)
        d, w = entry.params["depth"], entry.params["width"]
        if (
            not self.executor.supports_seq_cms
            or (d * w) % 128 != 0
            or d * w * 4 > (8 << 20)
            or len(H1) == 0
        ):
            return self.cms_add(name, H1, H2, weights)
        h1w, h2w = hashing.km_reduce_mod(H1, H2, w)
        weights = np.asarray(weights, np.uint32)
        self._drain()  # sequential semantics: all queued ops land first
        B = len(h1w)
        if B <= self._SEQ_CHUNK:
            return self.executor.cms_update_estimate_seq(
                entry.pool, entry.row, h1w, h2w, weights, d, w
            )
        parts = [
            self.executor.cms_update_estimate_seq(
                entry.pool, entry.row,
                h1w[i : i + self._SEQ_CHUNK],
                h2w[i : i + self._SEQ_CHUNK],
                weights[i : i + self._SEQ_CHUNK],
                d, w,
            )
            for i in range(0, B, self._SEQ_CHUNK)
        ]
        return ImmediateResult(
            np.concatenate([np.asarray(p.result()) for p in parts])
        )
