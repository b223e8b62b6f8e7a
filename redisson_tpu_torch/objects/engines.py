"""TorchSketchEngine — the backend behind BloomFilter and CountMinSketch.

Counterpart of ``TpuSketchEngine`` in ``redisson_tpu/objects/engines.py``
for this package's slice: tenant registry + size-class pools +
TorchCommandExecutor, with the BatchCoalescer in front when
``coalesce`` is on.  The routing and the ops each call becomes follow
the JAX engine, so both packages return the same answers and hold the
same pool bytes.  The journal, near cache, degraded mirrors, residency
tiers and replicas are not part of this slice.
"""

from __future__ import annotations

import heapq
import threading

import numpy as np

from redisson_tpu_torch.executor.coalescer import BatchCoalescer, HintedFuture
from redisson_tpu_torch.executor.torch_executor import (
    LazyResult,
    TorchCommandExecutor,
)
from redisson_tpu_torch.ops import golden
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

    def candidates(self, name: str) -> list:
        with self._lock:
            t = self._tables.get(name)
            return [] if t is None else list(t["cands"])


class TorchSketchEngine:
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

    def shutdown(self) -> None:
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

    def params(self, name: str):
        entry = self.registry.lookup(name)
        return None if entry is None else entry.params

    def _require(self, name: str, kind: str):
        entry = self.registry.lookup(name)
        if entry is None:
            raise RuntimeError(f"{kind} object {name!r} is not initialized")
        if entry.kind != kind:
            raise TypeError(f"object {name!r} holds a {entry.kind}, not a {kind}")
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
        _, created = self.registry.try_create(
            name, PoolKind.BLOOM, (class_words_for_bits(m),), params
        )
        return created

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

    # -- cms ---------------------------------------------------------------

    def cms_try_init(self, name, depth: int, width: int) -> bool:
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
