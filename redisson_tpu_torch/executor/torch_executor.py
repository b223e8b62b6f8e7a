"""TorchCommandExecutor — the device boundary of the sketch engine.

Counterpart of ``redisson_tpu/executor/tpu_executor.py``:

- pool state is one flat tensor per size class on the executor's
  ``torch.device`` in the JAX package's layout: uint32 words held as
  int32 bit-views, or uint8 HyperLogLog registers (``state_to_host``
  returns identical bytes);
- op batches are padded to power-of-two buckets (``_bucket``) and packed
  into ONE host block per flush, copied to the device in one H2D
  (pinned memory on CUDA);
- kernels update pool state in place under the dispatch lock;
- results come back as ``LazyResult``: a device tensor plus a transform,
  copied to the host on ``.result()``.

PyTorch runs eagerly, so there is no compile cache; bucketing is kept
because padded ops are part of the semantics the JAX package defines
(they are routed to the scratch word and leave every tenant row alone).
"""

from __future__ import annotations

import functools
import math
import threading
from typing import Optional

import numpy as np
import torch

from redisson_tpu_torch.ops import (
    bitops,
    bloom as bloom_ops,
    bitset as bitset_ops,
    cms as cms_ops,
    cms_seq,
    fastpath,
    golden,
    hll as hll_ops,
)

# Ops per pass of the single-tenant keyed paths.  The non-exact add takes
# its newly-added flags against the state before each pass, so the pass
# size is part of its semantics (the JAX package scans chunks of this
# size, making flags chunk-sequential); it also bounds temporaries.
_SCAN_CHUNK = 1 << 20


class LazyResult:
    """Async result handle (RFuture analog): holds a device tensor;
    copies it to the host, slices off padding and applies ``transform``
    only on ``.result()``."""

    def __init__(self, value, n: Optional[int] = None, transform=None):
        self._value = value
        self._n = n
        self._transform = transform
        self._done = None

    def result(self, timeout=None):
        # ``timeout`` accepted for signature parity with the coalescer's
        # HintedFuture; a tensor fetch is synchronous.
        if self._done is None:
            v = self._value
            if isinstance(v, torch.Tensor):
                v = v.cpu().numpy()
            self.resolve_from(v)
        return self._done

    def resolve_from(self, host):
        """Resolve with an already-fetched host copy (collect_group)."""
        if self._done is None:
            v = host
            if self._n is not None:
                v = v[: self._n]
            if self._transform is not None:
                v = self._transform(v)
            self._done = v
            self._value = None
        return self._done

    def get(self):
        return self.result()

    def done(self) -> bool:
        return self._done is not None


def bloom_count_from_bitcount(x, m: int, k: int) -> int:
    """BITCOUNT inversion n = -m/k * ln(1 - X/m) (RedissonBloomFilter#count),
    rounded with Python ``round`` and ``m`` once every bit is set, so the
    integer equals the JAX package's."""
    x = int(x)
    if x >= m:
        return m
    return int(round(-m / k * math.log(1 - x / m)))


def _pow2ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _as_u32(v: np.ndarray) -> np.ndarray:
    return v.view(np.uint32)


def _fill_words(buf, off: int, n_pad: int, arr, dtype, fill=0) -> int:
    """Write ``arr`` into buf[off:off+n_pad] viewed as a 4-byte ``dtype``,
    padding the tail with ``fill``; returns the next offset."""
    view = buf[off : off + n_pad].view(dtype)
    n = arr.shape[0]
    view[:n] = arr
    view[n:] = fill
    return off + n_pad


def _fill_bits(buf, off: int, n_pad: int, flags) -> int:
    """Pack a bool column at 1 bit per op (zero-padded); returns the next
    offset."""
    nw = n_pad >> 5
    words = bitops.host_pack_bool_u32(np.asarray(flags, bool))
    view = buf[off : off + nw]
    view[: words.shape[0]] = words
    view[words.shape[0]:] = 0
    return off + nw


def _fill_blocks(buf, off: int, n_pad: int, blocks) -> int:
    """Write a [B, L] uint32 lane block, zero-padded to [n_pad, L]."""
    B, L = blocks.shape
    view = buf[off : off + n_pad * L].reshape(n_pad, L)
    view[:B] = blocks
    view[B:] = 0
    return off + n_pad * L


def _trim_lanes(blocks):
    """Drop trailing all-zero lane columns before the H2D copy (the
    kernel rebuilds them, fastpath.pad_lanes); returns (trimmed, lanes)."""
    L = blocks.shape[1]
    used = L
    while used > 1 and not np.any(blocks[:, used - 1]):
        used -= 1
    return blocks[:, :used], L


def _locked(fn):
    """Serialize a dispatch method on the executor's dispatch lock: every
    method that reads or updates pool state in place, and pool growth."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._dispatch_lock:
            return fn(self, *args, **kwargs)

    return wrapper


class TorchCommandExecutor:
    """Owns the device, the pool-state layout and every kernel launch."""

    # Sequential CMS (ops/cms_seq.py) runs on every device this executor
    # supports: CUDA launches the K1 kernel, the CPU its plain version.
    supports_seq_cms = True

    def __init__(self, config):
        self._cfg = config.gpu_sketch
        self.device = torch.device(self._cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "use_gpu_sketch(device='cuda') but torch sees no CUDA device; "
                "pass device='cpu' to run on the CPU"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self._dispatch_lock = threading.RLock()

    # -- pool-state factory ------------------------------------------------

    def round_capacity(self, capacity: int, row_units: int = 0) -> int:
        # Giant rows: cap the initial footprint at 2**27 words and let
        # doubling growth take over (the JAX package's rule, so both hold
        # pools of the same shape).
        if row_units and capacity * row_units > (1 << 27):
            return max(1, (1 << 27) // row_units)
        return capacity

    @staticmethod
    def _torch_dtype(dtype):
        """Device element type of a pool spec's numpy dtype: uint8
        registers stay uint8; uint32 words are held as int32 bit-views."""
        return torch.uint8 if np.dtype(dtype) == np.uint8 else torch.int32

    @staticmethod
    def _host_view(t: torch.Tensor) -> np.ndarray:
        """A host copy of pool elements in the JAX package's dtype."""
        a = t.cpu().numpy()
        return (a if a.dtype == np.uint8 else _as_u32(a)).copy()

    def _to_device(self, pool, data: np.ndarray) -> torch.Tensor:
        if self._torch_dtype(pool.spec.dtype) == torch.uint8:
            host = np.ascontiguousarray(data, dtype=np.uint8)
        else:
            host = np.ascontiguousarray(data, dtype=np.uint32).view(np.int32)
        return torch.from_numpy(host.copy()).to(self.device)

    def make_pool_state(self, capacity: int, row_units: int, dtype=np.uint32):
        """Flat [capacity*row_units + 1]; trailing scratch element."""
        return torch.zeros(capacity * row_units + 1, dtype=self._torch_dtype(dtype),
                           device=self.device)

    def grow_pool_state(self, state, old_cap: int, new_cap: int, row_units: int):
        extra = torch.zeros((new_cap - old_cap) * row_units + 1,
                            dtype=state.dtype, device=self.device)
        # state[:-1] drops the old scratch element; extra brings the new one.
        return torch.cat([state[:-1], extra])

    @_locked
    def state_to_host(self, pool) -> np.ndarray:
        """The pool's elements, byte-identical to the JAX executor's."""
        return self._host_view(pool.state)

    @_locked
    def state_from_host(self, pool, arr: np.ndarray) -> None:
        pool.state = self._to_device(pool, arr)

    @_locked
    def read_row(self, pool, row: int) -> np.ndarray:
        return self._host_view(bitops.row_slice(pool.state, row, pool.row_units))

    @_locked
    def write_row(self, pool, row: int, data: np.ndarray) -> None:
        bitops.row_update(pool.state, row, self._to_device(pool, data), pool.row_units)

    @_locked
    def zero_row(self, pool, row: int) -> None:
        """Clear a tenant row (delete, and the old row of a migration)."""
        bitops.row_slice(pool.state, row, pool.row_units).zero_()

    @_locked
    def copy_row(self, src_pool, src_row: int, dst_pool, dst_row: int) -> None:
        """dst row = src row zero-padded to the dst row's width, on the
        device (a bitset's size-class migration)."""
        src = bitops.row_slice(src_pool.state, src_row, src_pool.row_units)
        dst = bitops.row_slice(dst_pool.state, dst_row, dst_pool.row_units)
        dst[: src.shape[0]].copy_(src)
        dst[src.shape[0]:].zero_()

    # -- staging -------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        # 32-divisibility: boolean results leave the device packed
        # 32 per word, so the floor and a user-set min_bucket round up to
        # a multiple of 32.
        mb = -(-max(32, self._cfg.min_bucket) // 32) * 32
        return max(mb, _pow2ceil(max(1, n)))

    def _staging(self, nwords: int):
        """(uint32 numpy view, int32 host tensor) of ``nwords``: pinned on
        CUDA, so the one copy per flush is asynchronous.  PyTorch's host
        allocator keeps a pinned block out of reuse until the copy that
        read it has completed."""
        host = torch.empty(nwords, dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")
        return _as_u32(host.numpy()), host

    def _ship(self, host: torch.Tensor) -> torch.Tensor:
        return host.to(self.device, non_blocking=True)

    def collect_group(self, lazies) -> None:
        """Result mailbox: results of one (dtype, shape) are concatenated
        on the device and fetched with ONE D2H, then each LazyResult
        resolves from its slice.  Other items resolve on their own
        ``.result()``."""
        by_sig: dict = {}
        for lz in lazies:
            v = getattr(lz, "_value", None)
            if getattr(lz, "_done", 1) is None and isinstance(v, torch.Tensor):
                by_sig.setdefault((v.dtype, tuple(v.shape)), []).append(lz)
        for (_dtype, shape), group in by_sig.items():
            if len(group) < 2:
                continue
            flat = torch.cat([lz._value.reshape(-1) for lz in group]).cpu().numpy()
            n = int(np.prod(shape))
            for i, lz in enumerate(group):
                lz.resolve_from(flat[i * n : (i + 1) * n].reshape(shape).copy())

    # -- bloom ---------------------------------------------------------------

    def _result_bits(self, res: torch.Tensor, B: int) -> LazyResult:
        return LazyResult(
            bitops.pack_bool_u32(res),
            transform=lambda v: bitops.unpack_bool_u32(v, B),
        )

    @_locked
    def bloom_mixed_keys(self, pool, rows, m_arr, k: int, blocks, lengths, is_add) -> LazyResult:
        """Combined add+contains from raw codec lanes with per-op rows, m
        and flags: device hash + the exact sequential mixed op."""
        B = blocks.shape[0]
        Bp = self._bucket(B)
        blocks, L = _trim_lanes(blocks)
        Lt = blocks.shape[1]
        Wb = Bp >> 5
        total = 3 * Bp + Wb + Bp * Lt
        buf, host = self._staging(total)
        o = _fill_words(buf, 0, Bp, np.asarray(rows, np.int32), np.int32)
        o = _fill_words(buf, o, Bp, np.asarray(lengths, np.uint32), np.uint32)
        o = _fill_words(buf, o, Bp, np.asarray(m_arr, np.uint32), np.uint32, 1)
        o = _fill_bits(buf, o, Bp, is_add)
        _fill_blocks(buf, o, Bp, blocks)
        packed = self._ship(host)
        o = 3 * Bp
        res = fastpath.bloom_mixed_keys(
            pool.state, packed[:Bp], packed[o + Wb :].view(Bp, Lt),
            packed[Bp : 2 * Bp], packed[2 * Bp : o],
            bitops.unpack_bool_u32_dev(packed[o : o + Wb], Bp),
            self._valid(Bp, B),
            k=k, words_per_row=pool.row_units, target_lanes=L,
        )
        return self._result_bits(res, B)

    @_locked
    def bloom_mixed_keys_runs(self, pool, k: int, blocks, lengths, run_rows, run_m, run_flags, run_starts) -> LazyResult:
        """Coalesced mixed path with run-length metadata: rows, m and the
        add flag are constant within each submitted chunk, so they ship
        once per run (C entries + C+1 cumulative starts) and expand to
        per-op tensors on the device with ``searchsorted``.  ``lengths``:
        a uint32 scalar when every op shares one key length, else per op.
        ``run_starts[C]`` is the number of real ops; the rest is padding.

        Runs are padded to ``Cp`` entries (row 0, m 1, contains) as in the
        JAX package: padded ops take run ``Cp - 1``, so the scratch word
        ends up with the same bits in both."""
        B = int(run_starts[-1])
        Bp = self._bucket(B)
        blocks, L = _trim_lanes(blocks)
        Lt = blocks.shape[1]
        C = len(run_rows)
        Cp = max(1024, _pow2ceil(C))
        Wc = Cp >> 5
        const_len = np.ndim(lengths) == 0
        total = 1 + (Cp + 1) + 2 * Cp + Wc + (0 if const_len else Bp) + Bp * Lt
        buf, host = self._staging(total)
        buf[0] = np.uint32(lengths) if const_len else 0
        sview = buf[1 : Cp + 2].view(np.int32)
        sview[: C + 1] = run_starts
        sview[C + 1 :] = B
        o = _fill_words(buf, Cp + 2, Cp, np.asarray(run_rows, np.int32), np.int32)
        o = _fill_words(buf, o, Cp, np.asarray(run_m, np.uint32), np.uint32, 1)
        o = _fill_bits(buf, o, Cp, run_flags)
        if not const_len:
            o = _fill_words(buf, o, Bp, np.asarray(lengths, np.uint32), np.uint32)
        _fill_blocks(buf, o, Bp, blocks)
        packed = self._ship(host)
        ends = packed[2 : Cp + 2].to(torch.int64)
        o = Cp + 2
        rr = packed[o : o + Cp]
        rm = packed[o + Cp : o + 2 * Cp]
        o += 2 * Cp
        rf = bitops.unpack_bool_u32_dev(packed[o : o + Wc], Cp)
        o += Wc
        if const_len:
            lens = packed[0]
        else:
            lens = packed[o : o + Bp]
            o += Bp
        iota = torch.arange(Bp, dtype=torch.int64, device=self.device)
        # Run of op i = number of run ends <= i, clipped to the last run.
        seg = torch.clamp(torch.searchsorted(ends, iota, right=True), max=Cp - 1)
        res = fastpath.bloom_mixed_keys(
            pool.state, rr[seg], packed[o:].view(Bp, Lt), lens, rm[seg],
            rf[seg], iota < B,
            k=k, words_per_row=pool.row_units, target_lanes=L,
        )
        return self._result_bits(res, B)

    def _keys_block(self, blocks, lengths):
        """Ship [B, Lt] key lanes + per-op lengths in one H2D."""
        B = blocks.shape[0]
        blocks, L = _trim_lanes(blocks)
        Lt = blocks.shape[1]
        buf, host = self._staging(B + B * Lt)
        _fill_words(buf, 0, B, np.asarray(lengths, np.uint32), np.uint32)
        _fill_blocks(buf, B, B, blocks)
        packed = self._ship(host)
        return packed[B:].view(B, Lt), packed[:B], L

    @_locked
    def bloom_contains_keys_st(self, pool, row: int, m: int, k: int, blocks, lengths) -> LazyResult:
        """Single-tenant contains from raw codec lanes, in passes of
        ``_SCAN_CHUNK`` ops."""
        B = blocks.shape[0]
        dblocks, dlens, L = self._keys_block(blocks, lengths)
        res = torch.cat([
            fastpath.bloom_contains_keys_st(
                pool.state, row, dblocks[i : i + _SCAN_CHUNK],
                dlens[i : i + _SCAN_CHUNK], m,
                k=k, words_per_row=pool.row_units, target_lanes=L,
            )
            for i in range(0, B, _SCAN_CHUNK)
        ] or [torch.zeros(0, dtype=torch.bool, device=self.device)])
        return self._result_bits(self._pad_bits(res, B), B)

    @_locked
    def bloom_add_keys_st(self, pool, row: int, m: int, k: int, blocks, lengths) -> LazyResult:
        """Single-tenant bulk add (``exact_add_semantics=False``): flags
        against the state before each pass of ``_SCAN_CHUNK`` ops, so a
        duplicate in a later pass sees the earlier pass's bits."""
        B = blocks.shape[0]
        dblocks, dlens, L = self._keys_block(blocks, lengths)
        parts = []
        for i in range(0, B, _SCAN_CHUNK):
            bl = dblocks[i : i + _SCAN_CHUNK]
            parts.append(fastpath.bloom_add_keys_st(
                pool.state, row, bl, dlens[i : i + _SCAN_CHUNK], m,
                torch.ones(bl.shape[0], dtype=torch.bool, device=self.device),
                k=k, words_per_row=pool.row_units, target_lanes=L,
            ))
        res = torch.cat(parts or [torch.zeros(0, dtype=torch.bool, device=self.device)])
        return self._result_bits(self._pad_bits(res, B), B)

    @_locked
    def bloom_count(self, pool, row: int, m: int, k: int) -> LazyResult:
        """RBloomFilter#count: the row's popcount on the device, inverted
        on the host."""
        x = bloom_ops.bloom_cardinality(pool.state, row, words_per_row=pool.row_units)
        return LazyResult(x, transform=lambda xv: bloom_count_from_bitcount(xv, m, k))

    def _valid(self, Bp: int, n) -> torch.Tensor:
        """bool[Bp]: the first ``n`` ops are real, the rest padding."""
        return torch.arange(Bp, device=self.device) < n

    def _pad_bits(self, res: torch.Tensor, B: int) -> torch.Tensor:
        pad = (-B) % 32
        if pad == 0:
            return res
        return torch.cat([res, torch.zeros(pad, dtype=torch.bool, device=self.device)])

    # -- cms -----------------------------------------------------------------

    def _op_cols(self, Bp: int, *cols):
        """Pack int32/uint32 op columns (zero-padded to Bp) into one H2D.
        Padded CMS ops carry row 0 and weight 0, the scatter-add identity;
        the other callers mask padded ops with ``_valid``."""
        buf, host = self._staging(len(cols) * Bp)
        o = 0
        for c in cols:
            o = _fill_words(buf, o, Bp, np.asarray(c).astype(np.uint32, copy=False), np.uint32)
        packed = self._ship(host)
        return [packed[i * Bp : (i + 1) * Bp] for i in range(len(cols))]

    @_locked
    def cms_update_estimate(self, pool, rows, h1w, h2w, weights, d: int, w: int) -> LazyResult:
        """Coalesced CMS path: updates and estimates share one launch
        (estimates ride with weight 0); estimates are batch-final."""
        B = h1w.shape[0]
        r, a, b, wt = self._op_cols(self._bucket(B), rows, h1w, h2w, weights)
        est = cms_ops.cms_update_and_estimate(
            pool.state, r, a, b, wt, d=d, w=w, cells_per_row=pool.row_units
        )
        return LazyResult(est, B, transform=_as_u32)

    @_locked
    def cms_estimate(self, pool, rows, h1w, h2w, d: int, w: int) -> LazyResult:
        B = h1w.shape[0]
        r, a, b = self._op_cols(self._bucket(B), rows, h1w, h2w)
        est = cms_ops.cms_estimate(
            pool.state, r, a, b, d=d, w=w, cells_per_row=pool.row_units
        )
        return LazyResult(est, B, transform=_as_u32)

    @_locked
    def cms_update_estimate_seq(self, pool, row: int, h1w, h2w, weights, d: int, w: int) -> LazyResult:
        """Streaming update+estimate (kernel K1, ops/cms_seq.py) on one
        tenant.  The JAX executor slices the tenant row out, runs the
        kernel and concatenates the row back; here K1 updates the pool
        IN PLACE through a view at offset ``row*row_units``.  No padding:
        the kernel takes any op count."""
        B = h1w.shape[0]
        a, b, wt = self._op_cols(B, h1w, h2w, weights)
        table = pool.state[row * pool.row_units : row * pool.row_units + d * w]
        est = cms_seq.cms_update_estimate_seq(table, a, b, wt, d=d, w=w)
        return LazyResult(est, transform=_as_u32)

    @_locked
    def cms_merge(self, pool, dst_row: int, src_rows) -> LazyResult:
        """CMS.MERGE: dst row += the source rows, mod 2**32, on the device."""
        cms_ops.cms_merge(pool.state, dst_row, self._rows_tensor(src_rows),
                          cells_per_row=pool.row_units)
        return LazyResult(None)

    # -- hll -----------------------------------------------------------------

    @_locked
    def hll_add_keys_single(self, pool, row: int, blocks, lengths,
                            chunk: int = _SCAN_CHUNK) -> LazyResult:
        """Direct PFADD from raw codec lanes (device hash), in passes of
        ``chunk`` ops, as the JAX package scans them: each pass sees the
        registers the one before left, and "changed" is the any over
        passes."""
        B = blocks.shape[0]
        if B == 0:
            return LazyResult(False)
        dblocks, dlens, L = self._keys_block(blocks, lengths)
        changed = torch.zeros((), dtype=torch.bool, device=self.device)
        for i in range(0, B, chunk):
            changed |= fastpath.hll_add_keys_single(
                pool.state, row, dblocks[i : i + chunk], dlens[i : i + chunk],
                target_lanes=L,
            )
        return LazyResult(changed, transform=bool)

    @_locked
    def hll_add(self, pool, rows, c0, c1, c2) -> LazyResult:
        B = len(c0)
        Bp = self._bucket(B)
        cols = self._op_cols(Bp, rows, c0, c1, c2)
        hll_ops.hll_add(pool.state, *cols, valid=self._valid(Bp, B))
        return LazyResult(True)

    @_locked
    def hll_add_changed(self, pool, rows, c0, c1, c2) -> LazyResult:
        """Multi-tenant PFADD with exact per-op "changed" flags (the
        coalesced path): one packed H2D of ``[n, rows, c0, c1, c2]``, the
        JAX executor's layout."""
        B = len(c0)
        Bp = self._bucket(B)
        buf, host = self._staging(1 + 4 * Bp)
        buf[0] = B
        o = 1
        for col in (rows, c0, c1, c2):
            o = _fill_words(buf, o, Bp, np.asarray(col).astype(np.uint32, copy=False),
                            np.uint32)
        packed = self._ship(host)
        cols = [packed[1 + i * Bp : 1 + (i + 1) * Bp] for i in range(4)]
        changed = hll_ops.hll_add_changed(
            pool.state, *cols, valid=self._valid(Bp, packed[0])
        )
        return self._result_bits(changed, B)

    @_locked
    def hll_add_single(self, pool, row: int, c0, c1, c2) -> LazyResult:
        """Single-tenant PFADD returning the "changed" boolean."""
        B = len(c0)
        Bp = self._bucket(B)
        cols = self._op_cols(Bp, c0, c1, c2)
        changed = hll_ops.hll_add_single(pool.state, row, *cols,
                                         valid=self._valid(Bp, B))
        return LazyResult(changed, transform=bool)

    @_locked
    def hll_count(self, pool, row: int) -> LazyResult:
        """PFCOUNT: the device histogram, finalized on the host with the
        float64 Ertl estimator (the golden model's count)."""
        return LazyResult(
            hll_ops.hll_histogram(pool.state, row),
            transform=lambda h: int(round(golden.ertl_estimate(h))),
        )

    @_locked
    def hll_merge(self, pool, dst_row: int, src_rows) -> LazyResult:
        hll_ops.hll_merge(pool.state, dst_row, self._rows_tensor(src_rows))
        return LazyResult(None)

    def _rows_tensor(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64), device=self.device)

    # -- bitset ----------------------------------------------------------------

    @_locked
    def bitset_mixed_runs(self, pool, idx, run_rows, run_ops, run_starts) -> LazyResult:
        """bitset_mixed with run-length metadata: row and opcode are
        constant within each submitted chunk, so they ship once per run
        and expand on the device with ``searchsorted`` (the scheme of
        bloom_mixed_keys_runs).  Packed as the JAX executor packs it:
        ``[n, idx (Bp), starts (Cp + 1), rows (Cp), opcodes (Cp)]``; padded
        runs carry OP_GET, so padded ops (routed to the scratch word) are
        reads and the pool bytes match."""
        B = int(run_starts[-1])
        Bp = self._bucket(B)
        C = len(run_rows)
        Cp = max(1024, _pow2ceil(C))
        buf, host = self._staging(1 + Bp + (Cp + 1) + 2 * Cp)
        buf[0] = B
        o = _fill_words(buf, 1, Bp, np.asarray(idx, np.uint32), np.uint32)
        sview = buf[o : o + Cp + 1].view(np.int32)
        sview[: C + 1] = run_starts
        sview[C + 1 :] = B
        o += Cp + 1
        o = _fill_words(buf, o, Cp, np.asarray(run_rows, np.int32), np.int32)
        _fill_words(buf, o, Cp, np.asarray(run_ops, np.uint32), np.uint32,
                    bitset_ops.OP_GET)
        packed = self._ship(host)
        o = 1 + Bp
        ends = packed[o + 1 : o + Cp + 1].to(torch.int64)
        rr = packed[o + Cp + 1 : o + 2 * Cp + 1]
        ro = packed[o + 2 * Cp + 1 :]
        iota = torch.arange(Bp, dtype=torch.int64, device=self.device)
        # Run of op i = number of run ends <= i, clipped to the last run.
        seg = torch.clamp(torch.searchsorted(ends, iota, right=True), max=Cp - 1)
        obs = bitset_ops.bitset_mixed(
            pool.state, rr[seg], packed[1 : 1 + Bp], ro[seg],
            words_per_row=pool.row_units, valid=iota < packed[0],
        )
        return self._result_bits(obs, B)

    @_locked
    def bitset_mixed(self, pool, rows, idx, opcodes) -> LazyResult:
        """Unified set/clear/flip/get batch with per-op arrays: one packed
        H2D of ``[n, rows, idx, opcodes]``; padded ops carry OP_GET."""
        B = len(idx)
        Bp = self._bucket(B)
        buf, host = self._staging(1 + 3 * Bp)
        buf[0] = B
        o = _fill_words(buf, 1, Bp, np.asarray(rows, np.int32), np.int32)
        o = _fill_words(buf, o, Bp, np.asarray(idx, np.uint32), np.uint32)
        _fill_words(buf, o, Bp, np.asarray(opcodes, np.uint32), np.uint32,
                    bitset_ops.OP_GET)
        packed = self._ship(host)
        r, i, op = (packed[1 + k * Bp : 1 + (k + 1) * Bp] for k in range(3))
        obs = bitset_ops.bitset_mixed(
            pool.state, r, i, op, words_per_row=pool.row_units,
            valid=self._valid(Bp, packed[0]),
        )
        return self._result_bits(obs, B)

    def _bitset_rw(self, kernel, pool, rows, idx) -> LazyResult:
        B = len(idx)
        Bp = self._bucket(B)
        r, i = self._op_cols(Bp, rows, idx)
        prev = kernel(pool.state, r, i, words_per_row=pool.row_units,
                      valid=self._valid(Bp, B))
        return self._result_bits(prev, B)

    @_locked
    def bitset_set(self, pool, rows, idx) -> LazyResult:
        return self._bitset_rw(bitset_ops.bitset_set, pool, rows, idx)

    @_locked
    def bitset_clear_bits(self, pool, rows, idx) -> LazyResult:
        return self._bitset_rw(bitset_ops.bitset_clear, pool, rows, idx)

    @_locked
    def bitset_flip(self, pool, rows, idx) -> LazyResult:
        return self._bitset_rw(bitset_ops.bitset_flip, pool, rows, idx)

    @_locked
    def bitset_get(self, pool, rows, idx) -> LazyResult:
        B = len(idx)
        r, i = self._op_cols(self._bucket(B), rows, idx)
        got = bitset_ops.bitset_get(pool.state, r, i, words_per_row=pool.row_units)
        return self._result_bits(got, B)

    @_locked
    def bitset_set_range(self, pool, row: int, from_bit: int, to_bit: int,
                         value: bool) -> LazyResult:
        bitset_ops.bitset_set_range(pool.state, row, from_bit, to_bit,
                                    words_per_row=pool.row_units, value=value)
        return LazyResult(None)

    @_locked
    def bitset_cardinality(self, pool, row: int) -> LazyResult:
        return LazyResult(bitset_ops.bitset_cardinality(
            pool.state, row, words_per_row=pool.row_units), transform=int)

    @_locked
    def bitset_length(self, pool, row: int) -> LazyResult:
        return LazyResult(bitset_ops.bitset_length(
            pool.state, row, words_per_row=pool.row_units), transform=int)

    @_locked
    def bitset_bitpos(self, pool, row: int, target_bit: int) -> LazyResult:
        return LazyResult(bitset_ops.bitset_bitpos(
            pool.state, row, words_per_row=pool.row_units, target_bit=target_bit),
            transform=int)

    @_locked
    def bitset_bitop(self, pool, dst_row: int, src_rows, op: str,
                     limit_bits=None) -> LazyResult:
        """BITOP; ``limit_bits`` (NOT only) masks the result to the
        source's logical length."""
        bitset_ops.bitset_bitop_rows(
            pool.state, dst_row, self._rows_tensor(src_rows),
            words_per_row=pool.row_units, op=op, limit_bits=limit_bits,
        )
        return LazyResult(None)

    @_locked
    def bitset_get_row(self, pool, row: int) -> LazyResult:
        return LazyResult(bitset_ops.bitset_get_row(
            pool.state, row, words_per_row=pool.row_units), transform=_as_u32)
