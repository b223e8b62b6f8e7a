"""Bit-level tensor primitives shared by the Bloom, BitSet, HyperLogLog
and count-min ops.

Counterpart of ``redisson_tpu/ops/bitops.py``.  A batch of bit ops is a
handful of tensor calls: a gather for reads, and one stable sort by
(word, bit) for writes, which yields the exact sequential semantics of
one-op-at-a-time execution (what each op observed) without a serial
loop.

State convention: a pool of T tenant rows × W words is a flat int32
tensor of ``T*W + 1`` elements holding the uint32 words as bit-views;
the trailing word is a scratch slot that padded (invalid) ops target.
Writes update the pool tensor IN PLACE (the JAX functions return a new
array; here the executor owns the one buffer and mutates it under its
dispatch lock, which saves a pool-sized copy per launch).

Arithmetic on uint32 values runs in int64 lanes in ``[0, 2**32)``
(``hashing.u32``); ``to_i32`` turns them back into int32 bit-views.
Right shifts on int32 are arithmetic, so bits are always masked after
one.

PyTorch has no ``associative_scan``, and ``torch.cummax`` scans a 1-D
CUDA tensor in one block, so the segmented scans here are cumsums,
scatters and gathers (``run_starts``, ``_segmented_affine_scan``) or a
log-step doubling of elementwise ops (``segmented_exclusive_max``).
"""

from __future__ import annotations

import numpy as np
import torch

from redisson_tpu_torch.utils.hashing import MASK32, u32


def to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 lanes in ``[0, 2**32)`` -> the int32 tensor with the same
    32 bits (exact: no reliance on out-of-range cast behaviour)."""
    return (((v & MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def expand_km_indexes(h1m: torch.Tensor, h2m: torch.Tensor, m, k: int):
    """Kirsch–Mitzenmacher expansion ``index_i = (h1 + i*h2) mod m`` by
    iterated conditional subtraction (h1m, h2m pre-reduced mod m).
    ``m`` is an int or a per-op int64 tensor.  Returns int64 ``[B, k]``."""
    if isinstance(m, (int, np.integer)) and not 0 < m <= (1 << 31):
        raise ValueError(f"m must be in (0, 2**31], got {m}")
    idx = h1m
    cols = [idx]
    for _ in range(k - 1):
        idx = idx + h2m
        idx = torch.where(idx >= m, idx - m, idx)
        cols.append(idx)
    return torch.stack(cols, dim=1)


def gather_bits(flat: torch.Tensor, gword: torch.Tensor, bit: torch.Tensor):
    """GETBIT batch: int64 0/1 per op (``flat[gword]`` then the bit)."""
    return (flat[gword].to(torch.int64) >> bit) & 1


def gather_words(flat: torch.Tensor, gidx: torch.Tensor):
    """Element gather ``flat[gidx]`` as the JAX package computes it: a
    take of whole 128-lane rows, whose out-of-range rows read as all ones
    (JAX's fill mode).  So in a pool of whole 128-element rows the
    trailing scratch element reads as all ones; every other index reads
    its element.  The scratch word's bits after a padded mixed bitset
    batch depend on it."""
    words = flat[gidx]
    n = flat.shape[0] - 1
    if n % 128:
        return words
    return torch.where(gidx < n, words, ~torch.zeros_like(words))


def segmented_exclusive_max(first: torch.Tensor, vals: torch.Tensor):
    """Exclusive running max within segments (a segment starts where
    ``first`` is True; 0 at each start).  A Hillis–Steele doubling scan of
    the segmented max operator ``(f1, v1), (f2, v2) -> (f1 | f2, v2 if f2
    else max(v1, v2))``: ceil(log2 n) rounds of elementwise ops, exact
    for any integer values."""
    n = vals.shape[0]
    f, v = first, vals
    d = 1
    while d < n:
        v = torch.cat([v[:d], torch.where(f[d:], v[d:], torch.maximum(v[:-d], v[d:]))])
        f = torch.cat([f[:d], f[d:] | f[:-d]])
        d *= 2
    exc = torch.zeros_like(v)
    exc[1:] = v[:-1]
    return torch.where(first, torch.zeros_like(exc), exc)


def scatter_max_onehot(flat: torch.Tensor, gidx: torch.Tensor, values):
    """``flat[gidx] = max(flat[gidx], values)``, duplicate-safe, in place
    (the JAX package's one-hot 128-lane scatter gives the same result)."""
    flat.scatter_reduce_(0, gidx.to(torch.int64), values.to(flat.dtype),
                         reduce="amax")
    return flat


def route_invalid_to_scratch(gword, valid, flat_len: int):
    """Send padded ops to the trailing scratch word so they cannot
    perturb run detection or the results of real ops."""
    if valid is None:
        return gword
    return torch.where(valid, gword, flat_len - 1)


def _or_words(flat: torch.Tensor, sw: torch.Tensor, masks: torch.Tensor):
    """``flat[w] |= OR of masks`` for ops sorted by word ``sw`` whose
    masks within one word are distinct single bits (so their sum is their
    OR).  In place."""
    uw, inv = torch.unique_consecutive(sw, return_inverse=True)
    delta = torch.zeros(uw.shape[0], dtype=torch.int64, device=flat.device)
    delta.index_add_(0, inv, masks)
    flat[uw] = to_i32(u32(flat[uw]) | delta)


def run_starts(first: torch.Tensor) -> torch.Tensor:
    """For sorted ops whose runs begin where ``first`` is True: the
    position of each op's run start (int64).  Built from a cumsum and a
    scatter-min, not ``torch.cummax``, whose CUDA kernel scans a 1-D
    tensor in one block (it took 90% of the Bloom path's device time on
    an H100; PERF.md)."""
    n = first.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=first.device)
    run_id = torch.cumsum(first, 0) - 1
    start = torch.full((n,), n, dtype=torch.int64, device=first.device)
    start.scatter_reduce_(0, run_id, pos, reduce="amin")
    return start[run_id]


def scatter_set_bits_masked(flat: torch.Tensor, gword, bit, is_write):
    """SETBIT batch where only ``is_write`` ops set their bit; EVERY op
    observes the bit at its own sequence position — set pre-batch OR by
    an earlier writer in the batch.  Updates ``flat`` in place and
    returns the observed bits (int64 0/1) in arrival order.

    One stable sort on ``gword*32 + bit`` groups each (word, bit) into a
    run in arrival order.  "An earlier writer in my run" is a count: the
    writers before me minus the writers before my run's start (exclusive
    cumsums); only the first writer of a run contributes its bit."""
    n = gword.shape[0]
    key = gword.to(torch.int64) * 32 + bit
    skey, perm = torch.sort(key, stable=True)
    sw, sb = skey >> 5, skey & 31
    swr = is_write[perm]
    first = torch.ones(n, dtype=torch.bool, device=flat.device)
    first[1:] = skey[1:] != skey[:-1]
    writers_before = torch.cumsum(swr, 0) - swr.to(torch.int64)
    earlier_writer = writers_before > writers_before[run_starts(first)]
    obs_sorted = gather_bits(flat, sw, sb) | earlier_writer.to(torch.int64)
    contributes = swr & ~earlier_writer
    _or_words(flat, sw, torch.where(contributes, 1 << sb, 0))
    obs = torch.empty_like(obs_sorted)
    obs[perm] = obs_sorted
    return obs


def _segmented_affine_scan(first, b, a):
    """Segmented scan of the bit maps ``x -> a ^ (b & x)`` (a, b in {0, 1})
    composed earlier-first.  Returns int64 (eb, ea, ib, ia): the exclusive
    and inclusive composites of each element (exclusive = identity (1, 0)
    at a segment start).

    Closed form instead of a scan: a map with b = 0 (set, clear) forgets
    its input, and one with b = 1 XORs ``a`` in (get, flip).  So the
    inclusive composite at i is fixed by the last reset at or before i —
    the segment's last b = 0 op, or its start — and by the parity of the
    flips after it: one ``run_starts`` over the resets, one cumsum of
    flips, and gathers."""
    n = b.shape[0]
    b = b.to(torch.int64)
    a = a.to(torch.int64)
    flips = torch.cumsum(a & b, 0)
    p = run_starts(first | (b == 0))
    # Flips in [p, i]; a reset p is no flip itself.
    par = (flips - flips[p] + (a & b)[p]) & 1
    ib = b[p]
    ia = (a[p] & (1 - ib)) ^ par
    eb = torch.ones(n, dtype=torch.int64, device=b.device)
    ea = torch.zeros(n, dtype=torch.int64, device=b.device)
    eb[1:] = ib[:-1]
    ea[1:] = ia[:-1]
    return (torch.where(first, 1, eb), torch.where(first, 0, ea), ib, ia)


def _apply_bit_maps(flat: torch.Tensor, gword, bit, b_coef, a_coef, gather):
    """Apply per-op maps ``x -> a ^ (b & x)`` to bits in arrival order;
    ``gather(flat, words)`` reads the bits the ops find.  Returns the
    observed bits (int64 0/1) in arrival order; updates ``flat``."""
    n = gword.shape[0]
    key = gword.to(torch.int64) * 32 + bit
    skey, perm = torch.sort(key, stable=True)
    sw, sb = skey >> 5, skey & 31
    first = torch.ones(n, dtype=torch.bool, device=flat.device)
    first[1:] = skey[1:] != skey[:-1]
    eb, ea, ib, ia = _segmented_affine_scan(first, b_coef[perm], a_coef[perm])
    pre = (u32(gather(flat, sw)) >> sb) & 1
    obs_sorted = ea ^ (eb & pre)
    last = torch.ones(n, dtype=torch.bool, device=flat.device)
    last[:-1] = first[1:]
    final = ia ^ (ib & pre)
    wfirst = torch.ones(n, dtype=torch.bool, device=flat.device)
    wfirst[1:] = sw[1:] != sw[:-1]
    wid = torch.cumsum(wfirst, 0) - 1
    touched = torch.zeros(n, dtype=torch.int64, device=flat.device)
    touched.index_add_(0, wid, torch.where(last, 1 << sb, 0))
    setbits = torch.zeros(n, dtype=torch.int64, device=flat.device)
    setbits.index_add_(0, wid, torch.where(last, final << sb, 0))
    flat[sw] = to_i32((u32(flat[sw]) & ~touched[wid]) | setbits[wid])
    obs = torch.empty_like(obs_sorted)
    obs[perm] = obs_sorted
    return obs


def scatter_bit_affine(flat: torch.Tensor, gword, bit, b_coef, a_coef):
    """Unified GETBIT/SETBIT/clear/flip batch.  Each op applies
    ``x -> a ^ (b & x)`` to its bit — get (1, 0), set (0, 1), clear
    (0, 0), flip (1, 1) — and observes the value just before its own
    application (exact sequential semantics: set/clear/flip report the
    previous bit, get the current one).  Updates ``flat`` in place and
    returns the observed bits (int64 0/1) in arrival order.

    One stable sort on ``gword*32 + bit`` (int64: indexes reach 2**30)
    groups each (word, bit) in arrival order; the last op of each run
    knows the bit's final value.  Each touched word is rewritten as
    ``(word & ~touched) | final``, the two masks summed over the word's
    runs (disjoint bits, so the sums are ORs); every op of a word writes
    the same value, so duplicate writes agree and nothing syncs.  Bits
    are read as the JAX package reads them (``gather_words``)."""
    return _apply_bit_maps(flat, gword, bit, b_coef, a_coef, gather_words)


def _scatter_uniform(flat, gword, bit, b: int, a: int):
    """A batch whose ops all apply the one map ``x -> a ^ (b & x)``.  The
    JAX package's set/clear/flip apply masks to the words themselves, so
    the bits are read directly (the scratch word's own bits)."""
    coef = torch.ones_like(gword, dtype=torch.int64)
    return _apply_bit_maps(flat, gword, bit, coef * b, coef * a,
                           lambda f, words: f[words])


def scatter_set_bits(flat, gword, bit):
    """SETBIT(..., 1) batch: previous bit per op (1 after an earlier set
    of the same bit in the batch).  In place."""
    return _scatter_uniform(flat, gword, bit, 0, 1)


def scatter_clear_bits(flat, gword, bit):
    """SETBIT(..., 0) batch: previous bit per op (0 after an earlier clear
    of the same bit in the batch).  In place."""
    return _scatter_uniform(flat, gword, bit, 0, 0)


def scatter_flip_bits(flat, gword, bit):
    """Bit flip batch: a run of d flips of one bit nets d mod 2 flips, and
    op j of the run observes ``pre ^ (j mod 2)``.  In place."""
    return _scatter_uniform(flat, gword, bit, 1, 1)


def or_bits(flat: torch.Tensor, gword, bit):
    """Set every (gword, bit) — duplicates are idempotent.  In place."""
    skey = torch.unique(gword.to(torch.int64) * 32 + bit)
    _or_words(flat, skey >> 5, 1 << (skey & 31))


def scatter_add_u32(flat: torch.Tensor, idx: torch.Tensor, values):
    """``flat[idx] += values`` mod 2**32, duplicates accumulating (the
    count-min update).  In place."""
    uniq, inv = torch.unique(idx, return_inverse=True)
    sums = torch.zeros(uniq.shape[0], dtype=torch.int64, device=flat.device)
    sums.index_add_(0, inv, u32(values))
    flat[uniq] = to_i32(u32(flat[uniq]) + sums)


def pack_bool_u32(flags: torch.Tensor) -> torch.Tensor:
    """bool[N] -> int32[N/32] bit-views of uint32 words (N % 32 == 0),
    little-endian bit order: results leave the device at 1 bit per op."""
    w = flags.reshape(-1, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=flags.device)
    return to_i32((w << shifts).sum(dim=1))


def unpack_bool_u32(words, n: int) -> np.ndarray:
    """Host twin of pack_bool_u32: uint32 (or int32) words -> bool[n]."""
    b = np.unpackbits(
        np.ascontiguousarray(words).view(np.uint8), bitorder="little"
    )
    return b[:n].astype(bool)


def host_pack_bool_u32(flags: np.ndarray) -> np.ndarray:
    """bool[N] -> uint32[ceil(N/32)] on the host, same bit order (boolean
    op columns ride the packed H2D block at 1 bit per op)."""
    by = np.packbits(np.ascontiguousarray(flags, dtype=bool), bitorder="little")
    if by.shape[0] % 4:
        by = np.concatenate([by, np.zeros(4 - by.shape[0] % 4, np.uint8)])
    return by.view(np.uint32)


def unpack_bool_u32_dev(words: torch.Tensor, n: int) -> torch.Tensor:
    """Device twin of unpack_bool_u32: int32 words -> bool[n]."""
    idx = torch.arange(n, dtype=torch.int64, device=words.device)
    return ((u32(words[idx >> 5]) >> (idx & 31)) & 1).to(torch.bool)


def row_slice(flat: torch.Tensor, row: int, words_per_row: int):
    """View of one tenant row (writes through it update the pool)."""
    return flat[row * words_per_row : (row + 1) * words_per_row]


def row_update(flat: torch.Tensor, row: int, new_row, words_per_row: int):
    row_slice(flat, row, words_per_row).copy_(new_row)


def bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bit length of int64 values below 2**53 (float64 frexp is exact
    there): 0 for 0."""
    return torch.frexp(v.to(torch.float64)).exponent.to(torch.int64)


def popcount_row(flat: torch.Tensor, row: int, words_per_row: int):
    """BITCOUNT of one tenant row: a SWAR popcount of its bytes and one
    sum (0-d int64 tensor)."""
    x = row_slice(flat, row, words_per_row).view(torch.uint8)
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    x = (x + (x >> 4)) & 0x0F
    return x.sum(dtype=torch.int64)


def bit_length_row(flat: torch.Tensor, row: int, words_per_row: int):
    """Index of the highest set bit + 1 (java BitSet.length()); 0 if the
    row is empty (0-d int64 tensor)."""
    words = row_slice(flat, row, words_per_row)
    nz = words != 0
    last_word = words_per_row - 1 - torch.argmax(nz.flip(0).to(torch.uint8))
    length = last_word * 32 + bit_length(u32(words[last_word]))
    return torch.where(nz.any(), length, 0)


def bitpos_row(flat: torch.Tensor, row: int, words_per_row: int, target_bit: int):
    """BITPOS: index of the first bit equal to ``target_bit`` (0-d int64
    tensor).  Redis semantics: no set bit -> -1; no clear bit -> the first
    index past the row, never -1 for target 0."""
    words = u32(row_slice(flat, row, words_per_row))
    if target_bit == 0:
        words = words ^ MASK32
    nz = words != 0
    first_word = torch.argmax(nz.to(torch.uint8))  # the first maximum
    w = words[first_word]
    pos = first_word * 32 + bit_length(w & -w) - 1
    none_found = words_per_row * 32 if target_bit == 0 else -1
    return torch.where(nz.any(), pos, none_found)


def range_mask_words(words_per_row: int, from_bit: int, to_bit: int, device):
    """int32[W] bit-view mask with bits [from_bit, to_bit) set, clipped to
    the row: full words in the middle, partial masks at the two ends."""
    mask = torch.zeros(words_per_row, dtype=torch.int32, device=device)
    lo, hi = max(int(from_bit), 0), min(int(to_bit), words_per_row * 32)
    if lo < hi:
        fw, lw = lo >> 5, (hi - 1) >> 5
        mask[fw : lw + 1] = -1
        head = (MASK32 << (lo & 31)) & MASK32
        tail = MASK32 >> (31 - ((hi - 1) & 31))
        if fw == lw:
            head &= tail
        else:
            mask[lw] = tail - (1 << 32) if tail >> 31 else tail
        mask[fw] = head - (1 << 32) if head >> 31 else head
    return mask
