"""Bit-level tensor primitives shared by the Bloom and count-min ops.

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
