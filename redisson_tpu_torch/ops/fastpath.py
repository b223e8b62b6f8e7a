"""Device-side hashing and the keyed Bloom paths.

Counterpart of ``redisson_tpu/ops/fastpath.py``: producers ship raw
codec lanes, and murmur3 plus the exact 64-bit ``h % m`` run on the
device, bit-identical to the host pipeline (``hashing.hash128_np`` +
``km_reduce_mod``).  The JAX package computes the 64-bit mod with a
64-step bit loop in uint32; int64 lanes make it a closed form here
(``hashing.mod64``).

``bloom_mixed_keys`` is the coalesced main path.  The single-tenant
``*_keys_st`` pair serves direct (uncoalesced) contains and the
non-exact bulk add, whose newly-added flags are taken against the state
before the call (two identical keys in one call both report True).
``hll_add_keys_single`` is the direct (uncoalesced) PFADD.
"""

from __future__ import annotations

import torch

from redisson_tpu_torch.ops import bitops, bloom, hll
from redisson_tpu_torch.utils import hashing


def pad_lanes(blocks: torch.Tensor, target_lanes: int) -> torch.Tensor:
    """Restore trailing all-zero lanes the host trimmed before the H2D
    copy.  ``target_lanes`` is the ORIGINAL lane count: murmur mixes every
    16-byte block, zeros included, so the block count is hash input."""
    lanes = blocks.shape[-1]
    if lanes == target_lanes:
        return blocks
    pad = torch.zeros(
        (*blocks.shape[:-1], target_lanes - lanes),
        dtype=blocks.dtype, device=blocks.device,
    )
    return torch.cat([blocks, pad], dim=-1)


def hash_km_device(blocks, lengths, m, target_lanes: int):
    """murmur3_x86_128 on device -> (h1m, h2m) int64[B], bit-identical to
    ``hashing.hash128_np`` + ``hashing.km_reduce_mod``.  ``m`` is an int
    or an int64 tensor (per op)."""
    c0, c1, c2, c3 = hashing.murmur3_x86_128_torch(
        pad_lanes(blocks, target_lanes), lengths
    )
    # hash128_np: h1 = c0 | c1 << 32, h2 = c2 | c3 << 32.
    return hashing.mod64(c1, c0, m), hashing.mod64(c3, c2, m)


def bloom_mixed_keys(flat, rows, blocks, lengths, m_arr, is_add, valid, *,
                     k: int, words_per_row: int, target_lanes: int):
    """Multi-tenant combined add+contains from raw key lanes: device hash,
    then the exact sequential mixed op.  Updates ``flat`` in place;
    returns bool[B]."""
    m_arr = hashing.u32(m_arr)
    h1m, h2m = hash_km_device(blocks, lengths, m_arr, target_lanes)
    return bloom.bloom_mixed(
        flat, rows, h1m, h2m, is_add,
        m=m_arr, k=k, words_per_row=words_per_row, valid=valid,
    )


def _row_bits(row: int, h1m, h2m, m: int, k: int, words_per_row: int):
    idx = bitops.expand_km_indexes(h1m, h2m, m, k)
    return row * words_per_row + (idx >> 5), idx & 31


def bloom_contains_keys_st(flat, row: int, blocks, lengths, m: int, *,
                           k: int, words_per_row: int, target_lanes: int):
    """Single-tenant contains from raw key lanes: bool[B]."""
    h1m, h2m = hash_km_device(blocks, lengths, m, target_lanes)
    gword, bit = _row_bits(row, h1m, h2m, m, k, words_per_row)
    return bitops.gather_bits(flat, gword, bit).to(torch.bool).all(dim=1)


def bloom_add_keys_st(flat, row: int, blocks, lengths, m: int, valid, *,
                      k: int, words_per_row: int, target_lanes: int):
    """Single-tenant bulk add from raw key lanes.  Returns newly-added
    bool[B] against the state before the call; sets the bits of the
    ``valid`` ops in place."""
    h1m, h2m = hash_km_device(blocks, lengths, m, target_lanes)
    gword, bit = _row_bits(row, h1m, h2m, m, k, words_per_row)
    newly = (bitops.gather_bits(flat, gword, bit) == 0).any(dim=1)
    bitops.or_bits(flat, gword[valid].reshape(-1), bit[valid].reshape(-1))
    return newly


def hll_add_keys_single(flat_regs, row: int, blocks, lengths, valid=None, *,
                        target_lanes: int):
    """Single-tenant PFADD from raw key lanes: device murmur, then the
    scatter-max.  Updates in place; returns the 0-d "changed" flag."""
    c0, c1, c2, _ = hashing.murmur3_x86_128_torch(
        pad_lanes(blocks, target_lanes), lengths
    )
    return hll.hll_add_single(flat_regs, row, c0, c1, c2, valid=valid)
