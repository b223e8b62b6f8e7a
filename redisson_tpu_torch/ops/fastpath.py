"""Single-tenant fast Bloom paths, device-side hashing and the keyed
Bloom paths.

Counterpart of ``redisson_tpu/ops/fastpath.py``.

``bloom_add_fast_st`` / ``bloom_contains_st`` take pre-reduced hashes
(``h1m, h2m`` < m) for ONE tenant row.  The fast add materialises the
batch's bits as a bit-delta over that row (a boolean bitmap, so a
duplicate bit needs no dedup), packs it to 32-bit words and ORs it in.
Its newly-added flags are taken against the state BEFORE the batch: two
identical keys in one batch both report True, where the exact path
(``ops/bloom.bloom_mixed``) reports True then False.  The bits set are
the same either way.  ``Config.use_gpu_sketch(exact_add_semantics=
False)`` opts in.

Device hashing: producers ship raw codec lanes, and murmur3 plus the
exact 64-bit ``h % m`` run on the device, bit-identical to the host
pipeline (``hashing.hash128_np`` + ``km_reduce_mod``).  The JAX package
computes the 64-bit mod with a 64-step bit loop in uint32; int64 lanes
make it one split here (``mod64_bits``).

``bloom_mixed_keys`` is the coalesced main path.  The single-tenant
``*_keys_st`` pair hashes and then takes the fast pair above; it serves
direct (uncoalesced) contains and the non-exact bulk add.
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


def mod64_bits(hi, lo, m32):
    """Exact ``(hi * 2**32 + lo) % m`` for uint32 lanes (int64 lanes, or
    int32 bit-views) and ``0 < m <= 2**31``; ``m32`` is an int or a
    per-op tensor.  Returns int64 lanes in ``[0, m)``.  One split is
    exact in int64: ``hi % m < 2**31``, so ``(hi % m) << 32 | lo`` stays
    below 2**63."""
    m = hashing.u32(m32) if isinstance(m32, torch.Tensor) else int(m32)
    return hashing.mod64(hashing.u32(hi), hashing.u32(lo), m)


def hash_km_device(blocks, lengths, m, target_lanes: int):
    """murmur3_x86_128 on device -> (h1m, h2m) int64[B], bit-identical to
    ``hashing.hash128_np`` + ``hashing.km_reduce_mod``.  ``m`` is an int
    or an int64 tensor (per op)."""
    c0, c1, c2, c3 = hashing.murmur3_x86_128_torch(
        pad_lanes(blocks, target_lanes), lengths
    )
    # hash128_np: h1 = c0 | c1 << 32, h2 = c2 | c3 << 32.
    return mod64_bits(c1, c0, m), mod64_bits(c3, c2, m)


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


def _row_bits(row, h1m, h2m, m: int, k: int, words_per_row: int):
    """(flat word, bit) ``[B, k]`` of each op's k bits in tenant ``row``."""
    idx = bitops.expand_km_indexes(hashing.u32(h1m), hashing.u32(h2m), m, k)
    return row * words_per_row + (idx >> 5), idx & 31, idx


def bloom_add_fast_st(flat, row: int, h1m, h2m, m: int, valid, *,
                      k: int, words_per_row: int):
    """Single-tenant bulk add of pre-reduced hashes.  Sets the bits of the
    ``valid`` ops (None: every op) in place; returns newly-added bool[B]
    against the state BEFORE the batch."""
    gword, bit, idx = _row_bits(row, h1m, h2m, m, k, words_per_row)
    newly = (bitops.gather_bits(flat, gword, bit) == 0).any(dim=1)
    # Bit-delta over this tenant's row plus one padding bit that absorbs
    # the invalid (batch-padding) ops.
    nbits = words_per_row * 32
    local = idx.reshape(-1)
    if valid is not None:
        local = torch.where(valid[:, None].expand(idx.shape).reshape(-1),
                            local, nbits)
    delta = torch.zeros(nbits + 1, dtype=torch.bool, device=flat.device)
    delta[local] = True
    row_words = bitops.row_slice(flat, row, words_per_row)
    row_words.bitwise_or_(bitops.pack_bool_u32(delta[:nbits]))
    return newly


def bloom_contains_st(flat, row: int, h1m, h2m, m: int, *, k: int,
                      words_per_row: int):
    """Single-tenant contains of pre-reduced hashes: bool[B], bit-exact
    with ``ops/bloom.bloom_contains``."""
    gword, bit, _ = _row_bits(row, h1m, h2m, m, k, words_per_row)
    return bitops.gather_bits(flat, gword, bit).to(torch.bool).all(dim=1)


def bloom_contains_keys_st(flat, row: int, blocks, lengths, m: int, *,
                           k: int, words_per_row: int, target_lanes: int):
    """Single-tenant contains from raw key lanes (device hashing)."""
    h1m, h2m = hash_km_device(blocks, lengths, m, target_lanes)
    return bloom_contains_st(flat, row, h1m, h2m, m, k=k,
                             words_per_row=words_per_row)


def bloom_add_keys_st(flat, row: int, blocks, lengths, m: int, valid, *,
                      k: int, words_per_row: int, target_lanes: int):
    """Single-tenant bulk add from raw key lanes (device hashing); flags
    against the state before the call."""
    h1m, h2m = hash_km_device(blocks, lengths, m, target_lanes)
    return bloom_add_fast_st(flat, row, h1m, h2m, m, valid, k=k,
                             words_per_row=words_per_row)


def hll_add_keys_single(flat_regs, row: int, blocks, lengths, valid=None, *,
                        target_lanes: int):
    """Single-tenant PFADD from raw key lanes: device murmur, then the
    scatter-max.  Updates in place; returns the 0-d "changed" flag."""
    c0, c1, c2, _ = hashing.murmur3_x86_128_torch(
        pad_lanes(blocks, target_lanes), lengths
    )
    return hll.hll_add_single(flat_regs, row, c0, c1, c2, valid=valid)
