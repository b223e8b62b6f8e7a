"""MurmurHash3 x86_128 of 8-byte LongCodec keys and the Kirsch–Mitzenmacher
bit positions, in plain PyTorch.

A LongCodec key is its 8 little-endian bytes, zero-padded to one 16-byte
block: lanes ``(lo32, hi32, 0, 0)`` with byte length 8.  The block goes
through MurmurHash3 x86_128's mix with the project's seed 0x9747B28C, the
byte length through its finalisation, and the four 32-bit lanes ``c0..c3``
form the 64-bit pair ``H1 = c0 | c1 << 32``, ``H2 = c2 | c3 << 32``.  A
filter of ``m`` bits and ``k`` hashes sets bits
``(H1 mod m + i * (H2 mod m)) mod m`` for ``i < k``.

torch has no unsigned 32-bit arithmetic, so every lane is an int64 in
``[0, 2**32)``, masked after each step; a product of two such lanes is
formed from 16-bit halves of the constant so that no intermediate passes
2**49.
"""

from __future__ import annotations

import math

import torch

SEED = 0x9747B28C
MASK = 0xFFFFFFFF
C1, C2, C3, C4 = 0x239B961B, 0xAB0E9789, 0x38B34AE5, 0xA1E38B93
N1, N2, N3, N4 = 0x561CCD1B, 0x0BCAA747, 0x96CD1C35, 0x32AC3B17
F1, F2 = 0x85EBCA6B, 0xC2B2AE35


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul(h, F1)
    h = h ^ (h >> 13)
    h = _mul(h, F2)
    return h ^ (h >> 16)


def murmur3_x86_128_u64(keys: torch.Tensor):
    """The four 32-bit lanes (int64 tensors) of each 8-byte key.  ``keys``
    is an int64 tensor holding the keys' uint64 bit patterns."""
    k1 = keys & MASK
    k2 = (keys >> 32) & MASK
    seed = torch.full_like(k1, SEED)
    # Lanes 3 and 4 of the block are zero bytes.
    zero = torch.zeros_like(k1)
    k1 = _mul(_rotl(_mul(k1, C1), 15), C2)
    h1 = _rotl(seed ^ k1, 19)
    h1 = (h1 + seed) & MASK
    h1 = (h1 * 5 + N1) & MASK
    k2 = _mul(_rotl(_mul(k2, C2), 16), C3)
    h2 = _rotl(seed ^ k2, 17)
    h2 = (h2 + seed) & MASK
    h2 = (h2 * 5 + N2) & MASK
    k3 = _mul(_rotl(_mul(zero, C3), 17), C4)
    h3 = _rotl(seed ^ k3, 15)
    h3 = (h3 + seed) & MASK
    h3 = (h3 * 5 + N3) & MASK
    k4 = _mul(_rotl(_mul(zero, C4), 18), C1)
    h4 = _rotl(seed ^ k4, 13)
    h4 = (h4 + h1) & MASK
    h4 = (h4 * 5 + N4) & MASK
    h1, h2, h3, h4 = h1 ^ 8, h2 ^ 8, h3 ^ 8, h4 ^ 8
    h1 = (h1 + h2 + h3 + h4) & MASK
    h2 = (h2 + h1) & MASK
    h3 = (h3 + h1) & MASK
    h4 = (h4 + h1) & MASK
    h1, h2, h3, h4 = _fmix(h1), _fmix(h2), _fmix(h3), _fmix(h4)
    h1 = (h1 + h2 + h3 + h4) & MASK
    h2 = (h2 + h1) & MASK
    h3 = (h3 + h1) & MASK
    h4 = (h4 + h1) & MASK
    return h1, h2, h3, h4


def _mod_u64(lo: torch.Tensor, hi: torch.Tensor, m: int) -> torch.Tensor:
    """(hi * 2**32 + lo) mod m for m < 2**31, without leaving int64."""
    return ((hi % m) * ((1 << 32) % m) + lo) % m


def km_pair(keys: torch.Tensor, m: int, hash_bits: int = 64):
    """``(H1 mod m, H2 mod m)``.  ``hash_bits=32`` keeps only the low
    lane of each half: the cheaper, coarser hash a control run uses."""
    c0, c1, c2, c3 = murmur3_x86_128_u64(keys)
    if hash_bits == 32:
        return c0 % m, c2 % m
    return _mod_u64(c0, c1, m), _mod_u64(c2, c3, m)


def bloom_positions(keys: torch.Tensor, m: int, k: int,
                    hash_bits: int = 64) -> torch.Tensor:
    """int64[B, k]: the bits each key sets or tests."""
    h1, h2 = km_pair(keys, m, hash_bits)
    i = torch.arange(k, dtype=torch.int64, device=keys.device)
    return (h1[:, None] + i[None, :] * h2[:, None]) % m


def bloom_size(expected_insertions: int, false_probability: float):
    """``(m, k)`` of ``tryInit(n, p)``: m = max(16, ceil(-n ln p / ln(2)**2)),
    k = max(1, round(m / n * ln 2)).  (Redisson's Java truncates m; the
    project rounds it up, one bit more for some n and p.)"""
    n = max(1, int(expected_insertions))
    m = max(16, math.ceil(-n * math.log(false_probability) / (math.log(2) ** 2)))
    k = max(1, round(m / n * math.log(2)))
    return m, k


def to_i64(keys) -> torch.Tensor:
    """A numpy uint64 key array as an int64 tensor of the same bits."""
    import numpy as np

    return torch.from_numpy(np.ascontiguousarray(keys, dtype=np.uint64).view(np.int64))
