"""Batched 128-bit hashing: the NumPy host path and its torch twin.

The hash is this project's MurmurHash3 x86_128 variant (see
``redisson_tpu/utils/hashing.py`` for the design): each key's zero-padded
tail bytes go through the block mix, blocks past a key's own count are
masked out, and the true byte length is mixed into finalization.  Both
twins here are bit-identical to the JAX package's.

torch has no usable unsigned 32-bit arithmetic (``+ - << >> ~ % min``
raise for ``torch.uint32`` on the CPU), so the torch twin carries every
uint32 lane as an int64 in ``[0, 2**32)`` and masks after each step.
The one trap is multiplication: ``x * c`` with both below 2**32 can
exceed 2**63, so ``_mul32`` splits the constant into 16-bit halves and
masks the high partial product before shifting it, keeping every
intermediate below 2**49.
"""

from __future__ import annotations

import numpy as np
import torch

# Murmur3 x86_128 block constants.
_C1 = np.uint32(0x239B961B)
_C2 = np.uint32(0xAB0E9789)
_C3 = np.uint32(0x38B34AE5)
_C4 = np.uint32(0xA1E38B93)
# Per-lane post-mix adds.
_N1 = np.uint32(0x561CCD1B)
_N2 = np.uint32(0x0BCAA747)
_N3 = np.uint32(0x96CD1C35)
_N4 = np.uint32(0x32AC3B17)
# fmix32 constants.
_F1 = np.uint32(0x85EBCA6B)
_F2 = np.uint32(0xC2B2AE35)

_FIVE = np.uint32(5)
DEFAULT_SEED = np.uint32(0x9747B28C)

MASK32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# NumPy host path (uint32 arrays wrap natively).
# --------------------------------------------------------------------------


def _rotl32(x, r: int):
    r = np.uint32(r)
    return (x << r) | (x >> np.uint32(32 - int(r)))


def _fmix32(h):
    h = h ^ (h >> np.uint32(16))
    h = h * _F1
    h = h ^ (h >> np.uint32(13))
    h = h * _F2
    h = h ^ (h >> np.uint32(16))
    return h


def murmur3_x86_128(blocks, lengths, seed=DEFAULT_SEED):
    """Batched 128-bit hash on the host.

    Args:
      blocks: ``uint32[B, 4*nblocks]`` little-endian 32-bit lanes of the
        zero-padded key bytes (see ``encode_bytes_batch``).
      lengths: ``uint32[B]`` true byte lengths (mixed into finalization).
      seed: uint32 seed.

    Returns ``(c0, c1, c2, c3)``, four ``uint32[B]`` lanes of the digest.
    """
    nlanes = blocks.shape[-1]
    if nlanes % 4 != 0:
        raise ValueError(f"blocks last dim must be a multiple of 4, got {nlanes}")
    shape = blocks.shape[:-1]
    seed = np.uint32(seed)
    h1 = np.full(shape, seed, dtype=np.uint32)
    h2 = np.full(shape, seed, dtype=np.uint32)
    h3 = np.full(shape, seed, dtype=np.uint32)
    h4 = np.full(shape, seed, dtype=np.uint32)

    ln32 = lengths.astype(np.uint32)
    # Whole-16-byte blocks each key owns (min 1): blocks past a key's own
    # count must not perturb its lanes (batch-shape independence).
    nblocks_key = np.maximum(np.uint32(1), (ln32 + np.uint32(15)) >> np.uint32(4))
    n_blk = nlanes // 4
    for blk in range(n_blk):
        k1 = blocks[..., 4 * blk + 0]
        k2 = blocks[..., 4 * blk + 1]
        k3 = blocks[..., 4 * blk + 2]
        k4 = blocks[..., 4 * blk + 3]

        k1 = _rotl32(k1 * _C1, 15) * _C2
        n1 = h1 ^ k1
        n1 = _rotl32(n1, 19) + h2
        n1 = n1 * _FIVE + _N1

        k2 = _rotl32(k2 * _C2, 16) * _C3
        n2 = h2 ^ k2
        n2 = _rotl32(n2, 17) + h3
        n2 = n2 * _FIVE + _N2

        k3 = _rotl32(k3 * _C3, 17) * _C4
        n3 = h3 ^ k3
        n3 = _rotl32(n3, 15) + h4
        n3 = n3 * _FIVE + _N3

        k4 = _rotl32(k4 * _C4, 18) * _C1
        n4 = h4 ^ k4
        n4 = _rotl32(n4, 13) + n1  # chains through the UPDATED h1
        n4 = n4 * _FIVE + _N4

        if n_blk == 1:
            h1, h2, h3, h4 = n1, n2, n3, n4
        else:
            active = np.uint32(blk) < nblocks_key
            h1 = np.where(active, n1, h1)
            h2 = np.where(active, n2, h2)
            h3 = np.where(active, n3, h3)
            h4 = np.where(active, n4, h4)

    h1 = h1 ^ ln32
    h2 = h2 ^ ln32
    h3 = h3 ^ ln32
    h4 = h4 ^ ln32

    h1 = h1 + h2 + h3 + h4
    h2 = h2 + h1
    h3 = h3 + h1
    h4 = h4 + h1

    h1 = _fmix32(h1)
    h2 = _fmix32(h2)
    h3 = _fmix32(h3)
    h4 = _fmix32(h4)

    h1 = h1 + h2 + h3 + h4
    h2 = h2 + h1
    h3 = h3 + h1
    h4 = h4 + h1
    return h1, h2, h3, h4


def hash128_np(blocks: np.ndarray, lengths: np.ndarray, seed=DEFAULT_SEED):
    """Host path: returns ``(H1, H2)`` as ``uint64[B]`` (two 64-bit
    halves), the Kirsch–Mitzenmacher pair."""
    c0, c1, c2, c3 = murmur3_x86_128(blocks, lengths, seed=seed)
    h1 = c0.astype(np.uint64) | (c1.astype(np.uint64) << np.uint64(32))
    h2 = c2.astype(np.uint64) | (c3.astype(np.uint64) << np.uint64(32))
    return h1, h2


def km_reduce_mod(h1: np.ndarray, h2: np.ndarray, m: int):
    """Reduce the 64-bit double-hash pair mod ``m`` (``m <= 2**31``, so
    the device expansion ``h1m + i*h2m`` never leaves uint32 range)."""
    if not 0 < m <= (1 << 31):
        raise ValueError(f"m must be in (0, 2**31], got {m}")
    mm = np.uint64(m)
    return (h1 % mm).astype(np.uint32), (h2 % mm).astype(np.uint32)


# --------------------------------------------------------------------------
# torch twin: uint32 lanes carried as int64 in [0, 2**32).
# --------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 lanes ``x < 2**32`` and a constant
    ``c < 2**32``, with every partial product below 2**49."""
    c = int(c)
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def _rotl32_t(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def _fmix32_t(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _F1)
    h = h ^ (h >> 13)
    h = _mul32(h, _F2)
    return h ^ (h >> 16)


def _add(*xs) -> torch.Tensor:
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out & MASK32


def u32(x: torch.Tensor) -> torch.Tensor:
    """int64 lanes holding the uint32 values of an int32 bit-view (or of
    an int64 tensor already in range)."""
    return x.to(torch.int64) & MASK32


def murmur3_x86_128_torch(blocks: torch.Tensor, lengths: torch.Tensor,
                          seed=DEFAULT_SEED):
    """torch twin of ``murmur3_x86_128``: ``blocks`` int ``[B, 4*n]`` and
    ``lengths`` int ``[B]`` (or a scalar tensor) holding uint32 values
    (int32 bit-views are fine).  Returns four int64 ``[B]`` lanes in
    ``[0, 2**32)``, bit-identical to the host path."""
    nlanes = blocks.shape[-1]
    if nlanes % 4 != 0:
        raise ValueError(f"blocks last dim must be a multiple of 4, got {nlanes}")
    blocks = u32(blocks)
    ln = u32(lengths).expand(blocks.shape[:-1])
    h1 = torch.full(blocks.shape[:-1], int(seed), dtype=torch.int64,
                    device=blocks.device)
    h2, h3, h4 = h1, h1, h1
    nblocks_key = torch.clamp((ln + 15) >> 4, min=1)
    n_blk = nlanes // 4
    for blk in range(n_blk):
        k1 = blocks[..., 4 * blk + 0]
        k2 = blocks[..., 4 * blk + 1]
        k3 = blocks[..., 4 * blk + 2]
        k4 = blocks[..., 4 * blk + 3]

        k1 = _mul32(_rotl32_t(_mul32(k1, _C1), 15), _C2)
        n1 = _add(_rotl32_t(h1 ^ k1, 19), h2)
        n1 = _add(n1 * 5, int(_N1))

        k2 = _mul32(_rotl32_t(_mul32(k2, _C2), 16), _C3)
        n2 = _add(_rotl32_t(h2 ^ k2, 17), h3)
        n2 = _add(n2 * 5, int(_N2))

        k3 = _mul32(_rotl32_t(_mul32(k3, _C3), 17), _C4)
        n3 = _add(_rotl32_t(h3 ^ k3, 15), h4)
        n3 = _add(n3 * 5, int(_N3))

        k4 = _mul32(_rotl32_t(_mul32(k4, _C4), 18), _C1)
        n4 = _add(_rotl32_t(h4 ^ k4, 13), n1)  # chains through the UPDATED h1
        n4 = _add(n4 * 5, int(_N4))

        if n_blk == 1:
            h1, h2, h3, h4 = n1, n2, n3, n4
        else:
            active = blk < nblocks_key
            h1 = torch.where(active, n1, h1)
            h2 = torch.where(active, n2, h2)
            h3 = torch.where(active, n3, h3)
            h4 = torch.where(active, n4, h4)

    h1, h2, h3, h4 = h1 ^ ln, h2 ^ ln, h3 ^ ln, h4 ^ ln
    h1 = _add(h1, h2, h3, h4)
    h2, h3, h4 = _add(h2, h1), _add(h3, h1), _add(h4, h1)
    h1, h2, h3, h4 = _fmix32_t(h1), _fmix32_t(h2), _fmix32_t(h3), _fmix32_t(h4)
    h1 = _add(h1, h2, h3, h4)
    h2, h3, h4 = _add(h2, h1), _add(h3, h1), _add(h4, h1)
    return h1, h2, h3, h4


def mod64(hi: torch.Tensor, lo: torch.Tensor, m) -> torch.Tensor:
    """Exact ``(hi * 2**32 + lo) % m`` for int64 lanes ``hi, lo < 2**32``
    and ``0 < m <= 2**31`` (an int or a per-op int64 tensor):
    ``(hi % m) << 32`` is at most ``(2**31 - 1) * 2**32``, so adding
    ``lo`` stays below 2**63."""
    return (((hi % m) << 32) + lo) % m


# --------------------------------------------------------------------------
# Batch byte encoding: python bytes -> fixed-shape uint32 lane arrays.
# --------------------------------------------------------------------------


def pad_block_lanes(nbytes: int) -> int:
    """Number of uint32 lanes after padding to a whole 16-byte block."""
    nblocks = max(1, -(-nbytes // 16))
    return nblocks * 4


def encode_bytes_batch(items) -> tuple[np.ndarray, np.ndarray]:
    """Encode a list of ``bytes`` into ``(uint32[B, L4], uint32[B])``,
    zero-padding every key to the batch-wide max 16-byte block count."""
    n = len(items)
    if n == 0:
        return np.zeros((0, 4), np.uint32), np.zeros((0,), np.uint32)
    lengths = np.fromiter((len(b) for b in items), dtype=np.uint32, count=n)
    lanes = pad_block_lanes(int(lengths.max()))
    buf = np.zeros((n, lanes * 4), dtype=np.uint8)
    for i, b in enumerate(items):
        if b:
            buf[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return buf.view("<u4"), lengths


def encode_uint64_batch(arr) -> tuple[np.ndarray, np.ndarray]:
    """Fast path for integer keys: ``uint64[B] -> (uint32[B, 4], 8)``,
    bit-identical to routing LongCodec bytes through
    ``encode_bytes_batch``.  The block is built as a C-contiguous
    ``uint64[B, 2]`` (the key's 8 little-endian bytes, then the zero
    padding) and written in two 8-byte-wide passes."""
    a = np.ascontiguousarray(arr, dtype="<u8")
    words = np.empty((a.shape[0], 2), dtype="<u8")
    words[:, 0] = a
    words[:, 1] = 0
    return words.view("<u4"), np.full((a.shape[0],), 8, dtype=np.uint32)
