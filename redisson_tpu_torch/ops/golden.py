"""Golden NumPy models of every sketch — the test oracle.

The reference has no such layer: Redisson trusts the Redis server for sketch
semantics (→ org/redisson/RedissonHyperLogLog.java is a thin PFADD/PFCOUNT
wrapper; SURVEY.md §2.2).  We build what upstream's test strategy lacks
(SURVEY.md §4): every device kernel is property-tested against these models,
FPP is checked against analytic bounds, and HLL error against 1.04/sqrt(m).

These models are deliberately simple (bool arrays, np.add.at) — clarity
over speed.  The device kernels in ops/*.py must match them behaviorally
(not layout-wise).  This package keeps its own copy of the JAX
package's Bloom, HyperLogLog, BitSet and count-min models.
"""

from __future__ import annotations

import math

import numpy as np

# --------------------------------------------------------------------------
# Bloom filter — parity with org/redisson/RedissonBloomFilter.java math:
#   m = ceil(-n ln p / (ln 2)^2),  k = max(1, round(m/n * ln 2)),
#   index_i = (h1 + i*h2) mod m  (Kirsch–Mitzenmacher double hashing).
# --------------------------------------------------------------------------

MAX_BLOOM_BITS = 1 << 31  # device kernels require m <= 2**31 (uint32 index math)


def optimal_num_of_bits(expected_insertions: int, false_probability: float,
                        max_bits: int = MAX_BLOOM_BITS) -> int:
    """→ RedissonBloomFilter#optimalNumOfBits (standard formula)."""
    if false_probability <= 0 or false_probability >= 1:
        raise ValueError("falseProbability must be in (0, 1)")
    n = max(1, expected_insertions)
    m = math.ceil(-n * math.log(false_probability) / (math.log(2) ** 2))
    max_bits = min(int(max_bits), MAX_BLOOM_BITS)
    if m > max_bits:
        # The reference rejects oversized filters rather than silently
        # degrading FPP (RedissonBloomFilter caps size, SURVEY.md §2.2).
        raise ValueError(
            f"bloom filter needs {m} bits for n={expected_insertions}, "
            f"p={false_probability}; max is {max_bits}"
        )
    return max(m, 16)


def optimal_num_of_hash_functions(expected_insertions: int, size: int) -> int:
    """→ RedissonBloomFilter#optimalNumOfHashFunctions."""
    n = max(1, expected_insertions)
    return max(1, round(size / n * math.log(2)))


class GoldenBloomFilter:
    """Plain bool-array Bloom filter fed pre-reduced (h1m, h2m) pairs."""

    def __init__(self, size: int, hash_iterations: int):
        self.size = int(size)
        self.hash_iterations = int(hash_iterations)
        self.bits = np.zeros(self.size, dtype=bool)

    def _indexes(self, h1m: np.ndarray, h2m: np.ndarray) -> np.ndarray:
        i = np.arange(self.hash_iterations, dtype=np.uint64)
        return (
            h1m[:, None].astype(np.uint64) + i[None, :] * h2m[:, None].astype(np.uint64)
        ) % np.uint64(self.size)

    def add_hashed(self, h1m: np.ndarray, h2m: np.ndarray) -> np.ndarray:
        """Returns bool[B]: True where at least one bit was newly set
        (Redisson's add() result semantics)."""
        idx = self._indexes(h1m, h2m)
        newly = np.zeros(idx.shape[0], dtype=bool)
        for b in range(idx.shape[0]):  # sequential: later keys see earlier bits
            row = idx[b]
            newly[b] = bool(np.any(~self.bits[row]))
            self.bits[row] = True
        return newly

    def contains_hashed(self, h1m: np.ndarray, h2m: np.ndarray) -> np.ndarray:
        idx = self._indexes(h1m, h2m)
        return self.bits[idx].all(axis=1)

    def cardinality_estimate(self) -> int:
        """BITCOUNT-based inversion: n ≈ -m/k * ln(1 - X/m)
        (→ RedissonBloomFilter#count)."""
        x = int(self.bits.sum())
        if x >= self.size:
            return self.size
        return int(
            round(-self.size / self.hash_iterations * math.log(1 - x / self.size))
        )


# --------------------------------------------------------------------------
# HyperLogLog — Redis-server parity geometry: p=14 → 16384 registers, 6-bit
# register values 0..51 (q=50).  The reference client never does this math
# (server-side PFADD/PFCOUNT); we use the Ertl improved raw estimator, which
# needs no empirical bias tables and beats the stock bias-corrected
# HLL within the 1.04/sqrt(m) ≈ 0.81% error budget.
# --------------------------------------------------------------------------

HLL_P = 14
HLL_M = 1 << HLL_P
HLL_Q = 50  # max rank = Q + 1 = 51, fits 6-bit Redis registers


def hll_index_rank(c0: np.ndarray, c1: np.ndarray, c2: np.ndarray):
    """Map three 32-bit hash lanes to (register index, rank).

    index = low 14 bits of c0; rank = leading-zero count of the 50-bit
    stream (c1 ++ top-18-bits-of-c2) plus one, i.e. 51 - bit_length(u50).
    Uses lanes independent of the index lane, so index/rank correlation is
    zero by construction.
    """
    idx = (c0 & np.uint32(HLL_M - 1)).astype(np.int64)
    u50 = (c1.astype(np.uint64) << np.uint64(18)) | (
        c2.astype(np.uint64) >> np.uint64(14)
    )
    # Exact bit_length via frexp: u50 < 2**50 < 2**53 so float64 is exact.
    _, exp = np.frexp(u50.astype(np.float64))
    rank = (np.int64(HLL_Q + 1) - exp.astype(np.int64)).astype(np.uint8)
    return idx, rank


def _sigma(x: float) -> float:
    if x == 1.0:
        return math.inf
    y, z = 1.0, x
    while True:
        x = x * x
        z_prev = z
        z = z + x * y
        y = y + y
        if z == z_prev:
            return z


def _tau(x: float) -> float:
    if x == 0.0 or x == 1.0:
        return 0.0
    y, z = 1.0, 1.0 - x
    while True:
        x = math.sqrt(x)
        z_prev = z
        y = 0.5 * y
        z = z - (1.0 - x) ** 2 * y
        if z == z_prev:
            return z / 3.0


def ertl_estimate(counts: np.ndarray, m: int = HLL_M, q: int = HLL_Q) -> float:
    """Ertl improved raw estimator from the register-value histogram.

    counts: int[q+2] — multiplicity of each register value 0..q+1.
    """
    z = m * _tau(1.0 - counts[q + 1] / m)
    for k in range(q, 0, -1):
        z = 0.5 * (z + float(counts[k]))
    z = z + m * _sigma(counts[0] / m)
    alpha_inf = 0.5 / math.log(2.0)
    return alpha_inf * m * m / z


class GoldenHyperLogLog:
    def __init__(self):
        self.regs = np.zeros(HLL_M, dtype=np.uint8)

    def add_hashed(self, c0, c1, c2) -> None:
        idx, rank = hll_index_rank(c0, c1, c2)
        np.maximum.at(self.regs, idx, rank)

    def count(self) -> int:
        counts = np.bincount(self.regs, minlength=HLL_Q + 2)
        return int(round(ertl_estimate(counts)))

    def merge(self, *others: "GoldenHyperLogLog") -> None:
        for o in others:
            np.maximum(self.regs, o.regs, out=self.regs)


# --------------------------------------------------------------------------
# BitSet — semantics of org/redisson/RedissonBitSet.java over Redis bitmaps:
# auto-grow on set, BITCOUNT/BITPOS, cross-key BITOP AND/OR/XOR/NOT.
# --------------------------------------------------------------------------


class GoldenBitSet:
    def __init__(self, nbits: int = 0):
        self.bits = np.zeros(int(nbits), dtype=bool)

    def _grow(self, nbits: int) -> None:
        if nbits > self.bits.size:
            nb = np.zeros(int(nbits), dtype=bool)
            nb[: self.bits.size] = self.bits
            self.bits = nb

    @staticmethod
    def _check_indexes(indexes) -> np.ndarray:
        indexes = np.asarray(indexes, dtype=np.int64)
        if indexes.size and int(indexes.min()) < 0:
            # Java BitSet semantics: negative index is an error, never a wrap.
            raise IndexError("bit index must be non-negative")
        return indexes

    def set(self, indexes: np.ndarray, value: bool = True) -> np.ndarray:
        indexes = self._check_indexes(indexes)
        if indexes.size:
            self._grow(int(indexes.max()) + 1)
        prev = np.empty(indexes.shape, dtype=bool)
        # Sequential semantics for duplicate indexes inside one batch.
        for j, ix in enumerate(indexes):
            prev[j] = self.bits[ix]
            self.bits[ix] = value
        return prev

    def get(self, indexes: np.ndarray) -> np.ndarray:
        indexes = self._check_indexes(indexes)
        out = np.zeros(indexes.shape, dtype=bool)
        in_range = indexes < self.bits.size
        out[in_range] = self.bits[indexes[in_range]]
        return out

    def cardinality(self) -> int:
        return int(self.bits.sum())

    def length(self) -> int:
        """Index of highest set bit + 1 (java BitSet.length semantics)."""
        nz = np.nonzero(self.bits)[0]
        return int(nz[-1]) + 1 if nz.size else 0


class GoldenCountMinSketch:
    """Golden CMS twin (the new RObject — no reference counterpart).

    Counters are uint32 — the device pool dtype — so per-cell totals wrap
    mod 2**32 *identically* in both engines (np.add.at and the device
    scatter-add share two's-complement wrap semantics).  The documented
    contract is therefore: per-cell counts are exact up to 2**32-1; callers
    needing larger totals must shard keys or widen at the application
    level.
    """

    def __init__(self, depth: int, width: int):
        self.depth = int(depth)
        self.width = int(width)
        self.counts = np.zeros((self.depth, self.width), dtype=np.uint32)

    def _cells(self, h1w: np.ndarray, h2w: np.ndarray) -> np.ndarray:
        r = np.arange(self.depth, dtype=np.uint64)
        return (
            h1w[:, None].astype(np.uint64) + r[None, :] * h2w[:, None].astype(np.uint64)
        ) % np.uint64(self.width)

    def add_hashed(self, h1w, h2w, weights=None) -> None:
        cells = self._cells(h1w, h2w)
        w = (
            np.ones(len(h1w), np.uint32)
            if weights is None
            else np.asarray(weights, np.uint32)
        )
        for r in range(self.depth):
            np.add.at(self.counts[r], cells[:, r], w)

    def estimate_hashed(self, h1w, h2w) -> np.ndarray:
        cells = self._cells(h1w, h2w)
        return self.counts[np.arange(self.depth)[None, :], cells].min(axis=1)

    def merge(self, other: "GoldenCountMinSketch") -> None:
        self.counts += other.counts
