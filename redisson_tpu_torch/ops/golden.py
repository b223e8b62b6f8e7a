"""Golden NumPy models of every sketch — the test oracle.

The reference has no such layer: Redisson trusts the Redis server for sketch
semantics (→ org/redisson/RedissonHyperLogLog.java is a thin PFADD/PFCOUNT
wrapper; SURVEY.md §2.2).  We build what upstream's test strategy lacks
(SURVEY.md §4): every device kernel is property-tested against these models,
FPP is checked against analytic bounds, and HLL error against 1.04/sqrt(m).

These models are deliberately simple (bool arrays, np.add.at) — clarity
over speed.  The device kernels in ops/*.py must match them behaviorally
(not layout-wise).  This package holds the Bloom and count-min models its
slice needs; the HyperLogLog and BitSet models arrive with those objects.
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
