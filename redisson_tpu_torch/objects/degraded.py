"""Degraded-mode host mirrors (counterpart of
``redisson_tpu/objects/degraded.py``).

When a circuit breaker opens for a sketch kind (executor/health.py), the
engine stops dispatching that kind to the device and serves reads AND
writes from a host-side golden-model mirror of each affected object
(ops/golden.py — the models every op of the port is tested against).
The mirror is seeded from the object's device row at failover time,
applies the degraded window's ops with exact golden semantics, and
encodes back to the device row layout when the breaker closes
(reconcile-on-close), so the device resumes from precisely the state the
mirror served.

Layout codecs (device row <-> golden model).  The port's pools hold
uint32 words as int32 bit-views; a row read to the host comes back as a
numpy copy of either view, and both decode alike (``_words``):

- bloom / bitset — ``uint32`` bitmap words; bit *i* lives at word
  ``i >> 5``, bit ``i & 31`` (little-endian within the word), so
  ``np.unpackbits(row.view(uint8), bitorder="little")`` is the exact
  inverse of the device packing.
- hll — rows ARE the register array (``uint8[16384]``), no transform.
- cms — rows are the row-major ``uint32[d*w]`` counter table.

Every ``encode`` returns the bytes the JAX package's mirror returns for
the same model state.

Thread-safety: the engine serializes mirror application and reconcile
under one mirror lock; the models here assume external synchronization.
"""

from __future__ import annotations

import numpy as np

from redisson_tpu_torch.ops import bitset as bitset_ops, golden


def _words(row: np.ndarray) -> np.ndarray:
    """A row of 32-bit words as little-endian uint32: int32 bit-views
    (the port's device element type) are reinterpreted, not converted."""
    words = np.ascontiguousarray(row)
    if words.dtype == np.int32:
        words = words.view(np.uint32)
    words = np.asarray(words, np.uint32)
    if words.dtype.byteorder == ">":  # pragma: no cover — BE platform
        words = words.byteswap().view(words.dtype.newbyteorder("<"))
    return words


def _bits_from_words(row: np.ndarray, nbits: int) -> np.ndarray:
    """Decode a device bitmap row (uint32 words) to bool[nbits]."""
    bits = np.unpackbits(_words(row).view(np.uint8), bitorder="little")
    return bits[:nbits].view(bool)  # 0/1 bytes: a view, not a second copy


def _words_from_bits(bits: np.ndarray, row_units: int) -> np.ndarray:
    """Encode bool bits back to a uint32[row_units] device row."""
    packed = np.packbits(np.asarray(bits, bool), bitorder="little")
    out = np.zeros(row_units * 4, np.uint8)
    out[: packed.shape[0]] = packed[: row_units * 4]
    return out.view("<u4").astype(np.uint32, copy=False)


class BloomMirror:
    kind = "bloom"

    def __init__(self, row: np.ndarray, row_units: int, m: int, k: int):
        self.row_units = int(row_units)
        self.m = int(m)
        self.k = int(k)
        self.model = golden.GoldenBloomFilter(m, k)
        self.model.bits = _bits_from_words(row, m)
        self.ops = 0

    def mixed(self, h1m, h2m, is_add) -> np.ndarray:
        """Sequential add/contains batch — exact arrival-order semantics,
        matching the device's bloom_mixed contract."""
        h1m = np.asarray(h1m, np.uint32)
        h2m = np.asarray(h2m, np.uint32)
        is_add = np.asarray(is_add, bool)
        if not is_add.any():
            # Contains only: nothing changes between ops, so one
            # vectorized probe is the sequential answer.
            self.ops += len(h1m)
            return np.asarray(self.model.contains_hashed(h1m, h2m), bool)
        out = np.zeros(len(h1m), bool)
        for j in range(len(h1m)):
            a, b = h1m[j : j + 1], h2m[j : j + 1]
            if is_add[j]:
                out[j] = bool(self.model.add_hashed(a, b)[0])
            else:
                out[j] = bool(self.model.contains_hashed(a, b)[0])
        self.ops += len(h1m)
        return out

    def add_state(self, h1m, h2m) -> None:
        """The state effect of a batch of adds, vectorized (setting bits
        is order-free; journal replay needs no per-op results)."""
        idx = self.model._indexes(np.asarray(h1m, np.uint32), np.asarray(h2m, np.uint32))
        self.model.bits[idx.reshape(-1)] = True
        self.ops += len(idx)

    def count(self) -> int:
        return self.model.cardinality_estimate()

    def encode(self, row_units=None) -> np.ndarray:
        return _words_from_bits(self.model.bits, row_units or self.row_units)


class BitsetMirror:
    """Wraps :class:`golden.GoldenBitSet` — one bitset reference
    implementation, shared with the property tests, not a second copy
    to keep bit-identical.  The model grows on demand (the live entry
    can migrate to a larger size class while degraded — bitset_ensure
    is not breaker-gated); encode() sizes to the CURRENT pool at
    reconcile."""

    kind = "bitset"

    def __init__(self, row: np.ndarray, row_units: int):
        self.row_units = int(row_units)
        self.model = golden.GoldenBitSet(0)
        self.model.bits = _bits_from_words(row, row_units * 32)
        self.ops = 0

    @property
    def bits(self) -> np.ndarray:
        return self.model.bits

    def mixed(self, idx, opcodes) -> np.ndarray:
        """Unified set/clear/flip/get with previous-bit results and exact
        sequential duplicate semantics (the bitset_mixed contract),
        built on the model's sequential set/get."""
        idx = np.asarray(idx, np.int64)
        ops = np.asarray(opcodes, np.uint32)
        prev = np.zeros(len(idx), bool)
        for j in range(len(idx)):
            i = idx[j : j + 1]
            op = int(ops[j])
            if op == bitset_ops.OP_SET:
                prev[j] = bool(self.model.set(i, True)[0])
            elif op == bitset_ops.OP_CLEAR:
                prev[j] = bool(self.model.set(i, False)[0])
            elif op == bitset_ops.OP_FLIP:
                cur = bool(self.model.get(i)[0])
                self.model.set(i, not cur)
                prev[j] = cur
            else:  # read (OP_GET)
                prev[j] = bool(self.model.get(i)[0])
        self.ops += len(idx)
        return prev

    def assign(self, idx, value: bool) -> None:
        """The state effect of SET or CLEAR of every index, vectorized
        (one value for all: order-free; journal replay needs no per-op
        results)."""
        idx = np.asarray(idx, np.int64)
        if idx.size:
            self.model._grow(int(idx.max()) + 1)
            self.model.bits[idx] = bool(value)
        self.ops += len(idx)

    def flip_state(self, idx) -> None:
        """The state effect of FLIP of every index, vectorized: an index
        flipped an odd number of times ends inverted."""
        idx = np.asarray(idx, np.int64)
        if idx.size:
            self.model._grow(int(idx.max()) + 1)
            u, c = np.unique(idx, return_counts=True)
            odd = u[(c & 1) == 1]
            self.model.bits[odd] = ~self.model.bits[odd]
        self.ops += len(idx)

    def set_range(self, from_bit: int, to_bit: int, value: bool) -> None:
        """SETRANGE analog — [from_bit, to_bit) assignment (the
        bitset_set_range contract on both engines)."""
        self.model._grow(int(to_bit))
        self.model.bits[int(from_bit):int(to_bit)] = bool(value)
        self.ops += 1

    def replace_bits(self, bits: np.ndarray) -> None:
        """Wholesale replacement — BITOP dest semantics (prior value
        never leaks into the result)."""
        self.model.bits = np.array(bits, dtype=bool)
        self.ops += 1

    def bitpos(self, target_bit: int) -> int:
        matches = np.nonzero(self.bits == bool(target_bit))[0]
        if matches.size:
            return int(matches[0])
        return -1 if target_bit else self.bits.size

    def cardinality(self) -> int:
        return self.model.cardinality()

    def length(self) -> int:
        return self.model.length()

    def encode(self, row_units=None) -> np.ndarray:
        # Reconcile targets the entry's CURRENT pool (a degraded-window
        # grow may have migrated it to a larger size class).
        return _words_from_bits(self.bits, row_units or self.row_units)


class HllMirror:
    kind = "hll"

    def __init__(self, row: np.ndarray, row_units: int):
        self.row_units = int(row_units)
        self.regs = np.asarray(row, np.uint8).copy()
        self.ops = 0

    def add_changed(self, c0, c1, c2) -> np.ndarray:
        idx, rank = golden.hll_index_rank(
            np.asarray(c0, np.uint32),
            np.asarray(c1, np.uint32),
            np.asarray(c2, np.uint32),
        )
        changed = np.zeros(len(idx), bool)
        for j in range(len(idx)):  # sequential: exact per-op changed flags
            i = int(idx[j])
            if rank[j] > self.regs[i]:
                self.regs[i] = rank[j]
                changed[j] = True
        self.ops += len(idx)
        return changed

    def add_state(self, c0, c1, c2) -> None:
        """The state effect of a batch of adds, vectorized (a register
        keeps the max rank that hit it: order-free)."""
        idx, rank = golden.hll_index_rank(
            np.asarray(c0, np.uint32), np.asarray(c1, np.uint32), np.asarray(c2, np.uint32)
        )
        np.maximum.at(self.regs, np.asarray(idx, np.int64), np.asarray(rank, np.uint8))
        self.ops += len(idx)

    def merge_rows(self, rows) -> None:
        """PFMERGE into this mirror: max of registers per source row
        (device rows ARE the register array, so sources may be device
        reads or other mirrors' encode() output)."""
        for r in rows:
            regs = np.asarray(r, np.uint8)[: self.regs.shape[0]]
            np.maximum(self.regs, regs, out=self.regs)
        self.ops += 1

    def count(self) -> int:
        hist = np.bincount(self.regs, minlength=golden.HLL_Q + 2)
        return int(round(golden.ertl_estimate(hist)))

    def encode(self, row_units=None) -> np.ndarray:
        return self.regs.copy()


class CmsMirror:
    kind = "cms"

    def __init__(self, row: np.ndarray, row_units: int, d: int, w: int):
        self.row_units = int(row_units)
        self.model = golden.GoldenCountMinSketch(d, w)
        self.model.counts = (
            _words(row)[: d * w].reshape(d, w).copy()
        )
        self.ops = 0

    def update_estimate(self, h1w, h2w, weights) -> np.ndarray:
        """Apply-then-estimate over the whole batch — the vectorized
        cms_update_and_estimate contract (estimates observe the batch)."""
        h1w = np.asarray(h1w, np.uint32)
        h2w = np.asarray(h2w, np.uint32)
        weights = np.asarray(weights, np.uint32)
        if np.any(weights):
            upd = weights != 0
            self.model.add_hashed(h1w[upd], h2w[upd], weights[upd])
        self.ops += len(h1w)
        return self.model.estimate_hashed(h1w, h2w).astype(np.uint32)

    def merge_rows(self, rows) -> None:
        """CMS.MERGE into this mirror: counters SUM per source row
        (row-major uint32[d*w] tables, same geometry — the engine
        enforces the geometry check before calling)."""
        d, w = self.model.counts.shape
        for r in rows:
            self.model.counts += _words(r)[: d * w].reshape(d, w)
        self.ops += 1

    def total(self) -> int:
        return int(self.model.counts[0].astype(np.uint64).sum())

    def reset(self) -> None:
        self.model.counts[:] = 0

    def encode(self, row_units=None) -> np.ndarray:
        out = np.zeros(row_units or self.row_units, np.uint32)
        flat = self.model.counts.reshape(-1)
        out[: flat.shape[0]] = flat
        return out


def mirror_for_entry(entry, row: np.ndarray):
    """Build the kind-appropriate mirror from an entry + its device row."""
    from redisson_tpu_torch.tenancy import PoolKind

    u = entry.pool.row_units
    if entry.kind == PoolKind.BLOOM:
        return BloomMirror(
            row, u, entry.params["size"], entry.params["hash_iterations"]
        )
    if entry.kind == PoolKind.BITSET:
        return BitsetMirror(row, u)
    if entry.kind == PoolKind.HLL:
        return HllMirror(row, u)
    if entry.kind == PoolKind.CMS:
        return CmsMirror(
            row, u, entry.params["depth"], entry.params["width"]
        )
    raise ValueError(f"no degraded mirror for kind {entry.kind!r}")
