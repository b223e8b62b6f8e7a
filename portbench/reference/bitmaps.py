"""Bloom and BitSet bitmaps in plain PyTorch, and the reference servers.

A bitmap is a ``bool[nbits]`` tensor.  A Bloom row is the OR of the bits
of every key added to it, and a set-only bitmap the OR of its SETBITs,
whatever the order the writes took.  Per-call answers follow Redis's
sequential semantics: an element of a call sees the state before the call
plus the call's own earlier elements.

The servers answer the benchmark's calls in the program's place, one call
at a time.  With ``variant="exact"`` they are the reference itself; with another
``variant`` they are a control that breaks one guarantee the
configuration states (see ``BloomServer`` and ``BitsetServer``).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from portbench.reference.hashing import bloom_positions, to_i64


def first_occurrence(flat: torch.Tensor) -> torch.Tensor:
    """bool mask over ``flat``: True where the value has not appeared at an
    earlier position of ``flat``."""
    n = flat.numel()
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=flat.device)
    uniq, inv = torch.unique(flat, return_inverse=True)
    pos = torch.arange(n, device=flat.device)
    first = torch.full((uniq.numel(),), n, dtype=torch.int64, device=flat.device)
    first = first.scatter_reduce(0, inv, pos, reduce="amin")
    return first[inv] == pos


def row_to_bits(words: np.ndarray, device) -> torch.Tensor:
    """A program row of little-endian uint32 words as ``bool[32 * len]``."""
    b = torch.from_numpy(np.ascontiguousarray(words).view(np.uint8)).to(device)
    shifts = torch.arange(8, dtype=torch.uint8, device=device)
    return ((b[:, None] >> shifts) & 1).bool().reshape(-1)


def bit_mismatches(row_words: np.ndarray, ref_bits: torch.Tensor) -> int:
    """Bits in which a program row differs from the reference bitmap: the
    first ``len(ref_bits)`` bits compared, every bit past them must be 0."""
    got = row_to_bits(row_words, ref_bits.device)
    n = ref_bits.numel()
    if got.numel() < n:
        return n  # the row cannot even hold the bitmap
    return int((got[:n] != ref_bits).sum()) + int(got[n:].sum())


# -- Bloom --------------------------------------------------------------------


def bloom_add(bits: torch.Tensor, keys: torch.Tensor, k: int,
              hash_bits: int = 64) -> torch.Tensor:
    """Add ``keys`` (int64 bit patterns) in order; returns bool[B], True
    where the key set at least one bit that was clear before it."""
    m = bits.numel()
    pos = bloom_positions(keys, m, k, hash_bits)
    flat = pos.reshape(-1)
    fresh = ~bits[flat] & first_occurrence(flat)
    bits[flat] = True
    return fresh.reshape(pos.shape).any(dim=1)


def bloom_contains(bits: torch.Tensor, keys: torch.Tensor, k: int,
                   hash_bits: int = 64) -> torch.Tensor:
    pos = bloom_positions(keys, bits.numel(), k, hash_bits)
    return bits[pos].all(dim=1)


class _Done:
    """A completed call's answer, shaped as the program's futures."""

    def __init__(self, value):
        self._value = value

    def result(self, *a, **kw):
        return self._value

    def done(self) -> bool:
        return True


class BloomServer:
    """Bloom filters answered by the reference, one call at a time.

    ``variant="hash32"`` takes each half of the Kirsch–Mitzenmacher pair
    from 32 hash bits instead of 64, the cheaper hash a port might be
    tempted by: it breaks the stated guarantee that the bit positions are
    those of the 128-bit MurmurHash3."""

    def __init__(self, m: int, k: int, device, variant: str = "exact"):
        if variant not in ("exact", "hash32"):
            raise ValueError(f"unknown Bloom control {variant!r}")
        self.m, self.k, self.device = m, k, torch.device(device)
        self.hash_bits = 32 if variant == "hash32" else 64
        self.rows: dict = {}
        self._lock = threading.Lock()

    def _row(self, name):
        row = self.rows.get(name)
        if row is None:
            row = self.rows[name] = torch.zeros(self.m, dtype=torch.bool, device=self.device)
        return row

    def add(self, name, keys: np.ndarray):
        with self._lock:
            out = bloom_add(self._row(name), to_i64(keys).to(self.device), self.k,
                            self.hash_bits)
            return _Done(out.cpu().numpy())

    def contains(self, name, keys: np.ndarray):
        with self._lock:
            out = bloom_contains(self._row(name), to_i64(keys).to(self.device), self.k,
                                 self.hash_bits)
            return _Done(out.cpu().numpy())

    def row_words(self, name) -> np.ndarray:
        return pack_words(self._row(name))


# -- BitSet -------------------------------------------------------------------


def pack_words(bits: torch.Tensor) -> np.ndarray:
    """bool[n] -> little-endian uint32 words (zero-padded), on the host."""
    n = bits.numel()
    pad = (-n) % 32
    b = torch.cat([bits, bits.new_zeros(pad)]).reshape(-1, 8).to(torch.uint8)
    weights = (1 << torch.arange(8, device=bits.device)).to(torch.uint8)
    packed = (b * weights).sum(dim=1, dtype=torch.uint8)
    return packed.cpu().numpy().view(np.uint32)


class BitsetServer:
    """One set-only bitmap answered by the reference, one call at a time.

    ``variant="lost_update"`` writes each touched 32-bit word back from the
    state before the call with only the last of the call's bits in that
    word, as a plain (non-atomic) word scatter does: it breaks the stated
    guarantee that every acknowledged SETBIT stays set."""

    def __init__(self, nbits: int, device, variant: str = "exact"):
        if variant not in ("exact", "lost_update"):
            raise ValueError(f"unknown BitSet control {variant!r}")
        self.variant = variant
        self.bits = torch.zeros(nbits, dtype=torch.bool, device=torch.device(device))
        self._lock = threading.Lock()

    def set(self, name, idx: np.ndarray):
        with self._lock:
            i = torch.from_numpy(np.asarray(idx, np.int64)).to(self.bits.device)
            before = self.bits[i]
            if self.variant == "lost_update":
                # Each word is written once, from its old value and the
                # call's last bit in it: the call's other bits there are lost.
                last = first_occurrence((i >> 5).flip(0)).flip(0)
                self.bits[i[last]] = True
                return _Done(before.cpu().numpy())
            prev = before | ~first_occurrence(i)
            self.bits[i] = True
            return _Done(prev.cpu().numpy())

    def get(self, name, idx: np.ndarray):
        with self._lock:
            i = torch.from_numpy(np.asarray(idx, np.int64)).to(self.bits.device)
            return _Done(self.bits[i].cpu().numpy())

    def row_words(self, name) -> np.ndarray:
        return pack_words(self.bits)
