"""The count-min sketch (Cormode & Muthukrishnan, J. Algorithms 55(1),
2005) in plain PyTorch, and the server that stands in for the program in
a control run.

A sketch of depth ``d`` and width ``w`` is ``d`` rows of ``w`` counters.
An event's cell in row ``r`` is ``(h1 + r * h2) mod w``, where ``h1`` and
``h2`` are the two 64-bit halves of the key's MurmurHash3 x86_128
(``hashing.km_pair``) each reduced mod ``w``.  An update adds the event's
weight to its cell in every row; an estimate is the minimum over the rows
of the event's cells.  In a sequence of updates each event's estimate is
taken right after its own update, so within one call an event sees the
state before the call plus the call's earlier events.

Counters are uint32 words that wrap mod 2**32, as Redis's CMS counters
and the program's do.  torch has no unsigned 32-bit arithmetic, so a
table is an int64 tensor whose words are masked to 32 bits where they are
read; every count here stays far below 2**32, so the masks never act.
Departures from the paper: one hash pair for all rows (Kirsch and
Mitzenmacher's double hashing) in place of ``d`` independent hashes, as
Redisson, RedisBloom and the program do.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from portbench.reference.hashing import km_pair, murmur3_x86_128_u64, to_i64

MASK = 0xFFFFFFFF


def cells(keys: torch.Tensor, d: int, w: int, hash_bits: int = 64) -> torch.Tensor:
    """int64[B, d]: each key's cell in each row.  ``keys`` holds the keys'
    uint64 bit patterns in an int64 tensor.  ``hash_bits=32`` is a control
    run's cheaper, coarser hash: each half from the upper 32 bits of its
    64 (lanes 1 and 3).  The lower lanes alone would be no control at a
    power-of-two width, where a 64-bit half mod w reads only its low
    bits."""
    if hash_bits == 32:
        _, c1, _, c3 = murmur3_x86_128_u64(keys)
        h1, h2 = c1 % w, c3 % w
    else:
        h1, h2 = km_pair(keys, w)
    r = torch.arange(d, dtype=torch.int64, device=keys.device)
    return (h1[:, None] + r[None, :] * h2[:, None]) % w


def add(table: torch.Tensor, c: torch.Tensor) -> None:
    """Add one to each event's cell in every row (``table``: int64[d, w])."""
    for r in range(table.shape[0]):
        table[r].index_add_(0, c[:, r], torch.ones_like(c[:, r]))


def occurrences(c: torch.Tensor):
    """``(before, total)``, int64[B, d] each: per row, how many events of
    the call share the event's cell up to and including it, and in all."""
    B, d = c.shape
    before = torch.empty_like(c)
    total = torch.empty_like(c)
    pos = torch.arange(B, device=c.device)
    for r in range(d):
        cell, perm = torch.sort(c[:, r], stable=True)
        first = torch.ones(B, dtype=torch.bool, device=c.device)
        first[1:] = cell[1:] != cell[:-1]
        start = torch.cummax(torch.where(first, pos, 0), 0).values
        last = torch.ones(B, dtype=torch.bool, device=c.device)
        last[:-1] = first[1:]
        end = torch.flip(torch.cummin(torch.flip(torch.where(last, pos, B), [0]), 0).values, [0])
        before[perm, r] = pos - start + 1
        total[perm, r] = end - start + 1
    return before, total


def estimate(table: torch.Tensor, c: torch.Tensor, extra=None) -> torch.Tensor:
    """int64[B]: the minimum over the rows of each event's cell, each cell
    read as a uint32 word, with ``extra`` (int64[B, d]) added first."""
    d = table.shape[0]
    vals = table[torch.arange(d, device=c.device)[None, :], c]
    if extra is not None:
        vals = vals + extra
    return (vals & MASK).min(dim=1).values


def add_seq(table: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Apply one call's events in order; returns each event's estimate
    right after its own update."""
    before, _ = occurrences(c)
    est = estimate(table, c, before)
    add(table, c)
    return est


def table_words(table: torch.Tensor) -> np.ndarray:
    """The table as the program's row: uint32 words, row after row."""
    return (table & MASK).to(torch.int64).cpu().numpy().astype(np.uint32).reshape(-1)


def cell_mismatches(row_words: np.ndarray, table: torch.Tensor) -> int:
    """Counters in which a program row differs from the reference's table:
    the first ``d * w`` words compared, every word past them must be 0."""
    ref = table_words(table)
    got = np.asarray(row_words).view(np.uint32).reshape(-1)
    n = ref.size
    if got.size < n:
        return n
    return int(np.count_nonzero(got[:n] != ref)) + int(np.count_nonzero(got[n:]))


class Done:
    """A completed call's answer, shaped as the program's futures."""

    def __init__(self, value):
        self._value = value

    def result(self, *a, **kw):
        return self._value

    def done(self) -> bool:
        return True


class CmsServer:
    """One count-min sketch answered by the reference, one call at a time.

    Controls, each breaking one guarantee the configuration states:
    ``hash32`` takes each half of the double hash from 32 hash bits, not
    64 (``cells``: the cells are not those of the 128-bit MurmurHash3);
    ``batch_final`` answers each event with the estimate after the whole
    call, as a vectorised ``add_all`` does, where the estimate at the
    event's own sequence point is due."""

    VARIANTS = ("exact", "hash32", "batch_final")

    def __init__(self, d: int, w: int, device, variant: str = "exact"):
        if variant not in self.VARIANTS:
            raise ValueError(f"unknown count-min control {variant!r}")
        self.d, self.w, self.variant = d, w, variant
        self.device = torch.device(device)
        self.hash_bits = 32 if variant == "hash32" else 64
        self.table = torch.zeros((d, w), dtype=torch.int64, device=self.device)
        self.count = 0
        self._lock = threading.Lock()

    def _cells(self, keys) -> torch.Tensor:
        return cells(to_i64(keys).to(self.device), self.d, self.w, self.hash_bits)

    def add_seq(self, keys: np.ndarray):
        with self._lock:
            c = self._cells(keys)
            if self.variant == "batch_final":
                add(self.table, c)
                est = estimate(self.table, c)
            else:
                est = add_seq(self.table, c)
            self.count += len(keys)
            return Done(est.cpu().numpy().astype(np.uint32))

    def top_k(self, keys: np.ndarray, k: int) -> list:
        """The ``k`` of ``keys`` (every key the stream can carry) with the
        largest estimates, heaviest first: ``[(key, estimate)]``."""
        with self._lock:
            est = estimate(self.table, self._cells(keys))
            top = torch.topk(est, min(k, est.numel())).indices.cpu().numpy()
            vals = est.cpu().numpy()
            return [(keys[i], int(vals[i])) for i in top]

    def row_words(self) -> np.ndarray:
        with self._lock:
            return table_words(self.table)
