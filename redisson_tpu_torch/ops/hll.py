"""HyperLogLog ops over stacked tenant registers.

Counterpart of ``redisson_tpu/ops/hll.py``: registers are a flat
``uint8[T*16384 + 1]`` tensor (p = 14, values 0..51: Redis geometry);
PFADD is a scatter-max (idempotent, so duplicate registers need no
dedup), PFMERGE an elementwise max, and PFCOUNT a device histogram that
the host finalizes with the float64 Ertl estimator
(``golden.ertl_estimate``), so counts equal the golden model's.  Writes
update the pool in place.
"""

from __future__ import annotations

import math

import torch

from redisson_tpu_torch.ops import bitops
from redisson_tpu_torch.ops.golden import HLL_M, HLL_Q
from redisson_tpu_torch.utils.hashing import u32


def hll_index_rank_device(c0, c1, c2):
    """Device twin of ``golden.hll_index_rank``: uint32 lanes (int64 in
    ``[0, 2**32)`` or int32 bit-views) -> (register index int64, rank
    uint8).  rank = 51 - bit_length(c1 ++ top18(c2)); the 50-bit value is
    exact in float64, so ``frexp`` gives its bit length (float32 would
    round 2**32 - 1 up)."""
    idx = u32(c0) & (HLL_M - 1)
    u50 = (u32(c1) << 18) | (u32(c2) >> 14)
    rank = HLL_Q + 1 - bitops.bit_length(u50)
    return idx, rank.to(torch.uint8)


def _op_ranks(rows, c0, c1, c2, valid):
    """(flat register index, rank) per op; padded ops get rank 0, a no-op
    under max, so they need no scratch routing."""
    idx, rank = hll_index_rank_device(c0, c1, c2)
    if valid is not None:
        rank = torch.where(valid, rank, 0)
    return rows.to(torch.int64) * HLL_M + idx, rank


def hll_add(flat_regs, rows, c0, c1, c2, valid=None):
    """PFADD batch: scatter-max of ranks.  In place."""
    gidx, rank = _op_ranks(rows, c0, c1, c2, valid)
    bitops.scatter_max_onehot(flat_regs, gidx, rank)


def hll_histogram(flat_regs, row: int):
    """Register-value histogram int32[52] of one tenant."""
    regs = bitops.row_slice(flat_regs, row, HLL_M).to(torch.int64)
    hist = torch.zeros(HLL_Q + 2, dtype=torch.int32, device=flat_regs.device)
    return hist.index_add_(0, regs, torch.ones_like(regs, dtype=torch.int32))


def hll_histograms_all(regs2d):
    """Histograms of every tenant row: uint8[T, M] -> int32[T, 52]."""
    T = regs2d.shape[0]
    cell = (torch.arange(T, device=regs2d.device)[:, None] * (HLL_Q + 2)
            + regs2d.to(torch.int64)).reshape(-1)
    hist = torch.zeros(T * (HLL_Q + 2), dtype=torch.int32, device=regs2d.device)
    hist.index_add_(0, cell, torch.ones_like(cell, dtype=torch.int32))
    return hist.reshape(T, HLL_Q + 2)


def hll_merge_rows(flat_regs, dst_row: int, src_rows_regs):
    """PFMERGE: dst = max(dst, max over the pre-gathered source rows
    ``uint8[S, M]``).  In place."""
    dst = bitops.row_slice(flat_regs, dst_row, HLL_M)
    dst.copy_(torch.maximum(dst, src_rows_regs.amax(dim=0)))


def hll_merge(flat_regs, dst_row: int, src_rows):
    """PFMERGE with the source gather: ``src_rows`` int64[S]."""
    regs2d = flat_regs[:-1].view(-1, HLL_M)
    hll_merge_rows(flat_regs, dst_row, regs2d[src_rows])


def hll_add_changed(flat_regs, rows, c0, c1, c2, valid=None):
    """Multi-tenant PFADD with per-op "changed" flags of exact sequential
    semantics: op j changed its register iff its rank exceeds the
    register's value before the batch and every earlier op's rank on the
    same register.  A stable sort by register and a segmented exclusive
    max give that without a loop.  Updates in place; returns bool[B]."""
    gidx, rank = _op_ranks(rows, c0, c1, c2, valid)
    n = gidx.shape[0]
    sg, perm = torch.sort(gidx, stable=True)
    sr = rank[perm].to(torch.int32)
    pre = bitops.gather_words(flat_regs, sg).to(torch.int32)
    first = torch.ones(n, dtype=torch.bool, device=flat_regs.device)
    first[1:] = sg[1:] != sg[:-1]
    observed = torch.maximum(pre, bitops.segmented_exclusive_max(first, sr))
    changed = torch.empty(n, dtype=torch.bool, device=flat_regs.device)
    changed[perm] = sr > observed
    bitops.scatter_max_onehot(flat_regs, gidx, rank)
    return changed


def hll_add_single(flat_regs, row: int, c0, c1, c2, valid=None):
    """PFADD for one tenant; returns RHyperLogLog.add()'s boolean (0-d):
    did any register grow?  Registers only grow, so the row's register
    sum differs before and after iff something changed."""
    regs = bitops.row_slice(flat_regs, row, HLL_M)
    before = regs.sum(dtype=torch.int64)
    rows = torch.full(c0.shape, row, dtype=torch.int64, device=flat_regs.device)
    hll_add(flat_regs, rows, c0, c1, c2, valid=valid)
    return regs.sum(dtype=torch.int64) != before


def ertl_estimate_device(hist):
    """The Ertl estimator in float32 on the device, for batched counts:
    the JAX package's fixed-trip loops (64 for tau, 32 for sigma) in the
    same order of operations.  ``count()`` keeps the float64 host
    finalize (``golden.ertl_estimate``)."""
    f32 = dict(dtype=torch.float32, device=hist.device)
    m = torch.tensor(float(HLL_M), **f32)
    q = HLL_Q
    hist = hist.to(torch.float32)
    one = torch.tensor(1.0, **f32)

    x = 1.0 - hist[..., q + 1] / m
    x0, y, z = x, one, 1.0 - x
    for _ in range(64):
        x = torch.sqrt(x)
        y = 0.5 * y
        z = z - torch.square(1.0 - x) * y
    z_tau = torch.where((x0 == 0.0) | (x0 == 1.0), 0.0, z / 3.0)

    z = m * z_tau
    for kk in range(q, 0, -1):
        z = 0.5 * (z + hist[..., kk])

    xs = hist[..., 0] / m
    x, y, zs = xs, one, xs
    for _ in range(32):
        x = x * x
        zs = zs + x * y
        y = y + y
    z_sig = torch.where(xs == 1.0, float("inf"), zs)

    z = z + m * z_sig
    alpha_inf = torch.tensor(0.5 / math.log(2.0), **f32)
    return alpha_inf * m * m / z
