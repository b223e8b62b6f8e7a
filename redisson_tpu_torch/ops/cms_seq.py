"""Sequential count-min update+estimate (kernel K1) — the streaming
heavy-hitter step of ``CountMinSketch.add_all_seq``.

Counterpart of ``redisson_tpu/ops/pallas_cms.py``.  Op j's estimate is
its at-sequence-point value: ops <= j applied (its own included), later
ops excluded — five adds of one key return 1, 2, 3, 4, 5.  Weight 0 is a
pure estimate.  The minimum over rows is UNSIGNED, as in ``golden_seq``
(the Pallas kernel takes it in int32, so it agrees only below 2**31).

``cms_update_estimate_seq`` is the wrapper: a CPU tensor takes the plain
PyTorch version below, a CUDA tensor launches the hand-written kernel in
``csrc/cms_seq.cu`` (and raises if it cannot build or launch).  Both
update the table in place.  The kernel cuts each depth row into tiles
held in shared memory, one (row, tile) work item per block; ``_plan``
sizes the tiles and the grid from (d, w) and the card's SM count, and the
wrapper passes them to the launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from redisson_tpu_torch.ops import _build, bitops
from redisson_tpu_torch.utils.hashing import u32

# Kernel launches since the last reset (the CUDA branch only).
LAUNCHES = 0


# The kernel's fixed shape (csrc/cms_seq.cu): 16 warps, one walks and 15
# filter; ops stream in chunks of 15 * 32 * 8, through two list buffers of
# (cell, weight, op) words, beside 16 warp counts and 2 list lengths.
CHUNK = 15 * 32 * 8
SMEM_FIXED = 4 * (6 * CHUNK + 16 + 2)
SMEM_PER_BLOCK = 232_448  # shared memory one block may take on Hopper
TILE_ALIGN = 32  # tile widths are whole warps of cells


class Plan(NamedTuple):
    tile_w: int  # cells per tile (a multiple of TILE_ALIGN)
    tiles_per_row: int  # the last tile of a row may be ragged
    n_work: int  # d * tiles_per_row (row, tile) work items
    grid: int  # blocks, one per SM at most; each walks work items grid-stride
    smem: int  # dynamic shared memory per block, bytes


def _plan(d: int, w: int, n_sm: int = 132) -> Plan:
    """Tiles for a d x w table on a card with ``n_sm`` SMs: about one
    work item per SM, no tile wider than shared memory allows.  A block's
    512 threads take most of an SM's registers, so one block runs per
    SM."""
    max_tile = (SMEM_PER_BLOCK - SMEM_FIXED) // 4 // TILE_ALIGN * TILE_ALIGN
    per_row = max(1, n_sm // d)
    tile_w = -(-w // per_row)
    tile_w = min(-(-tile_w // TILE_ALIGN) * TILE_ALIGN, max_tile)
    tiles_per_row = -(-w // tile_w)
    n_work = d * tiles_per_row
    return Plan(tile_w, tiles_per_row, n_work, min(n_work, n_sm), 4 * tile_w + SMEM_FIXED)


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cms_seq_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.cms_seq_launch.restype = i
    lib.cms_seq_smem_bytes.argtypes = [i]
    lib.cms_seq_smem_bytes.restype = i


def _check(table, h1w, h2w, weights, d: int, w: int) -> int:
    B = h1w.shape[0]
    for name, t in (("table", table), ("h1w", h1w), ("h2w", h2w),
                    ("weights", weights)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on {table.device}")
    if h2w.shape[0] != B or weights.shape[0] != B:
        raise ValueError("h1w, h2w and weights must have one length")
    if d < 1 or w < 1 or d * w > table.shape[0] or d * w >= 1 << 31:
        raise ValueError(f"bad geometry d={d} w={w} for {table.shape[0]} cells")
    if B >= 1 << 31:
        raise ValueError(f"batch of {B} ops is too large for one launch")
    return B


def cms_update_estimate_seq(table, h1w, h2w, weights, *, d: int, w: int):
    """Streaming update+estimate against ``table`` (int32 bit-views of the
    tenant's uint32[d, w] counters, flat, updated in place).  ``h1w``,
    ``h2w``: int32[B] pre-reduced mod w; ``weights``: int32[B] bit-views.
    Returns est int32[B] (uint32 bit-views)."""
    global LAUNCHES
    B = _check(table, h1w, h2w, weights, d, w)
    if table.device.type == "cpu":
        return cms_seq_plain(table, h1w, h2w, weights, d=d, w=w)
    if table.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {table.device}")
    est = torch.full((B,), -1, dtype=torch.int32, device=table.device)
    if B == 0:
        return est
    lib = _build.load("cms_seq", _bind)
    with torch.cuda.device(table.device):
        n_sm = torch.cuda.get_device_properties(table.device).multi_processor_count
        plan = _plan(d, w, n_sm)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cms_seq_launch(
            table.data_ptr(), h1w.data_ptr(), h2w.data_ptr(),
            weights.data_ptr(), est.data_ptr(), B, d, w,
            plan.tile_w, plan.tiles_per_row, plan.grid, stream,
        )
    if rc != 0:
        raise RuntimeError(f"cms_seq kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return est


def cms_seq_plain(table, h1w, h2w, weights, *, d: int, w: int):
    """Plain PyTorch version: exact and vectorized over ops.  For each row
    r, a stable sort of the ops by cell puts each cell's ops in arrival
    order; op j then sees the pre-batch cell plus the inclusive cumsum of
    its run's weights (global int64 cumsum minus the cumsum before the run
    start).  The estimate is the unsigned min over rows; each cell ends at
    pre + its run total, mod 2**32.  Updates ``table`` in place."""
    B = h1w.shape[0]
    dev = table.device
    h1, h2, wt = u32(h1w), u32(h2w), u32(weights)
    est = torch.full((B,), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    idx = h1
    for r in range(d):
        if r:
            idx = idx + h2
            idx = torch.where(idx >= w, idx - w, idx)
        cell, perm = torch.sort(r * w + idx, stable=True)
        swt = wt[perm]
        csum = torch.cumsum(swt, 0)
        first = torch.ones(B, dtype=torch.bool, device=dev)
        first[1:] = cell[1:] != cell[:-1]
        start = bitops.run_starts(first)
        val = (u32(table[cell]) + csum - (csum[start] - swt[start])) & 0xFFFFFFFF
        last = torch.ones(B, dtype=torch.bool, device=dev)
        last[:-1] = first[1:]
        table[cell[last]] = bitops.to_i32(val[last])
        est[perm] = torch.minimum(est[perm], val)
    return bitops.to_i32(est)


def golden_seq(table: np.ndarray, h1w, h2w, weights, *, d: int, w: int):
    """NumPy twin: the exact sequential semantics K1 implements (a copy of
    the JAX package's ``pallas_cms.golden_seq``)."""
    table = table.copy()
    est = np.zeros(len(h1w), np.uint32)
    for j in range(len(h1w)):
        vals = []
        idx = int(h1w[j])
        for r in range(d):
            if r:
                idx += int(h2w[j])
                if idx >= w:
                    idx -= w
            table[r, idx] += int(weights[j])
            vals.append(table[r, idx])
        est[j] = min(vals)
    return table, est
