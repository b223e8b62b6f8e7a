"""Count-min sketch ops: the vectorized path with batch-final estimates.

Counterpart of ``redisson_tpu/ops/cms.py``.  Per tenant, ``d`` rows ×
``w`` counters stacked in a flat int32 pool (uint32 bit-views); update
is a scatter-add (duplicates in a batch each count), estimate is a
gather + unsigned min over rows.  Row r of key x uses cell
``(h1 + r*h2) mod w`` (the KM expansion with the per-row stride).
Streaming estimates in op order are ``ops/cms_seq.py``.  Merge is the
elementwise uint32 sum of rows (a CMS is linear), wrapping mod 2**32 as
the JAX package's uint32 sum does.
"""

from __future__ import annotations

import torch

from redisson_tpu_torch.ops import bitops
from redisson_tpu_torch.utils.hashing import u32


def _cell_indexes(rows, h1w, h2w, *, d: int, w: int, cells_per_row: int):
    """int64[B, d] flat cell indexes; h1w/h2w pre-reduced mod w.
    ``cells_per_row`` is the pool row stride (padded to a multiple of 128
    by the registry, so it may exceed d*w)."""
    idx = bitops.expand_km_indexes(u32(h1w), u32(h2w), w, d)
    depth = w * torch.arange(d, dtype=torch.int64, device=idx.device)
    base = rows.to(torch.int64)[:, None] * cells_per_row
    return base + depth[None, :] + idx


def cms_update(flat, rows, h1w, h2w, weights, *, d: int, w: int, cells_per_row: int):
    """Add ``weights[B]`` (uint32 values) to each key's d cells, in place."""
    cells = _cell_indexes(rows, h1w, h2w, d=d, w=w, cells_per_row=cells_per_row)
    upd = weights[:, None].expand(cells.shape)
    bitops.scatter_add_u32(flat, cells.reshape(-1), upd.reshape(-1))


def cms_estimate(flat, rows, h1w, h2w, *, d: int, w: int, cells_per_row: int):
    """Point estimates: unsigned min over the d cells, as int32 bit-views."""
    cells = _cell_indexes(rows, h1w, h2w, d=d, w=w, cells_per_row=cells_per_row)
    return bitops.to_i32(u32(flat[cells]).min(dim=1).values)


def cms_update_and_estimate(flat, rows, h1w, h2w, weights, *, d: int, w: int,
                            cells_per_row: int):
    """Apply the updates, then return post-update (batch-final) estimates
    for the same keys."""
    cms_update(flat, rows, h1w, h2w, weights, d=d, w=w, cells_per_row=cells_per_row)
    return cms_estimate(flat, rows, h1w, h2w, d=d, w=w, cells_per_row=cells_per_row)


def cms_merge_rows(flat, dst_row, src_rows_counts, *, cells_per_row: int):
    """dst row += sum of ``src_rows_counts`` ([S, cells_per_row] int32
    bit-views), in place, mod 2**32: summed in int64, masked to 32 bits
    (uint32 has no add on every torch device)."""
    dst = bitops.row_slice(flat, dst_row, cells_per_row)
    total = u32(dst) + u32(src_rows_counts).sum(dim=0)
    dst.copy_(bitops.to_i32(total))


def cms_merge(flat, dst_row, src_rows, *, cells_per_row: int):
    """Merge with the sources gathered on the device: ``src_rows`` is an
    int64 tensor of tenant rows (the gather copies them, so ``dst_row``
    may be among them)."""
    rows2d = flat[:-1].view(-1, cells_per_row)
    cms_merge_rows(flat, dst_row, rows2d[src_rows], cells_per_row=cells_per_row)


def cms_clear_row(flat, row, *, cells_per_row: int):
    bitops.row_slice(flat, row, cells_per_row).zero_()
