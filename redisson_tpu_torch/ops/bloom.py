"""Bloom filter ops over stacked multi-tenant bitmaps.

Counterpart of ``redisson_tpu/ops/bloom.py``: a batch of B keys is KM
index expansion, then one gather (contains) or one sort-based masked set
(add / mixed).  Pool layout: flat int32 ``[T*W + 1]`` (see
ops/bitops.py); per-op tenant rows route each key; ``k`` is fixed per
call.  Writes update the pool in place.
"""

from __future__ import annotations

import torch

from redisson_tpu_torch.ops import bitops


def _op_words(rows, idx, words_per_row: int):
    """(row, bit index) -> flat word index + bit-in-word, int64."""
    return rows.to(torch.int64) * words_per_row + (idx >> 5), idx & 31


def bloom_contains(flat, rows, h1m, h2m, *, m, k: int, words_per_row: int):
    """bool[B]: all k bits set per key."""
    idx = bitops.expand_km_indexes(h1m, h2m, m, k)
    gword, bit = _op_words(rows[:, None], idx, words_per_row)
    return bitops.gather_bits(flat, gword, bit).to(torch.bool).all(dim=1)


def bloom_mixed(flat, rows, h1m, h2m, is_add, *, m, k: int, words_per_row: int,
                valid=None):
    """Combined add+contains batch with exact sequential semantics.

    ``is_add`` bool[B] selects per op: an add sets its k bits and reports
    newly-added (some bit unset both pre-batch and by every earlier add in
    the batch); a contains writes nothing and reports membership at its
    sequence position.  ``valid``: optional bool[B] padding mask — invalid
    ops are routed to the scratch word.  Updates ``flat`` in place and
    returns the per-op result bool[B]."""
    idx = bitops.expand_km_indexes(h1m, h2m, m, k)
    gword, bit = _op_words(rows[:, None], idx, words_per_row)
    if valid is not None:
        gword = bitops.route_invalid_to_scratch(
            gword, valid[:, None], flat.shape[0]
        )
    wr = is_add[:, None].expand(idx.shape).reshape(-1)
    obs = bitops.scatter_set_bits_masked(
        flat, gword.reshape(-1), bit.reshape(-1), wr
    )
    all_set = (obs == 1).reshape(idx.shape).all(dim=1)
    return torch.where(is_add, ~all_set, all_set)


def bloom_add(flat, rows, h1m, h2m, *, m, k: int, words_per_row: int, valid=None):
    """Insert batch with exact sequential newly-added flags: the mixed op
    with every op an add."""
    is_add = torch.ones(h1m.shape[0], dtype=torch.bool, device=flat.device)
    return bloom_mixed(
        flat, rows, h1m, h2m, is_add,
        m=m, k=k, words_per_row=words_per_row, valid=valid,
    )


def bloom_cardinality(flat, row, *, words_per_row: int):
    """BITCOUNT of one tenant row (0-d int64 tensor): the set-bit count X
    that the host turns into ``-m/k * ln(1 - X/m)`` (RBloomFilter#count)."""
    return bitops.popcount_row(flat, row, words_per_row)


def bloom_clear_row(flat, row, *, words_per_row: int):
    """Zero one tenant's bitmap in place (RObject.delete)."""
    bitops.row_slice(flat, row, words_per_row).zero_()
