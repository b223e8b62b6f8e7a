"""BitSet ops — semantics of org/redisson/RedissonBitSet.java (Redis
bitmap SETBIT/GETBIT/BITCOUNT/BITPOS/BITOP/range set) on stacked tenant
bitmaps.

Counterpart of ``redisson_tpu/ops/bitset.py``.  Single-bit batches ride
the sort-based machinery of ``ops/bitops.py`` (exact sequential previous
values, duplicate-safe); range ops are word masks over the row; BITOP
runs elementwise on gathered rows.  Pool layout: flat int32 ``[T*W + 1]``
bit-views of uint32 words.  Writes update the pool in place.
"""

from __future__ import annotations

import torch

from redisson_tpu_torch.ops import bitops
from redisson_tpu_torch.utils.hashing import u32

# Opcode encoding of bitset_mixed: (b << 1) | a of the bit map
# x -> a ^ (b & x) each op applies to its bit.
OP_CLEAR, OP_SET, OP_GET, OP_FLIP = 0, 1, 2, 3


def _flat(rows, idx, words_per_row: int):
    """(row, bit index) -> flat word index + bit-in-word, int64."""
    idx = u32(idx)
    return rows.to(torch.int64) * words_per_row + (idx >> 5), idx & 31


def bitset_get(flat_words, rows, idx, *, words_per_row: int):
    gw, bt = _flat(rows, idx, words_per_row)
    return bitops.gather_bits(flat_words, gw, bt).to(torch.bool)


def _write(scatter, flat_words, rows, idx, words_per_row: int, valid):
    gw, bt = _flat(rows, idx, words_per_row)
    gw = bitops.route_invalid_to_scratch(gw, valid, flat_words.shape[0])
    return scatter(flat_words, gw, bt).to(torch.bool)


def bitset_set(flat_words, rows, idx, *, words_per_row: int, valid=None):
    return _write(bitops.scatter_set_bits, flat_words, rows, idx, words_per_row, valid)


def bitset_clear(flat_words, rows, idx, *, words_per_row: int, valid=None):
    return _write(bitops.scatter_clear_bits, flat_words, rows, idx, words_per_row, valid)


def bitset_flip(flat_words, rows, idx, *, words_per_row: int, valid=None):
    return _write(bitops.scatter_flip_bits, flat_words, rows, idx, words_per_row, valid)


def bitset_mixed(flat_words, rows, idx, opcodes, *, words_per_row: int, valid=None):
    """Unified single-bit batch: a per-op opcode in {OP_GET, OP_SET,
    OP_CLEAR, OP_FLIP}.  Exact sequential semantics: every op observes the
    bit just before its own application.  Returns observed bool[B]."""
    gw, bt = _flat(rows, idx, words_per_row)
    gw = bitops.route_invalid_to_scratch(gw, valid, flat_words.shape[0])
    opcodes = u32(opcodes)
    obs = bitops.scatter_bit_affine(flat_words, gw, bt, (opcodes >> 1) & 1, opcodes & 1)
    return obs.to(torch.bool)


def bitset_set_range(flat_words, row: int, from_bit: int, to_bit: int, *,
                     words_per_row: int, value: bool = True):
    """set(from, to) / clear(from, to) as one word mask over the row."""
    mask = bitops.range_mask_words(words_per_row, from_bit, to_bit, flat_words.device)
    cur = bitops.row_slice(flat_words, row, words_per_row)
    cur.copy_((cur | mask) if value else (cur & ~mask))


def bitset_cardinality(flat_words, row: int, *, words_per_row: int):
    return bitops.popcount_row(flat_words, row, words_per_row)


def bitset_length(flat_words, row: int, *, words_per_row: int):
    return bitops.bit_length_row(flat_words, row, words_per_row)


def bitset_bitpos(flat_words, row: int, *, words_per_row: int, target_bit: int):
    return bitops.bitpos_row(flat_words, row, words_per_row, target_bit)


def bitset_bitop(flat_words, dst_row: int, src_rows_words, *, words_per_row: int,
                 op: str, limit_bits=None):
    """BITOP dst = op(src_1, ..., src_n) on pre-gathered rows
    ``int32[S, W]``.  ``not`` takes the first source only (Redis BITOP NOT
    is unary) and complements exactly its logical length ``limit_bits``:
    bits beyond it stay 0, so a size-class row's untouched tail stays
    clear."""
    if op == "and":
        res = src_rows_words[0]
        for i in range(1, src_rows_words.shape[0]):
            res = res & src_rows_words[i]
    elif op == "or":
        res = src_rows_words[0]
        for i in range(1, src_rows_words.shape[0]):
            res = res | src_rows_words[i]
    elif op == "xor":
        res = src_rows_words[0]
        for i in range(1, src_rows_words.shape[0]):
            res = res ^ src_rows_words[i]
    elif op == "not":
        res = ~src_rows_words[0]
        if limit_bits is not None:
            res = res & bitops.range_mask_words(
                words_per_row, 0, limit_bits, flat_words.device)
    else:
        raise ValueError(f"unknown bitop: {op}")
    bitops.row_update(flat_words, dst_row, res, words_per_row)


def bitset_get_row(flat_words, row: int, *, words_per_row: int):
    """Raw bitmap of one row (asBitSet()/toByteArray()), as a copy: later
    launches update the pool in place."""
    return bitops.row_slice(flat_words, row, words_per_row).clone()


def bitset_bitop_rows(flat_words, dst_row: int, src_rows, *, words_per_row: int,
                      op: str, limit_bits=None):
    """BITOP with the source gather: ``src_rows`` int64[S]."""
    rows2d = flat_words[:-1].view(-1, words_per_row)
    bitset_bitop(flat_words, dst_row, rows2d[src_rows],
                 words_per_row=words_per_row, op=op, limit_bits=limit_bits)
