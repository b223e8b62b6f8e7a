"""BitSet — parity with org/redisson/api/RBitSet.java and
``redisson_tpu/objects/bitset.py``: Redis-bitmap semantics (auto-grow on
set, SETBIT returns the previous bit, BITCOUNT/BITPOS, cross-key BITOP
AND/OR/XOR/NOT, range set/clear).  Single-bit batches are vectorized;
range ops are word masks.
"""

from __future__ import annotations

import numpy as np

from redisson_tpu_torch.objects.base import RObject, data_call
from redisson_tpu_torch.tenancy import PoolKind


class BitSet(RObject):
    KIND = PoolKind.BITSET

    # Batch pipelining.
    _DEFERRED = {
        "set_many": "set_many_async",
        "get_many": "get_many_async",
    }

    # -- single/batch bit ops ---------------------------------------------

    def get(self, index: int) -> bool:
        return bool(self._engine.bitset_get(self._name, [index]).result()[0])

    def get_many(self, indexes) -> np.ndarray:
        return self.get_many_async(indexes).result()

    def set(self, index, value: bool = True) -> bool:
        """→ RBitSet#set(index, value): the previous bit (an array of
        them for an array of indexes)."""
        if np.ndim(index) == 0:
            return bool(
                self._engine.bitset_set(self._name, [int(index)], value).result()[0]
            )
        return self.set_many(np.asarray(index), value)

    def set_many(self, indexes, value: bool = True) -> np.ndarray:
        """Vectorized SETBIT: the previous bit per index."""
        return self.set_many_async(indexes, value).result()

    # RFuture-idiom async variants (→ RBitSetAsync#setAsync/getAsync).

    @data_call
    def get_many_async(self, indexes):
        return self._engine.bitset_get(self._name, self._indexes(indexes))

    @data_call
    def set_many_async(self, indexes, value: bool = True):
        return self._engine.bitset_set(self._name, self._indexes(indexes), value)

    def clear_bit(self, index: int) -> bool:
        """→ RBitSet#clear(index)."""
        return bool(
            self._engine.bitset_set(self._name, [int(index)], False).result()[0]
        )

    def flip(self, index: int) -> bool:
        """→ RBitSet#flip: the NEW bit (java semantics)."""
        prev = self._engine.bitset_flip(self._name, [int(index)]).result()[0]
        return not bool(prev)

    # -- ranges ------------------------------------------------------------

    def set_range(self, from_index: int, to_index: int) -> None:
        """→ RBitSet#set(from, to): [from, to) like the reference."""
        self._engine.bitset_set_range(self._name, from_index, to_index, True).result()

    def clear_range(self, from_index: int, to_index: int) -> None:
        self._engine.bitset_set_range(self._name, from_index, to_index, False).result()

    def clear(self, from_index=None, to_index=None) -> None:
        """→ RBitSet#clear() / clear(from, to)."""
        if from_index is None:
            self._engine.delete(self._name)
        else:
            self.clear_range(from_index, to_index)

    # -- queries -----------------------------------------------------------

    def cardinality(self) -> int:
        return self._engine.bitset_cardinality(self._name)

    def length(self) -> int:
        """Highest set bit + 1 (→ RBitSet#length)."""
        return self._engine.bitset_length(self._name)

    def size(self) -> int:
        """Allocated capacity in bits (→ RBitSet#size)."""
        return self._engine.bitset_capacity_bits(self._name)

    def is_empty(self) -> bool:
        return self.cardinality() == 0

    def first_set_bit(self) -> int:
        return self._engine.bitset_bitpos(self._name, 1)

    def first_clear_bit(self) -> int:
        return self._engine.bitset_bitpos(self._name, 0)

    # -- cross-key ops -----------------------------------------------------

    def and_op(self, *names: str) -> None:
        """→ RBitSet#and(String...): this &= and(others)."""
        self._engine.bitset_bitop(self._name, (self._name, *names), "and")

    def or_op(self, *names: str) -> None:
        self._engine.bitset_bitop(self._name, (self._name, *names), "or")

    def xor_op(self, *names: str) -> None:
        self._engine.bitset_bitop(self._name, (self._name, *names), "xor")

    def not_op(self) -> None:
        """→ RBitSet#not(): in-place complement over the logical length."""
        self._engine.bitset_bitop(self._name, (self._name,), "not")

    def to_byte_array(self) -> bytes:
        return self._engine.bitset_to_bytes(self._name)

    def as_bit_array(self) -> np.ndarray:
        """Bool array view (asBitSet analog)."""
        raw = np.frombuffer(self.to_byte_array(), dtype=np.uint8)
        return np.unpackbits(raw, bitorder="little").astype(bool)
