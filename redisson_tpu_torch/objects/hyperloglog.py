"""HyperLogLog — parity with org/redisson/api/RHyperLogLog.java and
``redisson_tpu/objects/hyperloglog.py``: PFADD/PFCOUNT/PFMERGE with Redis
geometry (p = 14, registers 0..51) and the Ertl estimator; the register
math runs on the device (ops/hll.py).
"""

from __future__ import annotations

from redisson_tpu_torch.objects.base import MappedFuture, RObject
from redisson_tpu_torch.tenancy import PoolKind


class HyperLogLog(RObject):
    KIND = PoolKind.HLL

    # Batch pipelining: sync-named adds coalesce.
    _DEFERRED = {
        "add": "add_deferred",
        "add_all": "add_deferred_all",
    }

    def add_deferred(self, obj):
        return MappedFuture(self.add_all_async([obj]), bool)

    def add_deferred_all(self, objs):
        return MappedFuture(self.add_all_async(objs), bool)

    def add(self, obj) -> bool:
        """→ RHyperLogLog#add: True iff the estimate changed (a register
        grew).  ``obj`` is ONE key, wrapped explicitly: a tuple is a legal
        single key under pickle-style codecs."""
        return bool(self.add_all_async([obj]).result())

    def add_all(self, objs) -> bool:
        """→ RHyperLogLog#addAll(Collection)."""
        return bool(self.add_all_async(objs).result())

    def add_all_async(self, objs):
        return self._engine.hll_add_encoded(self._name, *self._encode(objs))

    add_async = add_all_async

    def count(self) -> int:
        """→ RHyperLogLog#count (PFCOUNT)."""
        return int(self._engine.hll_count(self._name).result())

    def count_with(self, *other_names: str) -> int:
        """→ RHyperLogLog#countWith (PFCOUNT key [key ...]): the union's
        cardinality, changing no operand."""
        return self._engine.hll_count_with(self._name, other_names)

    def merge_with(self, *other_names: str) -> None:
        """→ RHyperLogLog#mergeWith (PFMERGE)."""
        self._engine.hll_merge_with(self._name, other_names)
