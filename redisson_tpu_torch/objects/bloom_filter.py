"""BloomFilter — parity with org/redisson/api/RBloomFilter.java and
``redisson_tpu/objects/bloom_filter.py``: the same public shape, (m, k)
formulas and Kirsch–Mitzenmacher index math; add/contains ship one
vectorized device batch per call (coalesced across calls).
"""

from __future__ import annotations

import numpy as np

from redisson_tpu_torch.objects.base import MappedFuture, RObject, data_call
from redisson_tpu_torch.tenancy import PoolKind


class BloomFilter(RObject):
    KIND = PoolKind.BLOOM

    # Batch pipelining: sync-named calls ride these deferred forms inside
    # Batch.execute (their values keep the sync contracts).
    _DEFERRED = {
        "add": "add_deferred",
        "add_all": "add_all_deferred",
        "contains": "contains_deferred",
        "contains_all": "contains_all_deferred",
        "contains_each": "contains_all_async",
    }

    def add_deferred(self, obj):
        return MappedFuture(self.add_all_async([obj]), lambda v: bool(v[0]))

    def add_all_deferred(self, objs):
        return MappedFuture(self.add_all_async(objs), lambda v: int(np.sum(v)))

    def contains_deferred(self, obj):
        return MappedFuture(self.contains_all_async([obj]), lambda v: bool(v[0]))

    def contains_all_deferred(self, objs):
        return MappedFuture(self.contains_all_async(objs), lambda v: int(np.sum(v)))

    # -- lifecycle ---------------------------------------------------------

    def try_init(self, expected_insertions: int, false_probability: float) -> bool:
        """→ RBloomFilter#tryInit: returns False if already initialized."""
        return self._engine.bloom_try_init(
            self._name, expected_insertions, false_probability
        )

    def _params(self) -> dict:
        p = self._engine.params(self._name)
        if p is None:
            raise RuntimeError(f"bloom filter {self._name!r} is not initialized")
        return p

    def get_size(self) -> int:
        """→ RBloomFilter#getSize (bit count m)."""
        return self._params()["size"]

    def get_hash_iterations(self) -> int:
        return self._params()["hash_iterations"]

    def get_expected_insertions(self) -> int:
        return self._params()["expected_insertions"]

    def get_false_probability(self) -> float:
        return self._params()["false_probability"]

    # -- data path ---------------------------------------------------------

    def add(self, obj) -> bool:
        """→ RBloomFilter#add(T): True iff at least one bit was newly set.
        ``obj`` is ONE key (wrapped explicitly: a tuple is a legal single
        key under pickle-style codecs)."""
        return bool(self.add_all_async([obj]).result()[0])

    def add_all(self, objs) -> int:
        """→ RBloomFilter#add(Collection): number of newly-added elements."""
        return int(np.sum(self.add_all_async(objs).result()))

    @data_call
    def add_all_async(self, objs):
        return self._engine.bloom_add_encoded(self._name, *self._encode(objs))

    add_async = add_all_async

    def contains(self, obj) -> bool:
        """One key, explicitly wrapped (see add)."""
        return bool(self.contains_all_async([obj]).result()[0])

    def contains_all(self, objs) -> int:
        """→ RBloomFilter#contains(Collection): how many are (probably)
        present."""
        return int(np.sum(self.contains_each(objs)))

    def contains_each(self, objs) -> np.ndarray:
        """Vectorized membership: bool per input."""
        return self.contains_all_async(objs).result()

    @data_call
    def contains_all_async(self, objs):
        return self._engine.bloom_contains_encoded(self._name, *self._encode(objs))

    contains_async = contains_all_async

    @data_call
    def mixed_async(self, objs, flags):
        """Ordered add/contains mix in ONE engine call: ``flags[i]`` True
        adds ``objs[i]`` (result: newly added), False tests membership.
        Intra-batch sequencing matches issuing the ops one at a time."""
        return self._engine.bloom_mixed_encoded(
            self._name, *self._encode(objs), flags
        )

    def contains_many(self, batches) -> list:
        """Pipelined bulk membership (the RBatch idiom): dispatch every
        batch, then collect all results in one reply flush.  Returns one
        bool array per input batch."""
        futs = [self.contains_all_async(b) for b in batches]
        return self._client.collect(futs)

    # -- read replication and count ----------------------------------------

    def set_replicated(self) -> bool:
        """Copy this filter's row to every mesh shard (reads spread over
        the copies).  False on one card: there is nothing to spread over."""
        return self._engine.bloom_replicate(self._name)

    def is_replicated(self) -> bool:
        return self._engine.bloom_is_replicated(self._name)

    def count(self) -> int:
        """→ RBloomFilter#count: estimated number of inserted elements."""
        return int(self._engine.bloom_count(self._name).result())
