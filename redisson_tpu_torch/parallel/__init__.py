"""Sharding and replication over a mesh of logical shards.

Counterpart of ``redisson_tpu/parallel``.  The JAX package's
distribution axes map here as there:

- cluster slot-sharding becomes **tenant sharding**: tenant row r lives
  on shard ``r % S``;
- a giant single key (a 2**30-bit RBitSet) shards along its words
  (**m-sharding**);
- read replication and cross-key BITOP/PFMERGE/CMS.MERGE become
  reductions over the ``[S, local_len]`` stack.

The S shards of a mesh share one torch device (``MeshContext``).
"""

from redisson_tpu_torch.parallel.mesh import (
    MeshContext,
    sharded_bloom_add,
    sharded_bloom_contains,
    sharded_hll_add,
    sharded_hll_histogram,
    sharded_mbit_get,
    sharded_mbit_set,
)

__all__ = [
    "MeshContext",
    "sharded_bloom_add",
    "sharded_bloom_contains",
    "sharded_hll_add",
    "sharded_hll_histogram",
    "sharded_mbit_get",
    "sharded_mbit_set",
]
