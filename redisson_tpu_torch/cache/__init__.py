"""Host-side caching tier of the port (counterpart of
``redisson_tpu/cache``).

- ``ShardedLRUStore`` — the bounded, multi-tenant, sharded LRU eviction
  implementation behind the near cache.
- ``SketchNearCache`` — the epoch-guarded read tier threaded through the
  sketch engine: monotone positives cache structural-epoch-free, every
  other result class is write-epoch-tagged.
"""

from redisson_tpu_torch.cache.lru import MISS, ShardedLRUStore
from redisson_tpu_torch.cache.nearcache import SketchNearCache

__all__ = ["MISS", "ShardedLRUStore", "SketchNearCache"]
