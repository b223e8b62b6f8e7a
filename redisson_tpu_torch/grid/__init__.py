"""Host data grid — the broader RObject catalog beside the sketch objects,
the port's copy of ``redisson_tpu/grid``: the keyspace store (name ->
kind, value, TTL; WRONGTYPE guards; snapshot codec), RKeys over both
backends, buckets and counters, maps and multimaps, sets, lists and
sorted sets, queues, streams, geo, time series, topics, and the Batch
facade.  Locks, services, cron, JCache and the local cached map are not
ported yet.
"""

from redisson_tpu_torch.grid.store import GridStore
from redisson_tpu_torch.grid.buckets import BinaryStream, Bucket, Buckets
from redisson_tpu_torch.grid.counters import (
    AtomicDouble,
    AtomicLong,
    DoubleAdder,
    IdGenerator,
    LongAdder,
)
from redisson_tpu_torch.grid.maps import Map, MapCache
from redisson_tpu_torch.grid.multimaps import (
    ListMultimap,
    ListMultimapCache,
    SetMultimap,
    SetMultimapCache,
)
from redisson_tpu_torch.grid.streams import ReliableTopic, Stream
from redisson_tpu_torch.grid.collections import (
    LexSortedSet,
    List_,
    ScoredSortedSet,
    Set_,
    SetCache,
    SortedSet,
)
from redisson_tpu_torch.grid.queues import (
    BlockingDeque,
    BlockingQueue,
    DelayedQueue,
    Deque,
    PriorityBlockingQueue,
    PriorityDeque,
    PriorityQueue,
    Queue,
    RingBuffer,
    TransferQueue,
)
from redisson_tpu_torch.grid.geo import Geo
from redisson_tpu_torch.grid.timeseries import TimeSeries
from redisson_tpu_torch.grid.topics import (
    PatternTopic,
    ShardedTopic,
    Topic,
    TopicBus,
)
from redisson_tpu_torch.grid.keys import Keys
from redisson_tpu_torch.grid.batch import Batch, BatchFuture, BatchResult

__all__ = [
    "GridStore",
    "Bucket", "Buckets", "BinaryStream",
    "AtomicLong", "AtomicDouble", "LongAdder", "DoubleAdder", "IdGenerator",
    "Map", "MapCache",
    "ListMultimap", "SetMultimap", "ListMultimapCache", "SetMultimapCache",
    "Stream", "ReliableTopic",
    "Set_", "SetCache", "List_", "SortedSet", "ScoredSortedSet", "LexSortedSet",
    "Queue", "Deque", "BlockingQueue", "BlockingDeque", "DelayedQueue",
    "PriorityQueue", "PriorityBlockingQueue", "PriorityDeque",
    "TransferQueue", "RingBuffer",
    "Geo", "TimeSeries",
    "Topic", "PatternTopic", "ShardedTopic", "TopicBus",
    "Keys", "Batch", "BatchFuture", "BatchResult",
]
