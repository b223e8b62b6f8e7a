"""Host data grid — the broader RObject catalog beside the sketch objects,
the port's copy of ``redisson_tpu/grid``: the keyspace store (name ->
kind, value, TTL; WRONGTYPE guards; snapshot codec), RKeys over both
backends, buckets and counters, maps and multimaps, sets, lists and
sorted sets, queues, streams, geo, time series, topics, the Batch
facade, the local cached map and JCache, locks and synchronizers, and the
coordination services (executor with cron schedules, remote, transaction,
script, function, live objects, map-reduce).
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
from redisson_tpu_torch.grid.local_cached_map import LocalCachedMap
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
from redisson_tpu_torch.grid.jcache import CacheManager, JCache
from redisson_tpu_torch.grid.locks import (
    CountDownLatch,
    FairLock,
    FencedLock,
    Lock,
    MultiLock,
    PermitExpirableSemaphore,
    RateLimiter,
    ReadWriteLock,
    Semaphore,
    SpinLock,
)
from redisson_tpu_torch.grid.keys import Keys
from redisson_tpu_torch.grid.batch import Batch, BatchFuture, BatchResult
from redisson_tpu_torch.grid.services import (
    ExecutorService,
    FunctionService,
    LiveObjectService,
    MapReduce,
    RemoteService,
    ScriptService,
    Transaction,
    TransactionException,
)

__all__ = [
    "GridStore",
    "Bucket", "Buckets", "BinaryStream",
    "AtomicLong", "AtomicDouble", "LongAdder", "DoubleAdder", "IdGenerator",
    "Map", "MapCache", "LocalCachedMap",
    "ListMultimap", "SetMultimap", "ListMultimapCache", "SetMultimapCache",
    "Stream", "ReliableTopic",
    "Set_", "SetCache", "List_", "SortedSet", "ScoredSortedSet", "LexSortedSet",
    "Queue", "Deque", "BlockingQueue", "BlockingDeque", "DelayedQueue",
    "PriorityQueue", "PriorityBlockingQueue", "PriorityDeque",
    "TransferQueue", "RingBuffer",
    "Geo", "TimeSeries", "JCache", "CacheManager",
    "Topic", "PatternTopic", "ShardedTopic", "TopicBus",
    "Lock", "FairLock", "SpinLock", "FencedLock", "MultiLock",
    "ReadWriteLock", "Semaphore", "PermitExpirableSemaphore",
    "CountDownLatch", "RateLimiter",
    "Keys", "Batch", "BatchFuture", "BatchResult",
    "ExecutorService", "RemoteService", "Transaction", "TransactionException",
    "ScriptService", "FunctionService", "LiveObjectService", "MapReduce",
]
