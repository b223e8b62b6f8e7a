"""RedissonTorchClient — the entry-point facade of the port.

Parity with ``redisson_tpu/client.py`` for what this package carries:
the sketch objects (``get_bloom_filter``, ``get_hyper_log_log``,
``get_bit_set``, ``get_count_min_sketch``) on the engine, and the host
grid over one logical keyspace spanning both backends: buckets, counters
and RKeys; maps, multimaps, sets, lists and sorted sets; the queue
family; streams, geo and time series; topics on the client's delivery
bus (``get_topic``, ``get_pattern_topic``, ``get_sharded_topic``,
``get_reliable_topic``); plus ``create_batch``, ``collect``,
``defer_fetch``, ``op_deadline``, ``prewarm_wait``, ``snapshot`` and
``shutdown``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

from redisson_tpu_torch import overload
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.grid import (
    AtomicDouble,
    AtomicLong,
    Batch,
    BinaryStream,
    BlockingDeque,
    BlockingQueue,
    Bucket,
    Buckets,
    DelayedQueue,
    Deque,
    DoubleAdder,
    Geo,
    GridStore,
    IdGenerator,
    Keys,
    LexSortedSet,
    List_,
    ListMultimap,
    ListMultimapCache,
    LongAdder,
    Map,
    MapCache,
    PatternTopic,
    PriorityBlockingQueue,
    PriorityDeque,
    PriorityQueue,
    Queue,
    ReliableTopic,
    RingBuffer,
    ScoredSortedSet,
    Set_,
    SetCache,
    SetMultimap,
    SetMultimapCache,
    ShardedTopic,
    SortedSet,
    Stream,
    TimeSeries,
    Topic,
    TopicBus,
    TransferQueue,
)
from redisson_tpu_torch.objects import BitSet, BloomFilter, CountMinSketch, HyperLogLog
from redisson_tpu_torch.objects.base import CamelCompatMixin
from redisson_tpu_torch.objects.engines import TorchSketchEngine


class RedissonTorchClient(CamelCompatMixin):
    def __init__(self, config: Config):
        if not config.gpu_sketch.enabled:
            raise ValueError(
                "redisson_tpu_torch runs sketches on the torch backend only: "
                "call Config().use_gpu_sketch()"
            )
        self.config = config
        self._engine = TorchSketchEngine(config)
        # The RESP front door records into the engine's registry, so one
        # exposition carries both.
        self.obs = self._engine.obs
        self._grid = GridStore()
        # One logical keyspace across both backends: creating an object
        # under a name the other backend holds is WRONGTYPE.  Wired to
        # the lock-free ``probe`` on each side — guards run while holding
        # the caller's own lock, so a locking lookup would deadlock.
        self._engine.foreign_exists = self._grid.probe
        self._grid.foreign_exists = self._engine.probe
        # Store-level identity changes of grid names retire their cached
        # near-cache entries ("grid:"-prefixed tenants).
        nc = self._engine.nearcache
        self._grid.on_invalidate = lambda name: nc.drop_object("grid:" + name)
        self._grid.on_invalidate_all = nc.invalidate_all
        # Restore-on-create for the host keyspace too (the sketch side
        # restored inside the engine): one snapshot directory carries the
        # whole logical keyspace, the periodic snapshotter's included.
        if config.snapshot_dir:
            try:
                self._grid.restore_from(
                    os.path.join(config.snapshot_dir, "grid_store.bin")
                )
            except Exception:
                # The engine is already running (threads, device state,
                # maybe an armed snapshotter that would overwrite the
                # files being debugged): tear it down before failing.
                self._engine.shutdown()
                raise
            self._engine.snapshot_extra = lambda d: self._grid.snapshot_to(
                os.path.join(d, "grid_store.bin")
            )
        # Pub/sub delivery pool (the PublishSubscribeService analog):
        # topic listeners run here, the RTopic -> CMS ingest bridge too.
        self._topic_bus = TopicBus(n_threads=config.threads)

    def get_bloom_filter(self, name: str) -> BloomFilter:
        return BloomFilter(name, self)

    def get_hyper_log_log(self, name: str) -> HyperLogLog:
        return HyperLogLog(name, self)

    def get_bit_set(self, name: str) -> BitSet:
        return BitSet(name, self)

    def get_count_min_sketch(self, name: str) -> CountMinSketch:
        return CountMinSketch(name, self)

    # -- buckets / counters (host grid) ------------------------------------

    def get_bucket(self, name: str) -> Bucket:
        return Bucket(name, self)

    def get_buckets(self) -> Buckets:
        return Buckets(self)

    def get_binary_stream(self, name: str) -> BinaryStream:
        return BinaryStream(name, self)

    def get_atomic_long(self, name: str) -> AtomicLong:
        return AtomicLong(name, self)

    def get_atomic_double(self, name: str) -> AtomicDouble:
        return AtomicDouble(name, self)

    def get_long_adder(self, name: str) -> LongAdder:
        return LongAdder(name, self)

    def get_double_adder(self, name: str) -> DoubleAdder:
        return DoubleAdder(name, self)

    def get_id_generator(self, name: str) -> IdGenerator:
        return IdGenerator(name, self)

    # -- maps / multimaps ---------------------------------------------------

    def get_map(self, name: str) -> Map:
        return Map(name, self)

    def get_map_cache(self, name: str) -> MapCache:
        return MapCache(name, self)

    def get_list_multimap(self, name: str) -> ListMultimap:
        return ListMultimap(name, self)

    def get_set_multimap(self, name: str) -> SetMultimap:
        return SetMultimap(name, self)

    def get_list_multimap_cache(self, name: str) -> ListMultimapCache:
        return ListMultimapCache(name, self)

    def get_set_multimap_cache(self, name: str) -> SetMultimapCache:
        return SetMultimapCache(name, self)

    # -- sets / lists ------------------------------------------------------

    def get_set(self, name: str) -> Set_:
        return Set_(name, self)

    def get_set_cache(self, name: str) -> SetCache:
        return SetCache(name, self)

    def get_list(self, name: str) -> List_:
        return List_(name, self)

    def get_sorted_set(self, name: str) -> SortedSet:
        return SortedSet(name, self)

    def get_scored_sorted_set(self, name: str) -> ScoredSortedSet:
        return ScoredSortedSet(name, self)

    def get_lex_sorted_set(self, name: str) -> LexSortedSet:
        return LexSortedSet(name, self)

    # -- queues ------------------------------------------------------------

    def get_queue(self, name: str) -> Queue:
        return Queue(name, self)

    def get_deque(self, name: str) -> Deque:
        return Deque(name, self)

    def get_blocking_queue(self, name: str) -> BlockingQueue:
        return BlockingQueue(name, self)

    def get_blocking_deque(self, name: str) -> BlockingDeque:
        return BlockingDeque(name, self)

    def get_delayed_queue(self, destination_queue) -> DelayedQueue:
        """→ RedissonClient#getDelayedQueue(RQueue): feeds the given queue."""
        return DelayedQueue(
            f"{destination_queue.get_name()}:delayed", self, destination_queue
        )

    def get_priority_queue(self, name: str) -> PriorityQueue:
        return PriorityQueue(name, self)

    def get_priority_blocking_queue(self, name: str) -> PriorityBlockingQueue:
        return PriorityBlockingQueue(name, self)

    def get_priority_deque(self, name: str) -> PriorityDeque:
        return PriorityDeque(name, self)

    def get_transfer_queue(self, name: str) -> TransferQueue:
        return TransferQueue(name, self)

    def get_ring_buffer(self, name: str) -> RingBuffer:
        return RingBuffer(name, self)

    # -- streams / geo / time series ---------------------------------------

    def get_stream(self, name: str) -> Stream:
        """→ RedissonClient#getStream (XADD/XREADGROUP family)."""
        return Stream(name, self)

    def get_geo(self, name: str) -> Geo:
        return Geo(name, self)

    def get_time_series(self, name: str) -> TimeSeries:
        return TimeSeries(name, self)

    # -- messaging ---------------------------------------------------------

    def get_topic(self, name: str) -> Topic:
        return Topic(name, self)

    def get_sharded_topic(self, name: str) -> ShardedTopic:
        return ShardedTopic(name, self)

    def get_pattern_topic(self, pattern: str) -> PatternTopic:
        return PatternTopic(pattern, self)

    def get_reliable_topic(self, name: str) -> ReliableTopic:
        """→ RedissonClient#getReliableTopic (stream-backed, at-least-once)."""
        return ReliableTopic(name, self)

    def get_keys(self) -> Keys:
        """→ RedissonClient#getKeys: RKeys over both backends."""
        return Keys(self)

    def create_batch(self) -> Batch:
        """→ RedissonClient#createBatch: the deferred-execution facade."""
        return Batch(self)

    def collect(self, futures) -> list:
        """Resolve a group of issued async results with one reply flush:
        device results of one shape come home in one D2H."""
        futures = list(futures)
        self._engine.collect_results(futures)
        return [f.result() for f in futures]

    def defer_fetch(self):
        """Context manager for a bulk-dispatch region whose results are
        resolved with :meth:`collect`.  The JAX package's results start an
        eager per-launch host copy that this suppresses; results here are
        fetched only on ``.result()`` or ``collect``, so it has nothing to
        suppress and is a no-op, kept for the same client code."""
        return contextlib.nullcontext()

    def op_deadline(self, ms: Optional[float] = None):
        """Attach an end-to-end deadline of ``ms`` milliseconds to every
        sketch op submitted inside the returned context on this thread
        (default: ``op_deadline_ms`` of the config).  Past the deadline
        ops are shed before dispatch with DeadlineExceededError instead of
        queueing; 0 (or a 0 default) pushes an explicit no-deadline frame
        that shadows any outer scope.

            with client.op_deadline(50):
                bf.add_all_async(keys).result()
        """
        if ms is None:
            ms = self.config.gpu_sketch.op_deadline_ms
        return overload.deadline_scope(ms / 1000.0 if ms else None)

    def prewarm_wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the bucket pre-warmer has driven every scheduled
        ladder (True on drained; trivially True when pre-warm is off).
        A warm launch that failed raises here."""
        return self._engine.prewarm_wait(timeout)

    def snapshot(self, directory: Optional[str] = None) -> None:
        """Snapshot the whole logical keyspace — sketch pools and the host
        grid — to ``directory`` (default: ``Config.snapshot_dir``)."""
        directory = directory or self.config.snapshot_dir
        if not directory:
            raise ValueError("no snapshot directory configured")
        os.makedirs(directory, exist_ok=True)
        self._engine.snapshot(directory)
        if self._engine.snapshot_extra is None:
            # No configured directory, so the engine has no hook: the
            # host keyspace goes beside the pools here.
            self._grid.snapshot_to(os.path.join(directory, "grid_store.bin"))

    def shutdown(self) -> None:
        """→ Redisson#shutdown (the engine's final snapshot, when
        ``Config.snapshot_dir`` is set, writes ``grid_store.bin`` too)."""
        self._engine.shutdown()
        self._grid.shutdown()
        self._topic_bus.shutdown()
