"""RedissonTorchClient — the entry-point facade of the port.

Parity with ``redisson_tpu/client.py`` for what this package carries:
the sketch objects (``get_bloom_filter``, ``get_hyper_log_log``,
``get_bit_set``, ``get_count_min_sketch``) on the engine, and the host
grid over one logical keyspace spanning both backends: buckets, counters
and RKeys; maps, multimaps, sets, lists and sorted sets; the queue
family; streams, geo and time series; topics on the client's delivery
bus (``get_topic``, ``get_pattern_topic``, ``get_sharded_topic``,
``get_reliable_topic``); the local cached map, JCache and the JSON
bucket; locks and synchronizers; the coordination services (executor,
remote, transaction, script, function, live objects, map-reduce); the
reactive facade; the admin surface (nodes and their failure monitor,
metrics, the Prometheus endpoint, the profiler); plus ``create_batch``,
``collect``, ``defer_fetch``, ``op_deadline``, ``prewarm_wait``,
``snapshot`` and ``shutdown``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import uuid
import warnings
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
    CacheManager,
    CountDownLatch,
    DelayedQueue,
    Deque,
    DoubleAdder,
    ExecutorService,
    FairLock,
    FencedLock,
    FunctionService,
    Geo,
    GridStore,
    IdGenerator,
    JCache,
    Keys,
    LexSortedSet,
    List_,
    ListMultimap,
    ListMultimapCache,
    LiveObjectService,
    LocalCachedMap,
    Lock,
    LongAdder,
    Map,
    MapCache,
    MapReduce,
    MultiLock,
    PatternTopic,
    PermitExpirableSemaphore,
    PriorityBlockingQueue,
    PriorityDeque,
    PriorityQueue,
    Queue,
    RateLimiter,
    ReadWriteLock,
    ReliableTopic,
    RemoteService,
    RingBuffer,
    ScoredSortedSet,
    ScriptService,
    Semaphore,
    Set_,
    SetCache,
    SetMultimap,
    SetMultimapCache,
    ShardedTopic,
    SortedSet,
    SpinLock,
    Stream,
    TimeSeries,
    Topic,
    TopicBus,
    Transaction,
    TransferQueue,
)
from redisson_tpu_torch.grid.buckets import JsonBucket
from redisson_tpu_torch.objects import BitSet, BloomFilter, CountMinSketch, HyperLogLog
from redisson_tpu_torch.objects.base import CamelCompatMixin
from redisson_tpu_torch.objects.engines import HostSketchEngine, TorchSketchEngine



def connect_cluster(seeds, **kwargs):
    """Connect a slot-aware routing client to a cluster: ``seeds`` is
    [(host, port), ...] of ANY subset of the nodes — the slot table
    bootstraps via ``CLUSTER SLOTS`` and refreshes itself on ``-MOVED``.
    Single commands route by their keys' CRC16 slot; ``execute_many``
    scatter/gathers a batch across nodes as pipelined per-node legs.

        cc = connect_cluster([("127.0.0.1", 7000)])
        cc.execute("SET", "{user:1}.name", "ada")
        replies = cc.execute_many([("GET", k) for k in keys])
    """
    from redisson_tpu_torch.cluster.client import ClusterClient

    return ClusterClient(seeds, **kwargs)


class RedissonTorchClient(CamelCompatMixin):
    def __init__(self, config: Config):
        gpu, host = config.gpu_sketch.enabled, config.host_sketch
        if gpu and host:
            raise ValueError(
                "use_gpu_sketch() and use_host_sketch() were both called: "
                "choose one sketch backend"
            )
        if not (gpu or host):
            raise ValueError(
                "choose a sketch backend: Config().use_gpu_sketch() (the "
                "card) or Config().use_host_sketch() (golden NumPy models "
                "on the host)"
            )
        self.config = config
        # Per-client identity for lock ownership (→ the reference's
        # connection-manager UUID in the UUID:threadId lock value); id()
        # of a collected client can be recycled, so it must not be used.
        self.id = uuid.uuid4().hex
        self._engine = TorchSketchEngine(config) if gpu else HostSketchEngine(config)
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
        # near-cache entries ("grid:"-prefixed tenants); the host engine
        # has no near cache.
        nc = getattr(self._engine, "nearcache", None)
        if nc is not None:
            self._grid.on_invalidate = lambda name: nc.drop_object("grid:" + name)
            self._grid.on_invalidate_all = nc.invalidate_all
        # Restore-on-create for the host keyspace too (the sketch side
        # restored inside the engine): one snapshot directory carries the
        # whole logical keyspace, the periodic snapshotter's included.
        if config.snapshot_dir:
            if host:
                warnings.warn(
                    "snapshot_dir is configured but the host sketch engine "
                    "has no snapshotter: only the grid keyspace persists "
                    "across restarts (sketch objects are lost, and "
                    "snapshot_interval_s is inactive); use use_gpu_sketch() "
                    "for full-keyspace persistence"
                )
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
            if gpu:
                # Through the engine's snapshotter (periodic and at
                # shutdown).  The host engine never snapshots, so
                # shutdown writes the grid itself.
                self._engine.snapshot_extra = lambda d: self._grid.snapshot_to(
                    os.path.join(d, "grid_store.bin")
                )
        # Grid keyspace journaling: grid mutations enter the engine's op
        # journal (the total order the replication stream ships) as
        # full-state records.  The host engine has no journal, so the
        # grid stays unjournaled there.
        eng = self._engine
        if gpu:
            self._grid.on_journal = eng._journal_rec
            self._grid.on_journal_ack = lambda seq: eng._ack(None, seq)
            self._grid.journal_live = lambda: eng.journal is not None
            # Records the engine-init replay deferred (the grid store did
            # not exist yet) apply now, AFTER the grid snapshot restore:
            # they are the post-cut tail, in seq order, and full-state
            # records make re-application safe.
            pending = getattr(eng, "_pending_grid_replay", None)
            if pending:
                for rec in pending:
                    self._grid.apply_journal_record(rec)
                eng._pending_grid_replay = []
        # Pub/sub delivery pool (the PublishSubscribeService analog):
        # topic listeners run here, the RTopic -> CMS ingest bridge too.
        self._topic_bus = TopicBus(n_threads=config.threads)
        # Name-shared services and the per-client admin singletons
        # (script/function services, failure monitor, metrics endpoint,
        # profiler) are created under this lock.
        self._services_lock = threading.Lock()
        self._executor_services: dict = {}
        self._remote_services: dict = {}
        self._script_service = None
        self._function_service = None
        self._failure_monitor = None
        self._metrics_http = None
        self._metrics_http_req = None
        self._profiler = None
        self._shutdown = False

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

    def get_local_cached_map(self, name: str, **options) -> LocalCachedMap:
        """→ RedissonClient#getLocalCachedMap (near cache + invalidation
        topic)."""
        return LocalCachedMap(name, self, **options)

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

    # -- caches, JSON, admin, reactive ----------------------------------------

    def get_jcache(self, name: str, **config) -> JCache:
        """→ org.redisson.jcache.JCache (JSR-107 facade)."""
        return JCache(name, self, **config)

    def get_cache_manager(self) -> CacheManager:
        return CacheManager(self)

    def get_json_bucket(self, name: str) -> JsonBucket:
        """→ RedissonClient#getJsonBucket."""
        return JsonBucket(name, self)

    def get_nodes_group(self):
        """→ RedissonClient#getNodesGroup: the engine's device as a node
        (ping / info)."""
        from redisson_tpu_torch.serve.nodes import NodesGroup

        return NodesGroup(self)

    def reactive(self):
        """→ RedissonClient's reactive facade: every object method returns
        an asyncio awaitable (see reactive.py)."""
        from redisson_tpu_torch.reactive import ReactiveClient

        return ReactiveClient(self)

    rx = reactive  # → RedissonRxClient spelling

    def get_failure_monitor(self, interval_s: float = 1.0):
        """The shared background monitor surfacing a dead device as typed
        events (the topology-monitor analog).  Not started automatically:
        call ``.start()``."""
        from redisson_tpu_torch.serve.nodes import FailureMonitor

        with self._services_lock:  # one shared monitor, race-free create
            if self._failure_monitor is None:
                self._failure_monitor = FailureMonitor(
                    self.get_nodes_group(), interval_s=interval_s
                )
            return self._failure_monitor

    # -- locks & synchronizers ---------------------------------------------

    def get_lock(self, name: str) -> Lock:
        return Lock(name, self)

    def get_fair_lock(self, name: str) -> FairLock:
        return FairLock(name, self)

    def get_spin_lock(self, name: str) -> SpinLock:
        return SpinLock(name, self)

    def get_fenced_lock(self, name: str) -> FencedLock:
        return FencedLock(name, self)

    def get_multi_lock(self, *locks) -> MultiLock:
        return MultiLock(*locks)

    get_red_lock = get_multi_lock  # → RedissonRedLock (deprecated alias)

    def get_read_write_lock(self, name: str) -> ReadWriteLock:
        return ReadWriteLock(name, self)

    def get_semaphore(self, name: str) -> Semaphore:
        return Semaphore(name, self)

    def get_permit_expirable_semaphore(self, name: str) -> PermitExpirableSemaphore:
        return PermitExpirableSemaphore(name, self)

    def get_count_down_latch(self, name: str) -> CountDownLatch:
        return CountDownLatch(name, self)

    def get_rate_limiter(self, name: str) -> RateLimiter:
        return RateLimiter(name, self)

    # -- services ----------------------------------------------------------

    def get_executor_service(self, name: str) -> ExecutorService:
        """→ RedissonClient#getExecutorService (``register_workers(n)`` is
        the RedissonNode analog).  Name-shared: every handle for ``name``
        is one service — workers registered through one handle run tasks
        submitted through any other."""
        with self._services_lock:
            svc = self._executor_services.get(name)
            if svc is None or svc.is_shutdown():
                svc = ExecutorService(name, self)
                self._executor_services[name] = svc
            return svc

    def get_remote_service(self, name: str = "remote") -> RemoteService:
        """→ RedissonClient#getRemoteService.  Name-shared like
        get_executor_service."""
        with self._services_lock:
            svc = self._remote_services.get(name)
            if svc is None:
                svc = RemoteService(name, self)
                self._remote_services[name] = svc
            return svc

    def create_transaction(self) -> Transaction:
        """→ RedissonClient#createTransaction (optimistic)."""
        return Transaction(self)

    def get_script(self) -> ScriptService:
        """→ RedissonClient#getScript: named atomic procedures (Python
        callables run under the grid lock).  One shared instance per
        client, so registrations survive re-getting the handle."""
        with self._services_lock:
            if self._script_service is None:
                self._script_service = ScriptService(self)
            return self._script_service

    def get_function(self) -> FunctionService:
        """→ RedissonClient#getFunction: libraries of named atomic
        procedures with FCALL/FCALL_RO semantics."""
        with self._services_lock:
            if self._function_service is None:
                self._function_service = FunctionService(self)
            return self._function_service

    def get_live_object_service(self) -> LiveObjectService:
        """→ RedissonClient#getLiveObjectService."""
        return LiveObjectService(self)

    def get_map_reduce(self, source_map, **options) -> MapReduce:
        """→ RMap#mapReduce entry point."""
        return MapReduce(self, source_map, **options)

    # -- metrics, scrape endpoint, profiler ----------------------------------

    def get_metrics(self) -> dict:
        """Coalescer/batch metrics snapshot: the flat keys of
        ``serve.metrics.Metrics`` (ops_total, p99_wait_ms, ...) plus the
        nested views:

        - ``ops``: per engine-op latency and throughput (p50/p99 from the
          lifecycle-span histograms);
        - ``commands``: per RESP command calls/usec (populated when a
          RespServer fronts this client);
        - ``tenants``: ops submitted per named sketch object;
        - ``phases``: per-op p50/p99 of the four launch phases;
        - ``slowlog_len``: current slow-op ring occupancy;
        - ``traces``: the bounded span ring grouped by trace id ({} while
          sampling is off).
        """
        m = getattr(self._engine, "metrics", None)  # none on the host engine
        out = {} if m is None else m.snapshot()
        obs = self.obs
        out["ops"] = obs.op_stats()
        out["commands"] = obs.command_stats()
        out["tenants"] = obs.tenant_stats()
        out["phases"] = obs.phase_stats()
        out["slowlog_len"] = len(obs.slowlog)
        out["traces"] = obs.trace.traces()
        return out

    def trace(self, name: str = "client"):
        """Direct-API trace minting: ``with client.trace("my-batch") as
        span:`` head-samples a root span and installs it as the thread's
        ambient context, so every engine submit inside links its
        coalescer launch (with the full phase breakdown) into the trace.
        Yields the span, or None when the dice missed or sampling is
        off."""
        return self.obs.trace.span_scope(name)

    def render_prometheus(self) -> str:
        """Full Prometheus text exposition: the aggregate metrics (typed
        counter/gauge) plus every labeled family in the obs registry."""
        m = getattr(self._engine, "metrics", None)  # none on the host engine
        head = "" if m is None else m.render_prometheus()
        return head + self.obs.registry.render_prometheus()

    def start_metrics_endpoint(self, host: str = "127.0.0.1", port: int = 0):
        """Start (or return the already-running) Prometheus scrape
        endpoint serving :meth:`render_prometheus` at ``/metrics``."""
        from redisson_tpu_torch.obs.promhttp import MetricsHTTPServer

        with self._services_lock:
            srv = self._metrics_http
            if srv is not None:
                # Never hand back a server bound elsewhere than asked: the
                # requested scrape target would not exist.  Compared with
                # both the resolved and the requested host, so repeating
                # an unresolved name ("localhost") is not a conflict.
                req_host, _ = self._metrics_http_req
                if port not in (0, srv.port) or host not in (
                    srv.host, req_host
                ):
                    raise RuntimeError(
                        "metrics endpoint already running on "
                        f"{srv.host}:{srv.port}; close it before "
                        f"rebinding to {host}:{port}"
                    )
                return srv
            srv = MetricsHTTPServer(
                self.render_prometheus, host=host, port=port
            )
            self._metrics_http = srv
            self._metrics_http_req = (host, port)
            return srv

    def change_topology(self, num_shards: int) -> bool:
        """Online reshard of the sketch engine: remap every device row onto
        a new shard count on the LIVE engine — no restart, no keyspace
        wipe, no lost write (SketchDurabilityMixin.change_topology)."""
        if not hasattr(self._engine, "change_topology"):
            raise RuntimeError("change_topology requires the card sketch engine")
        return self._engine.change_topology(num_shards)

    def get_profiler(self):
        """→ a ``torch.profiler`` trace of the engine's device (host and,
        on a card, CUDA activity).  One shared instance per client: start()
        on one handle and stop() on another must pair up."""
        from redisson_tpu_torch.serve.metrics import Profiler

        with self._services_lock:
            if self._profiler is None:
                ex = getattr(self._engine, "executor", None)
                # The host engine has no device: a trace of the host.
                self._profiler = Profiler(
                    "cpu" if ex is None else ex.device,
                    devices=None if ex is None else self._engine.mesh_devices(),
                )
            return self._profiler

    def get_sketch_names(self, kind=None) -> list:
        """Names of the live sketch objects, of one kind if given."""
        return self._engine.names(kind)

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
        collect = getattr(self._engine, "collect_results", None)
        if collect is not None:  # host-engine results are already home
            collect(futures)
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
        wait = getattr(self._engine, "prewarm_wait", None)
        return True if wait is None else wait(timeout)

    def snapshot(self, directory: Optional[str] = None) -> None:
        """Snapshot the whole logical keyspace — sketch pools and the host
        grid — to ``directory`` (default: ``Config.snapshot_dir``)."""
        directory = directory or self.config.snapshot_dir
        if not directory:
            raise ValueError("no snapshot directory configured")
        os.makedirs(directory, exist_ok=True)
        eng_snap = getattr(self._engine, "snapshot", None)  # none on the host engine
        if eng_snap is not None:
            eng_snap(directory)
        if getattr(self._engine, "snapshot_extra", None) is None:
            # No engine hook (no configured directory, or the host
            # engine): the host keyspace goes beside the pools here.
            self._grid.snapshot_to(os.path.join(directory, "grid_store.bin"))

    def shutdown(self) -> None:
        """→ Redisson#shutdown (the engine's final snapshot, when
        ``Config.snapshot_dir`` is set, writes ``grid_store.bin`` too)."""
        if self._failure_monitor is not None:
            self._failure_monitor.stop()
        if self._metrics_http is not None:
            self._metrics_http.close()
            self._metrics_http = None
        if self.config.snapshot_dir and getattr(
            self._engine, "snapshot_extra", None
        ) is None:
            # The host engine only: the card engine's own shutdown
            # snapshot writes the grid through snapshot_extra.
            try:  # best-effort persistence, like the engine's own
                self._grid.snapshot_to(
                    os.path.join(self.config.snapshot_dir, "grid_store.bin")
                )
            except Exception:  # persistence must not block shutdown
                logging.getLogger(__name__).exception(
                    "grid snapshot-on-shutdown failed"
                )
        self._engine.shutdown()
        self._grid.shutdown()
        self._topic_bus.shutdown()
        self._shutdown = True

    def is_shutdown(self) -> bool:
        return self._shutdown
