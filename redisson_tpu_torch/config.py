"""Config for the PyTorch/CUDA port — the ``use_tpu_sketch()`` switch of
``redisson_tpu/config.py`` becomes ``use_gpu_sketch()``, with the same
names and defaults for the knobs this package reads, plus ``device``.

``device`` defaults to ``"cuda"``; construction raises when no CUDA
device is present (nothing falls back to the CPU).  Tests pass
``device="cpu"``, which runs every kernel's plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional


class GpuSketchConfig:
    """Tunables for the GPU sketch backend."""

    def __init__(self):
        self.enabled = False
        self.device = "cuda"
        # Coalescer (CommandBatchService-role) knobs.
        self.coalesce = True  # cross-call op coalescing via a flush thread
        self.batch_window_us = 200  # flush deadline
        self.max_batch = 1 << 16  # flush size threshold
        self.min_bucket = 256  # smallest padded batch (floor 32: results travel bit-packed)
        self.max_inflight = 8  # dispatched-but-uncollected launches
        # A producer's submit() blocks once this many ops are queued ahead
        # of the flush thread.  0 -> 8 x max_batch.
        self.max_queued_ops = 0
        # Pop-time merge cap while launches retire slowly (the put-RT
        # EWMA past the coalescer's slow_launch_s): a backlog may merge
        # past max_batch up to this bound.  0 disables.
        self.max_batch_slow_phase = 0
        # AIMD in-flight window: shrink toward min_inflight while launches
        # retire slowly, grow back toward max_inflight when they are fast.
        self.adaptive_inflight = True
        self.min_inflight = 2
        # Adaptive flush window: batch_window_us is the BASE; an arrival-
        # rate + queue-pressure controller moves the live window inside
        # [min_window_us, max_window_us].  0 -> base/2 .. base*8.
        self.adaptive_window = True
        self.min_window_us = 0
        self.max_window_us = 0
        # Circuit breakers: this many consecutive failures of one op path
        # OPEN its circuit (the kind's objects fail over to host golden
        # mirrors); after breaker_open_ms a probe dispatch tests the
        # device and, on success, the mirrors reconcile back.
        self.breaker_failure_threshold = 5
        self.breaker_open_ms = 1000
        # Dispatch retry backoff: retry_interval_ms doubling per attempt,
        # capped here, scaled by a uniform +-retry_jitter factor.
        self.retry_max_backoff_ms = 2000
        self.retry_jitter = 0.2
        # Overload control plane.  op_deadline_ms: the default deadline
        # client.op_deadline() falls back to (0 = none); ops whose
        # deadline expires are shed strictly pre-dispatch.
        # fetch_timeout_ms bounds a no-deadline blocking .result(); a
        # fetch timeout records a breaker failure.
        self.op_deadline_ms = 0
        self.fetch_timeout_ms = 120_000
        # RESP ingress shedding: past this coalescer queue pressure
        # (0..1) the front door refuses engine-bound commands with -BUSY,
        # keeping the handshake/admin/introspection surface.  1.0
        # effectively disables it; must be > 0.
        self.admission_watermark = 0.9
        # Per-tenant fairness: token-bucket rate (ops/s, 0 = unlimited),
        # burst (0 -> 2x the rate), and a queued+in-flight op quota
        # (0 = unlimited); over-quota tenants are shed first.
        self.tenant_rate_limit = 0
        self.tenant_burst_ops = 0
        self.tenant_max_inflight = 0
        # The completer fetches several pending launches' results with one
        # device-side concatenation and one D2H.
        self.mailbox_collect = True
        # Exact intra-batch sequential semantics for bloom add.  False
        # selects the single-tenant bulk add whose newly-added flags are
        # taken against the state before the call (ops/fastpath.py).
        self.exact_add_semantics = True
        # Bucket pre-warming (executor/prewarm.py): a background thread
        # drives every (op, bucket) of the ladder up to max_batch on pool
        # attach, so no serving-path op pays a first launch.  Off by
        # default, as in the JAX package.  Pools whose state exceeds
        # prewarm_max_state_bytes are not warmed (a warm pass needs a
        # scratch state of the same shape on the card).
        self.prewarm = False
        self.prewarm_max_state_bytes = 1 << 28
        # Near cache (cache/nearcache.py): the epoch-guarded host read
        # tier — small reads (contains/GETBIT/PFCOUNT/CMS estimate and the
        # bitset and CMS scalars) answer from host memory while their
        # epoch tag holds.  On by default, as in the JAX package.
        # Batches larger than nearcache_max_batch bypass it; the tenant
        # quota 0 means max_bytes / 8.
        self.nearcache = True
        self.nearcache_max_bytes = 64 << 20
        self.nearcache_tenant_quota_bytes = 0
        self.nearcache_shards = 8
        self.nearcache_max_batch = 1024
        # Residency ladder (storage/residency.py): device rows are a cache
        # over host golden mirrors over disk blobs.  A budget of 0 device
        # rows keeps every tenant resident; past the budget, cold rows
        # demote to exact host mirrors and new tenants are born on the
        # host; mirrors spill to residency_dir once host bytes exceed
        # residency_max_host_bytes (0 = never spill);
        # residency_max_disk_bytes caps the blob tier (0 = unlimited);
        # objects whose decayed access heat (half-life
        # residency_heat_half_life_s) reaches residency_promote_heat
        # promote back.  The JAX package's names and defaults.
        self.residency_device_rows = 0
        self.residency_max_host_bytes = 0
        self.residency_max_disk_bytes = 0
        self.residency_promote_heat = 4.0
        self.residency_heat_half_life_s = 10.0
        self.residency_interval_ms = 200
        self.residency_dir: Optional[str] = None
        # Sharding: 1 -> the single-device executor; S > 1 -> the sharded
        # executor (executor/sharded_executor.py): tenant row r lives on
        # logical shard r % S of a ``[S, local_len]`` pool on ``device``.
        # Every shard shares the one device (parallel/mesh.py).
        self.num_shards = 1
        # Bitset rows at or above this many uint32 words split their words
        # into contiguous blocks, one per shard (m-sharding), instead of
        # living on one shard.  Only meaningful with num_shards > 1.
        self.mbit_threshold_words = 1 << 22

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    def update(self, d: dict) -> None:
        for k, v in d.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown gpuSketch config key: {k}")
            setattr(self, k, v)


class Config:
    """→ org/redisson/config/Config.java (the slice's part of it)."""

    def __init__(self):
        from redisson_tpu_torch.codecs import DEFAULT_CODEC

        self.codec = DEFAULT_CODEC
        self.threads = 4  # topic delivery pool (reference: `threads`)
        self.gpu_sketch = GpuSketchConfig()
        # Snapshots (the JAX package's names and defaults): with a
        # directory set, the engine restores from it on create and writes
        # a final snapshot on shutdown; an interval > 0 adds periodic ones.
        self.snapshot_dir: Optional[str] = None
        self.snapshot_interval_s: float = 0.0
        # → Config#retryAttempts / #retryInterval: a dispatch that fails
        # before writing pool state is re-dispatched up to retry_attempts
        # times in all, after a jittered exponential backoff.
        self.retry_attempts = 3
        self.retry_interval_ms = 1500
        # -- RESP front door (serve/), the JAX package's names and
        # defaults.  requirepass: every connection must AUTH (or HELLO
        # ... AUTH) first; None = open, the redis-server default.
        self.requirepass: Optional[str] = None
        # RESP script execution watchdog (the busy-reply-threshold
        # analog): a script running longer than this makes the server
        # answer other connections with BUSY (SCRIPT KILL remains
        # available) instead of silently queueing them behind the grid
        # lock.  0 disables the BUSY surface (scripts may block forever).
        self.script_timeout_ms = 5000
        # RESP scripting (EVAL/EVALSHA/SCRIPT/FUNCTION/FCALL): script
        # bodies are arbitrary PYTHON, i.e. remote code execution for
        # anyone who can reach the socket — OFF by default, and the
        # RespServer refuses to enable it unless requirepass is set or
        # the bind is loopback.  (The in-process Python ScriptService is
        # unaffected: in-process callers can run code anyway.)
        self.enable_python_scripts = False
        # Fuse runs of adjacent pipelined commands on one (object,
        # family) into single engine calls, demuxing per-command replies
        # in order (byte-identical to sequential execution).
        self.resp_vectorize = True
        # Response cache for repeated identical reads inside one pipeline
        # window: entry bound, 0 disables; any write retires it.
        self.resp_response_cache_size = 64
        # Reactor front door: a fixed pool of selector event loops that
        # drain every ready connection per tick into one merged
        # parse -> vectorize -> dispatch pass (ops of different
        # connections fuse).  False restores thread-per-connection.
        self.resp_reactor = True
        self.resp_reactor_threads = 1
        # Slow-client protection (client-output-buffer-limit): a reply
        # holding more than this many unsent bytes past its grace drops
        # the connection (0 = unlimited); a send making no progress for
        # soft_seconds is dropped (0 = the idle timeout).  Both
        # live-settable with CONFIG SET.
        self.client_output_buffer_limit = 0
        self.client_output_buffer_soft_seconds = 0.0
        # Telemetry plane, the JAX package's knobs and defaults.
        # ``trace_sample_rate``: head-based sampling probability of
        # distributed request traces (obs/trace.py), 0.0 = off (the
        # module guard makes the off path one attribute read per hook);
        # live via CONFIG SET trace-sample-rate / TRACE SAMPLE.
        # ``trace_max_spans``: the hard per-process span-ring bound.
        # ``latency_monitor_threshold_ms``: latency-monitor-threshold —
        # named latency events at or above it are sampled for LATENCY
        # LATEST|HISTORY|DOCTOR; 0 disables.
        # ``loadmap_key_sample_rate``: probability that a served command's
        # keys feed the hot-key sketches (obs/loadmap.py; the per-slot
        # vectors are always kept); live via CONFIG SET
        # loadmap-key-sample-rate.
        self.trace_sample_rate = 0.0
        self.trace_max_spans = 2048
        self.latency_monitor_threshold_ms = 0
        self.loadmap_key_sample_rate = 0.01
        # Crash-safe durability, the JAX package's knobs and defaults:
        # with a journal_dir set, every accepted sketch and grid mutation
        # appends a CRC32-framed record (durability/journal.py); recovery
        # = restore_snapshot + tail replay through the host golden
        # mirrors into device rows.  ``journal_fsync`` is appendfsync
        # always|everysec|no (live via CONFIG SET appendfsync): under
        # ``always`` an op's ack resolves only after its record is
        # fsynced.  Segments rotate at journal_max_segment_bytes; a
        # completed snapshot retires the covered ones (BGREWRITEAOF).
        # Off by default.
        self.journal_dir: Optional[str] = None
        self.journal_fsync: str = "everysec"
        self.journal_max_segment_bytes: int = 64 << 20
        # Replication: ``replica_of`` ("host:port") makes this node a
        # read replica (full resync from the primary's snapshot tar, then
        # its journal stream; -READONLY on writes).
        # ``repl_backlog_bytes`` bounds the primary's partial-resync
        # ring; ``repl_max_staleness_ops`` > 0 makes a replica that far
        # behind refuse keyed reads with -STALEREAD (0 = never refuse).
        self.replica_of: Optional[str] = None
        self.repl_backlog_bytes = 4 << 20
        self.repl_max_staleness_ops = 0
        # Per-core front door.  ``frontdoor_processes``: K server
        # processes share this node's listen port via SO_REUSEPORT, each
        # owning a contiguous 1/K of the slot range behind an in-node
        # slot->process map (serve/multicore.py).  1 (default) = the
        # single-process door; >1 on a platform without SO_REUSEPORT
        # degrades to 1 with an INFO log line, never a bind-time crash.
        # The ``frontdoor_workers`` / ``frontdoor_index`` /
        # ``frontdoor_dir`` triple is INTERNAL — the supervisor parent
        # stamps it into each worker child (--frontdoor-workers/
        # --frontdoor-index/--frontdoor-dir); setting it by hand makes one
        # bare worker of a K-party door.
        self.frontdoor_processes = 1
        self.frontdoor_workers = 1
        self.frontdoor_index: Optional[int] = None
        self.frontdoor_dir: Optional[str] = None
        # Cluster mode, the JAX package's knobs and defaults: the
        # 16384-slot CRC16 topology.  When enabled the RESP door routes
        # every keyed command by its keys' slot — wrong-slot keys get
        # -MOVED/-ASK redirects, hash tags {...} co-locate multi-key
        # ops, and live slot migration rides CLUSTER SETSLOT + MIGRATE.
        # ``cluster_topology`` is a dict (or a JSON file path) of
        # {"nodes": [{"id", "host", "port", "slots": [[a, b], ...]}]};
        # without one this node is a single-node cluster owning
        # ``cluster_slots`` (e.g. "0-16383", default all).
        # ``cluster_node_id`` names this node's topology entry;
        # ``cluster_announce`` ("host:port") is the address other nodes
        # and clients are redirected to (default: the bind address).
        # ``cluster_node_timeout_ms`` / ``cluster_ping_interval_ms``: the
        # failover agent's failure-detection clock — a peer silent for
        # node-timeout is marked failed, and a failed primary's replicas
        # run the epoch election.
        self.cluster_enabled = False
        self.cluster_node_id: Optional[str] = None
        self.cluster_topology = None
        self.cluster_slots: Optional[str] = None
        self.cluster_announce: Optional[str] = None
        self.cluster_node_timeout_ms = 1500
        self.cluster_ping_interval_ms = 300
        # Autonomous rebalancer.  ``rebalance_enabled`` arms the
        # per-node control loop (cluster/rebalancer.py): every armed
        # node scrapes the fleet's CLUSTER LOADMAPs into a smoothed
        # per-slot heat EWMA; the coordinator (lowest-id alive primary)
        # additionally executes migration waves.  The damping knobs —
        # all live-settable via CONFIG SET rebalance-* — implement the
        # Memcache-at-Facebook churn lesson: ``rebalance_threshold`` is
        # the imbalance ratio (max node load / mean) that triggers a
        # wave, ``rebalance_max_moves`` caps migrations per wave,
        # ``rebalance_pace_ms`` breathes between consecutive pumps (the
        # p99 bound during a wave), and ``rebalance_cooldown_ms`` keeps
        # a just-moved slot untouchable so the loop can never ping-pong
        # one slot between two nodes.
        self.rebalance_enabled = False
        self.rebalance_interval_ms = 1000
        self.rebalance_threshold = 1.3
        self.rebalance_max_moves = 8
        self.rebalance_pace_ms = 50
        self.rebalance_cooldown_ms = 15000
        # Fleet doctor.  ``doctor_enabled`` arms the continuous
        # invariant sweep (obs/doctor.py): every armed node probes the
        # fleet, the coordinator (lowest-id alive primary) audits — slot
        # ownership, offset/epoch monotonicity, replica lag, stuck
        # migrations — and runs the black-box WAIT-fenced canary.
        # ``doctor_stuck_slot_ms`` is how long a slot may sit
        # MIGRATING/IMPORTING before that reads as an abandoned
        # reshard; ``doctor_lag_bound_ops`` the replica-lag finding
        # threshold.
        self.doctor_enabled = False
        self.doctor_interval_ms = 1000
        self.doctor_stuck_slot_ms = 30000
        self.doctor_lag_bound_ops = 10000
        self.doctor_canary = True

    def set_codec(self, codec) -> "Config":
        self.codec = codec
        return self

    def set_threads(self, n: int) -> "Config":
        self.threads = n
        return self

    def set_requirepass(self, password: Optional[str]) -> "Config":
        """→ BaseConfig#setPassword: require AUTH on the RESP front
        door."""
        self.requirepass = password
        return self

    def set_enable_python_scripts(self, enabled: bool) -> "Config":
        """Allow RESP scripting (see the attribute): a server refuses it
        on a non-loopback bind without requirepass."""
        self.enable_python_scripts = enabled
        return self

    def use_gpu_sketch(self, **kwargs) -> "Config":
        """Run sketch objects on the torch backend; ``kwargs`` set
        ``GpuSketchConfig`` knobs (``device="cpu"`` for the CPU)."""
        self.gpu_sketch.enabled = True
        self.gpu_sketch.update(kwargs)
        return self

    # -- serialization (the JAX package's Config.to_dict/from_dict/
    # from_yaml/from_json/to_json for the keys this package reads) -----------

    _SIMPLE_KEYS = (
        "threads",
        "snapshot_dir",
        "snapshot_interval_s",
        "retry_attempts",
        "retry_interval_ms",
        "requirepass",
        "enable_python_scripts",
        "script_timeout_ms",
        "resp_vectorize",
        "resp_response_cache_size",
        "resp_reactor",
        "resp_reactor_threads",
        "client_output_buffer_limit",
        "client_output_buffer_soft_seconds",
        "trace_sample_rate",
        "trace_max_spans",
        "latency_monitor_threshold_ms",
        "loadmap_key_sample_rate",
        "journal_dir",
        "journal_fsync",
        "journal_max_segment_bytes",
        "replica_of",
        "repl_backlog_bytes",
        "repl_max_staleness_ops",
        "frontdoor_processes",
        "frontdoor_workers",
        "frontdoor_index",
        "frontdoor_dir",
        "cluster_enabled",
        "cluster_node_id",
        "cluster_topology",
        "cluster_slots",
        "cluster_announce",
        "cluster_node_timeout_ms",
        "cluster_ping_interval_ms",
        "rebalance_enabled",
        "rebalance_interval_ms",
        "rebalance_threshold",
        "rebalance_max_moves",
        "rebalance_pace_ms",
        "rebalance_cooldown_ms",
        "doctor_enabled",
        "doctor_interval_ms",
        "doctor_stuck_slot_ms",
        "doctor_lag_bound_ops",
        "doctor_canary",
    )

    def to_dict(self) -> dict:
        d = {k: getattr(self, k) for k in self._SIMPLE_KEYS}
        d["codec"] = type(self.codec).__name__
        d["gpu_sketch"] = self.gpu_sketch.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """A config from a mapping: top-level keys, ``codec`` by class
        name, and a ``gpu_sketch`` (or the JAX package's ``tpu_sketch``)
        mapping of backend knobs; the backend is enabled."""
        from redisson_tpu_torch import codecs

        cfg = cls()
        d = dict(d)
        codec_name = d.pop("codec", None)
        if codec_name:
            codec_cls = getattr(codecs, codec_name, None)
            if codec_cls is None:
                raise ValueError(f"unknown codec: {codec_name}")
            cfg.codec = codec_cls()
        backend = d.pop("gpu_sketch", None) or d.pop("tpu_sketch", None) or {}
        for k, v in d.items():
            if k not in cls._SIMPLE_KEYS:
                raise ValueError(f"unknown config key: {k}")
            setattr(cfg, k, v)
        backend = {k: v for k, v in backend.items() if k != "enabled"}
        return cfg.use_gpu_sketch(**backend)

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        """→ Config.fromYAML for a file: PyYAML when installed, else
        JSON (a YAML subset)."""
        import json

        with open(path) as f:
            text = f.read()
        try:
            import yaml  # type: ignore

            data = yaml.safe_load(text)
        except ImportError:
            data = json.loads(text)
        if not isinstance(data or {}, dict):
            raise ValueError("config must parse to a mapping")
        return cls.from_dict(data or {})

    @classmethod
    def from_json(cls, text: str) -> "Config":
        import json

        return cls.from_dict(json.loads(text))

    def to_json(self) -> str:
        import json

        return json.dumps(self.to_dict(), indent=2)
