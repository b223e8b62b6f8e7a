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
        # RESP scripting (Python bodies, the JAX package's switch): not
        # ported yet — EVAL answers as an unknown command — but a server
        # refuses it on a non-loopback bind without requirepass, as there.
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
        """The JAX package's scripting switch (see the attribute): a
        server refuses it on a non-loopback bind without requirepass."""
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
        "resp_vectorize",
        "resp_response_cache_size",
        "resp_reactor",
        "resp_reactor_threads",
        "client_output_buffer_limit",
        "client_output_buffer_soft_seconds",
        "journal_dir",
        "journal_fsync",
        "journal_max_segment_bytes",
        "replica_of",
        "repl_backlog_bytes",
        "repl_max_staleness_ops",
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
