"""Sketch engines — the backends behind the port's sketch objects
(BloomFilter, HyperLogLog, BitSet, CountMinSketch), one interface, two
implementations, as in ``redisson_tpu/objects/engines.py``:

- ``TorchSketchEngine`` (``Config.use_gpu_sketch()``), counterpart of
  ``TpuSketchEngine``: tenant registry + size-class pools +
  TorchCommandExecutor, with the BatchCoalescer in front when
  ``coalesce`` is on.
- ``HostSketchEngine`` (``Config.use_host_sketch()``): the golden NumPy
  models on the host, the JAX package's engine when ``use_tpu_sketch()``
  is not called, and the plain reference the card engine is measured
  against.

Both take identical host-side hash material, so their answers agree bit
for bit.  The rest of this docstring is the card engine's.  The routing and the ops each call becomes follow
the JAX engine, so both packages return the same answers and hold the
same pool bytes.  The object lifecycle (TTL, exists/delete/rename,
DUMP/RESTORE, snapshots) comes from ``objects/durability.py``.

Failure and overload handling, as in the JAX engine: per-op-path circuit
breakers (``health``) whose opening fails the kind's objects over to
host golden mirrors (``objects/degraded.py``) that serve reads and
writes until a probe succeeds and the mirrors reconcile back to the
device; every entry point that touches a row crosses
``_serve_degraded`` (or ``_host_row``) first.  ``_submit`` applies the
per-tenant governor and carries the ambient deadline
(``overload.deadline_scope``) into the coalescer.

The host tiers, as in the JAX engine: the near cache
(``cache/nearcache.py``) answers small reads while their epoch tag
holds — every mutating entry point crosses ``_nc_mutate``; the
residency ladder (``storage/residency.py``) makes device rows a cache
over host golden mirrors over disk blobs — a HOST entry serves from its
mirror through the same ``_serve_degraded`` boundary (without a breaker
or a degraded count), a DISK or born-cold entry loads first, and every
read that captured ``entry.row`` before that check resolves it through
``_tier_row``.  Every mutating entry point holds ``_journal_gate``
across its check-residency → submit window, so no transition interleaves
with a write.  The pre-warmer (``executor/prewarm.py``) takes first
launches off the serving path.

Durability, as in the JAX engine: with ``Config.journal_dir`` set, every
accepted mutation appends one record to the op journal
(``durability/journal.py``) inside the gate, in the order the gate
admits the ops, built from the host arrays the call already holds (raw
codec lanes for keyed Bloom adds, never a device tensor).  Under
``appendfsync always`` the returned result acks only once its record is
fsynced (``_DurableResult``; synchronous mutators wait in ``_ack``,
outside the gate).  Construction restores the snapshot, then replays the
journal tail through the golden mirrors into the device rows
(``durability/recovery.py``).
"""

from __future__ import annotations

import heapq
import io
import json
import logging
import struct
import threading
import time
import warnings
from typing import Optional

import numpy as np

from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch import chaos as _chaos, overload as _ovl
from redisson_tpu_torch.cache import ShardedLRUStore, SketchNearCache
from redisson_tpu_torch.executor import prewarm
from redisson_tpu_torch.executor.coalescer import (
    BatchCoalescer,
    HintedFuture,
    _op_label,
)
from redisson_tpu_torch.executor.failures import NonRetryableDispatchError
from redisson_tpu_torch.executor.health import DispatchHealth
from redisson_tpu_torch.executor.torch_executor import (
    LazyResult,
    TorchCommandExecutor,
    _trim_lanes,
    process_backend,
)
from redisson_tpu_torch.objects.base import MappedFuture
from redisson_tpu_torch.objects.degraded import (
    _bits_from_words,
    _words_from_bits,
    mirror_for_entry,
    model_from_row,
)
from redisson_tpu_torch.objects.durability import (
    _DUMP_MAGIC as DEVICE_DUMP_MAGIC,
    HOST_DUMP_MAGIC,
    SketchDurabilityMixin,
    check_dump_row,
    parse_device_dump,
    safe_load_npy,
)
from redisson_tpu_torch.obs import Observability, spans as _spans
from redisson_tpu_torch.ops import bitset as bitset_ops, golden
from redisson_tpu_torch.storage import ResidencyManager
from redisson_tpu_torch.tenancy import PoolKind, TenantGovernor, TenantRegistry
from redisson_tpu_torch.tenancy.registry import class_words_for_bits
from redisson_tpu_torch.utils import hashing

class _EpochGuard:
    """Entry+exit write-epoch bump around a mutating engine call (see
    cache/nearcache.py module doc: the entry bump retires stale serving
    the moment the write is in flight; the exit bump retires installs
    whose reads were captured inside the entry→submit window)."""

    __slots__ = ("_bump", "_name")

    def __init__(self, bump, name):
        self._bump = bump
        self._name = name

    def __enter__(self):
        self._bump(self._name)
        return self

    def __exit__(self, *exc):
        self._bump(self._name)
        return False


class ImmediateResult(LazyResult):
    """A result already materialized on the host."""

    def __init__(self, value):
        super().__init__(value)


class _DurableResult:
    """Ack gate for ``appendfsync=always``: the caller's ``.result()``
    returns only after the op's journal record is fsynced — group commit
    batches the fsyncs, so a burst of writers amortizes one disk barrier.
    Wraps any result-like (LazyResult, ImmediateResult, HintedFuture,
    MappedFuture).  The wait runs on the caller's thread."""

    __slots__ = ("_res", "_journal", "_seq")

    def __init__(self, res, journal, seq):
        self._res = res
        self._journal = journal
        self._seq = seq

    def result(self, timeout=None):
        v = self._res.result(timeout)
        if not self._journal.wait_durable(self._seq, timeout):
            # A timed-out durability wait must NOT ack: returning the
            # value here would report a write durable that a crash can
            # still lose.
            raise TimeoutError(
                f"journal record {self._seq} not fsynced within "
                f"{timeout}s (appendfsync=always durability fence)"
            )
        return v

    def get(self):
        return self.result()

    def done(self):
        inner = getattr(self._res, "done", None)
        return (
            (inner() if inner is not None else True)
            and self._journal.is_durable(self._seq)
        )

    def add_done_callback(self, fn):
        # Delegated un-gated: quota releases key off the DEVICE
        # resolution; the durability gate applies to the ack (result()).
        self._res.add_done_callback(fn)


class _ConcatLazy:
    """Result of a coalesced bitset launch that a size-class migration
    split into consecutive per-pool launches: the parts' results
    concatenated in op order."""

    def __init__(self, parts):
        self._parts = parts
        self._done = None

    def result(self, timeout=None):
        if self._done is None:
            self._done = np.concatenate([p.result() for p in self._parts])
            self._parts = None
        return self._done

    def get(self):
        return self.result()

    def done(self) -> bool:
        return self._done is not None


class TopKStore:
    """Engine-shared heavy-hitter candidate tables, name-addressed: every
    CountMinSketch handle for ``name`` sees ONE table of candidate keys
    with their last-seen estimates, max-merged and pruned; ``top_k()``
    re-estimates candidates on the device, so the table only needs to
    not LOSE heavy keys.  With an observability bundle (``obs``) it
    counts the keys offered (``rtpu_topk_offered_total``) and the prunes
    (``rtpu_topk_prunes_total``), and keeps the candidates held over
    every table in ``rtpu_topk_candidates``."""

    def __init__(self, obs=None):
        self._lock = _witness.named(threading.Lock(), "engine.topk")
        self._tables: dict[str, dict] = {}
        self._obs = obs
        self._held = 0  # candidates over every table

    def _recount(self) -> None:
        """Recount the candidates held (under the lock)."""
        self._held = sum(len(t["cands"]) for t in self._tables.values())
        if self._obs is not None:
            self._obs.topk_candidates.set((), self._held)

    def configure(self, name: str, k: int) -> None:
        with self._lock:
            t = self._tables.get(name)
            if t is None:
                self._tables[name] = {"k": int(k), "cands": {}}
            else:
                t["k"] = max(t["k"], int(k))

    def track(self, name: str) -> int:
        with self._lock:
            t = self._tables.get(name)
            return 0 if t is None else t["k"]

    def offer(self, name: str, keys, estimates) -> None:
        """Max-merge a batch's estimates (callers offer only the batch's
        heaviest 4k unique keys)."""
        with self._lock:
            t = self._tables.get(name)
            if t is None:
                return
            cands = t["cands"]
            before = len(cands)
            for key, est in zip(keys, estimates):
                e = int(est)
                if cands.get(key, 0) < e:
                    cands[key] = e
            cap = 4 * max(t["k"], 16)
            pruned = len(cands) > 2 * cap
            if pruned:
                keep = heapq.nlargest(cap, cands.items(), key=lambda kv: kv[1])
                t["cands"] = dict(keep)
            obs = self._obs
            if obs is not None:
                self._held += len(t["cands"]) - before
                obs.topk_candidates.set((), self._held)
                obs.topk_offered.inc((), len(keys))
                if pruned:
                    obs.topk_prunes.inc()

    def drop(self, name: str) -> None:
        with self._lock:
            if self._tables.pop(name, None) is not None:
                self._recount()

    def candidates(self, name: str) -> list:
        with self._lock:
            t = self._tables.get(name)
            return [] if t is None else list(t["cands"])

    def rename(self, old: str, new: str) -> None:
        with self._lock:
            self._tables.pop(new, None)
            t = self._tables.pop(old, None)
            if t is not None:
                self._tables[new] = t
            self._recount()

    # -- durability: snapshots and CMS dumps carry the candidate tables,
    # data-only (losing them would forget every heavy hitter while the
    # counters survive) --------------------------------------------------

    # Candidate keys round-trip with their ORIGINAL scalar type: codecs
    # encode np.uint64(5) and 5 to different bytes, so a type-collapsing
    # export would make a restored top_k() re-estimate the wrong cells.
    _KEY_TAGS = {
        int: ("i", int),
        np.uint64: ("u8", int),
        np.uint32: ("u4", int),
        np.int64: ("i8", int),
        np.int32: ("i4", int),
        str: ("s", str),
    }
    _TAG_DECODE = {
        "i": int,
        "u8": np.uint64,
        "u4": np.uint32,
        "i8": np.int64,
        "i4": np.int32,
        "s": str,
        "b": bytes.fromhex,
    }
    MAX_K = 1 << 20  # sanity bound on an imported table's k

    @classmethod
    def _encode_cands(cls, name: str, t: dict) -> dict:
        cands = []
        skipped = set()
        for key, est in t["cands"].items():
            enc = cls._KEY_TAGS.get(type(key))
            if enc is not None:
                cands.append([enc[0], enc[1](key), int(est)])
            elif isinstance(key, bytes):
                cands.append(["b", key.hex(), int(est)])
            else:
                skipped.add(type(key).__name__)
        if skipped:
            warnings.warn(
                f"top-K candidates of {name!r} with non-serializable key "
                f"types {sorted(skipped)} were not exported; they will "
                f"re-enter the table from future traffic"
            )
        return {"k": int(t["k"]), "cands": cands}

    @classmethod
    def _decode_cands(cls, d: dict) -> dict:
        """Strict decode of an UNTRUSTED table: unknown tags or malformed
        values raise ValueError, and so does a k past ``MAX_K``."""
        cands = {}
        for entry in d.get("cands", []):
            if not isinstance(entry, (list, tuple)) or len(entry) != 3:
                raise ValueError(f"bad topk entry: {entry!r}")
            tag, val, est = entry
            dec = cls._TAG_DECODE.get(tag)
            if dec is None:
                raise ValueError(f"bad topk key tag: {tag!r}")
            cands[dec(val)] = int(est)
        k = int(d.get("k", 0))
        if not 0 <= k <= cls.MAX_K:
            raise ValueError(f"topk k={k} out of range")
        return {"k": k, "cands": cands}

    def export_state(self, name: Optional[str] = None):
        """JSON-safe copy of one table (None if absent) or of all."""
        with self._lock:
            if name is not None:
                t = self._tables.get(name)
                return None if t is None else self._encode_cands(name, t)
            return {n: self._encode_cands(n, t) for n, t in self._tables.items()}

    @classmethod
    def decode_state(cls, state, name: Optional[str] = None):
        """Validate and decode an untrusted export WITHOUT touching the
        store: restore paths call this before any mutation, then install
        the value with ``import_decoded``."""
        if name is not None:
            return cls._decode_cands(state) if state else None
        return {n: cls._decode_cands(d) for n, d in (state or {}).items()}

    def import_decoded(self, decoded, name: Optional[str] = None) -> None:
        with self._lock:
            if name is not None:
                self._tables.pop(name, None)  # never keep a ghost table
                if decoded:
                    self._tables[name] = decoded
            else:
                self._tables.update(decoded or {})
            self._recount()

    def import_state(self, state, name: Optional[str] = None) -> None:
        self.import_decoded(self.decode_state(state, name), name)


_log = logging.getLogger(__name__)


def _join_processes(cfg) -> bool:
    """Join the torch.distributed group ``cfg`` (a GpuSketchConfig) names,
    before any device is looked at: ``tcp://<coordinator_address>``,
    ``num_processes`` ranks, this one ``process_id``, on the backend the
    topology picks (``process_backend``).  A group already initialized
    in this process (a second engine) stands and must match; returns
    True only when this call created the group, so ``shutdown`` destroys
    only its own.  A failed init raises."""
    import torch.distributed as dist

    P, rank = int(cfg.num_processes), int(cfg.process_id)
    if cfg.coalesce:
        raise ValueError(
            "several processes run in lockstep: every process must issue the "
            "same dispatches in the same order, which the timing-driven "
            "coalescer cannot promise; use use_gpu_sketch(coalesce=False)"
        )
    if not 0 <= rank < P:
        raise ValueError(f"process_id {rank} out of range for {P} processes")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (P, rank):
            raise RuntimeError(
                f"a torch.distributed group (rank {dist.get_rank()} of "
                f"{dist.get_world_size()}) already stands in this process; "
                f"the config asks for process {rank} of {P}"
            )
        return False
    backend = process_backend(cfg.device, P)
    dist.init_process_group(backend, init_method=f"tcp://{cfg.coordinator_address}",
                            world_size=P, rank=rank)
    _log.info("joined %d processes as rank %d over %s", P, rank, backend)
    return True


class TorchSketchEngine(SketchDurabilityMixin):
    # Per-launch op cap of the sequential CMS path: the JAX engine chunks
    # at this size and carries state across chunks, so sequential
    # semantics are exact either way; the same chunks keep the per-op
    # results and the launch count of both packages aligned.
    _SEQ_CHUNK = 1 << 15

    def __init__(self, config):
        self.config = config
        cfg = config.gpu_sketch
        # Several processes: join their group before any device is looked
        # at; num_shards then counts global shards.  Lockstep needs
        # coalesce=False (so no coalescer and no grouped collect), the
        # near cache off and no snapshot timer.
        self._owns_process_group = False
        if cfg.coordinator_address:
            self._owns_process_group = _join_processes(cfg)
        self.n_processes = int(cfg.num_processes) if cfg.coordinator_address else 1
        if cfg.num_shards > 1:
            from redisson_tpu_torch.executor.sharded_executor import (
                ShardedTorchCommandExecutor,
            )

            self.executor = ShardedTorchCommandExecutor(config)
        else:
            self.executor = TorchCommandExecutor(config)
        self.registry = TenantRegistry(
            self.executor,
            initial_capacity=cfg.initial_tenants_per_class,
            dispatch_lock=self.executor._dispatch_lock,
        )
        self.obs = Observability(
            trace_sample_rate=config.trace_sample_rate,
            trace_max_spans=config.trace_max_spans,
            latency_threshold_ms=config.latency_monitor_threshold_ms,
        )
        self.executor.obs = self.obs
        # Ops/batches and wait/flush reservoirs behind client.get_metrics:
        # the coalescer records each launch it retires; with no coalescer
        # in front, the executor's dispatch wrapper records instead (both
        # would double-count).
        from redisson_tpu_torch.serve.metrics import Metrics

        self.metrics = Metrics()
        # Near cache: the epoch-guarded host read tier.  Built even when
        # disabled, so its epoch bookkeeping is coherent whenever it is
        # switched on.
        self.nearcache = SketchNearCache(
            ShardedLRUStore(
                max_bytes=cfg.nearcache_max_bytes,
                nshards=cfg.nearcache_shards,
                tenant_quota_bytes=cfg.nearcache_tenant_quota_bytes,
                on_evict=lambda tenant, nbytes: self.obs.nearcache_evictions.inc(),
            ),
            obs=self.obs,
            enabled=cfg.nearcache and self.n_processes == 1,
            max_batch=cfg.nearcache_max_batch,
        )
        if self.n_processes > 1:
            # Lockstep: a hit skips a dispatch another process makes, so
            # the cache stays off, live re-enables included.
            self.nearcache.locked_off = True
        # Per-(shard, opcode) circuit breakers: when one opens, the
        # kind's objects fail over to host golden mirrors and reconcile
        # back when it closes.
        self.health = DispatchHealth(
            failure_threshold=cfg.breaker_failure_threshold,
            open_s=cfg.breaker_open_ms / 1000.0,
        )
        self.health.reconcile_cb = self._reconcile_kind
        self.health.obs = self.obs  # breaker events and LATENCY samples
        # Per-tenant fair load shedding at the submit boundary; built even
        # with both limits 0 (inactive) so set_limits works live.
        self.governor = TenantGovernor(
            rate_limit=cfg.tenant_rate_limit,
            burst=cfg.tenant_burst_ops,
            max_inflight=cfg.tenant_max_inflight,
            obs=self.obs,
        )
        self._mirrors: dict = {}  # name -> degraded-mode mirror
        self._mirror_lock = _witness.named(threading.RLock(), "engine.mirror")
        # Bumped (under the lock) whenever reconcile writes mirrors back:
        # a seed row read before the bump may predate the write-back and
        # is discarded (see _degraded).
        self._mirror_epoch = 0
        self.reconcile_seconds: dict = {}  # kind -> last write-back, s
        # Injected faults count in this engine's registry; the closure is
        # kept so shutdown unhooks exactly it.
        self._chaos_observer = (
            lambda point, kind: self.obs.faults_injected.inc((point, kind))
        )
        _chaos.set_observer(self._chaos_observer)
        self.topk = TopKStore(self.obs)
        # Wired by the client to the grid store's lock-free ``probe`` —
        # one logical keyspace across both backends (WRONGTYPE on
        # cross-backend reuse).
        self.foreign_exists = None
        # Companion-state snapshot hook (the client wires the grid
        # keyspace's grid_store.bin here).
        self.snapshot_extra = None
        self.coalescer = None
        if cfg.coalesce:
            self.coalescer = BatchCoalescer(
                batch_window_us=cfg.batch_window_us,
                max_batch=cfg.max_batch,
                metrics=self.metrics,
                max_inflight=cfg.max_inflight,
                retry_attempts=config.retry_attempts,
                retry_interval_s=config.retry_interval_ms / 1000.0,
                max_queued_ops=cfg.max_queued_ops,
                adaptive_inflight=cfg.adaptive_inflight,
                min_inflight=cfg.min_inflight,
                adaptive_window=cfg.adaptive_window,
                min_window_us=cfg.min_window_us,
                max_window_us=cfg.max_window_us,
                group_collect=(
                    self.executor.collect_group if cfg.mailbox_collect else None
                ),
                obs=self.obs,
                retry_max_backoff_s=cfg.retry_max_backoff_ms / 1000.0,
                retry_jitter=cfg.retry_jitter,
                health=self.health,
                max_batch_slow_phase=cfg.max_batch_slow_phase,
                fetch_timeout_s=cfg.fetch_timeout_ms / 1000.0,
            )
        else:
            self.executor.metrics = self.metrics
        # Bucket pre-warming: a background thread drives the (op, bucket)
        # ladder on pool attach, so serving ops never pay a first launch.
        self.prewarmer = None
        self._prewarm_seen: set = set()
        if cfg.prewarm:
            self.prewarmer = prewarm.BucketPrewarmer(
                self.executor,
                max_batch=cfg.max_batch,
                max_state_bytes=cfg.prewarm_max_state_bytes,
                obs=self.obs,
            )
        # The residency ladder: built BEFORE the restore below so a
        # snapshot can reinstate HOST/DISK tenants; the alloc gate and the
        # background thread arm AFTER it.
        self.residency = ResidencyManager(self, cfg, obs=self.obs)
        # The commit gate: every mutating entry point holds it across its
        # check-residency → journal-append → submit window, and every tier
        # transition and snapshot capture holds it, so no write is in
        # flight between "the op decided device" and "the row moved", and
        # a record can never land before a snapshot's cut while its
        # device effect lands after the capture (truncated from the
        # journal AND missing from the snapshot).  A plain RLock: strictly
        # the outermost lock of every path that takes it.
        self._journal_gate = threading.RLock()
        self.journal = None
        self._journal_replaying = False
        self._restored_journal_seq = 0
        self.recovery_stats = None  # set by durability.recovery.replay_journal
        self._register_health_gauges()
        self._sweeper = None
        self._snapshotter = None
        # One snapshot at a time: the periodic snapshotter, explicit calls
        # and shutdown write the same tmp files.  Strictly outermost.
        self._snapshot_lock = threading.Lock()
        # Checkpoint/resume: restore from the configured directory, then
        # arm the ladder, then periodic snapshots (never while the restore
        # runs).
        # Then the journal tail replays on top of the snapshot (never
        # while the snapshotter runs: it arms last).
        try:
            if config.snapshot_dir:
                self.restore_snapshot(config.snapshot_dir)
            if config.journal_dir:
                self._journal_attach(config.journal_dir, recover=True)
        except Exception:
            self._stop_health()
            self._stop_prewarmer()
            self._stop_coalescer()
            raise
        # Creates past the device budget now birth HOST-resident, and the
        # maintenance thread starts once a budget is armed.
        self.registry.alloc_gate = self.residency.device_full
        if cfg.residency_device_rows > 0 or cfg.residency_max_host_bytes > 0:
            self.residency.start()
        if config.snapshot_dir and config.snapshot_interval_s > 0:
            if self.n_processes > 1:
                # A timer fires at its own moment in each process, and a
                # snapshot gathers shards by collectives: lockstep breaks.
                warnings.warn(
                    "periodic snapshots are disabled with several processes: "
                    "call snapshot() explicitly at the same point in every process"
                )
            else:
                self._start_snapshotter(config.snapshot_dir, config.snapshot_interval_s)

    def _register_health_gauges(self) -> None:
        """Render-time gauges: breaker state, objects serving degraded,
        and the coalescer's queue, windows and admission estimate."""
        reg = self.obs.registry
        c = self.coalescer
        if c is not None:
            for name, help_, fn in (
                ("rtpu_coalescer_queued_ops", "ops queued ahead of the flush thread",
                 lambda: c._queued_ops),
                ("rtpu_inflight_launches", "dispatched-but-uncollected launches",
                 lambda: c._uncollected),
                ("rtpu_inflight_limit", "adaptive (AIMD) in-flight launch window",
                 lambda: c._inflight_limit),
                ("rtpu_completion_backlog", "launches awaiting the completer thread",
                 lambda: c._completions.qsize()),
                ("rtpu_flush_window_us", "live adaptive flush window",
                 lambda: c.window_s * 1e6),
                ("rtpu_flush_merge_cap", "live pop-time merge cap", c.merge_cap),
                ("rtpu_admission_est_wait_us",
                 "last admission-control queue-wait estimate",
                 lambda: c.last_est_wait_s * 1e6),
            ):
                reg.gauge_callback(name, help_, fn)
        reg.gauge_callback(
            "rtpu_breaker_state",
            "circuit state by shard/op (0 closed, 1 open, 2 half-open)",
            self.health.board.state_codes,
            labelnames=("shard", "op"),
        )
        if self.prewarmer is not None:
            reg.gauge_callback(
                "rtpu_prewarm_pending",
                "pre-warm tasks queued or running",
                self.prewarmer.pending,
            )
        reg.gauge_callback(
            "rtpu_degraded_objects",
            "sketches currently serving from the host golden mirror "
            "because a breaker is open (demoted sketches are not "
            "degraded and count in rtpu_residency_host_bytes instead)",
            lambda: max(0, len(self._mirrors) - self.residency.host_objects()),
        )
        for name, help_, fn in (
            ("rtpu_residency_device_rows",
             "device rows in use across all sketch pools (the residency "
             "ladder's fast tier; compare residency_device_rows budget)",
             self.residency.device_rows_used),
            ("rtpu_residency_host_bytes",
             "bytes of sketch state held in HOST-resident mirrors",
             self.residency.host_bytes),
            ("rtpu_residency_disk_bytes",
             "bytes of sketch state spilled to disk blobs",
             self.residency.disk_bytes),
            ("rtpu_nearcache_bytes", "host bytes held by the near cache",
             self.nearcache.store.bytes),
            ("rtpu_nearcache_entries", "entries held by the near cache",
             self.nearcache.store.entries),
        ):
            reg.gauge_callback(name, help_, fn)
        # Journal lag and segment count: 0 while journaling is off, so a
        # live CONFIG SET appendonly yes is visible without re-wiring.
        reg.gauge_callback(
            "rtpu_journal_lag_ops",
            "journal records appended but not yet fsynced",
            lambda: 0 if self.journal is None else self.journal.lag_ops(),
        )
        reg.gauge_callback(
            "rtpu_journal_segments",
            "live journal segment files",
            lambda: 0 if self.journal is None else self.journal.stats()["segments"],
        )
        # Tenant and pool occupancy, and the card's memory: scrape-time
        # views (a short-TTL memo halves the registry lock hold when one
        # scrape reads both registry gauges).
        stats_memo = {"t": -1.0, "v": None}

        def _stats():
            now = time.monotonic()
            if stats_memo["v"] is None or now - stats_memo["t"] > 0.2:
                stats_memo["v"] = self.registry.stats()
                stats_memo["t"] = now
            return stats_memo["v"]

        def _tenant_counts():
            return {(k,): v for k, v in _stats()["tenants_by_kind"].items()}

        def _pool_rows():
            out = {}
            for key, st in _stats()["pools"].items():
                cls = "x".join(str(x) for x in key[1:]) or "-"
                out[(key[0], cls, "used")] = st["used_rows"]
                out[(key[0], cls, "capacity")] = st["capacity"]
            return out

        def _devmem():
            from redisson_tpu_torch.serve.metrics import Profiler

            out = {}
            mem = Profiler(self.executor.device,
                           devices=self.mesh_devices()).device_memory()
            for dev, stats in mem.items():
                for stat, v in (stats or {}).items():
                    if v is not None:
                        out[(dev, stat)] = v
            return out

        reg.gauge_callback(
            "rtpu_tenants", "registered sketch tenants by kind",
            _tenant_counts, labelnames=("kind",),
        )
        reg.gauge_callback(
            "rtpu_pool_rows", "size-class pool rows by kind/class/state",
            _pool_rows, labelnames=("kind", "class", "state"),
        )
        reg.gauge_callback(
            "rtpu_device_memory_bytes", "per-device memory stats",
            _devmem, labelnames=("device", "stat"),
        )

    def mesh_shards(self) -> list:
        """(global shard, device) of every shard this process holds, in
        shard order; shard 0 on its device for the single-device
        executor."""
        ctx = getattr(self.executor, "ctx", None)
        return ctx.local_shards() if ctx is not None else [(0, self.executor.device)]

    def mesh_devices(self) -> list:
        """The device of every shard this process holds, in shard order:
        each shard's placement's device (shards of one placement repeat
        it; one entry on the single-device executor)."""
        return [d for _, d in self.mesh_shards()]

    def _stop_health(self) -> None:
        _chaos.unset_observer(self._chaos_observer)
        self.health.shutdown()

    def shutdown(self) -> None:
        """Unhook the chaos observer and stop the health monitor and the
        residency thread, stop the snapshotter and the sweeper, write the
        final snapshot (best effort, logged on failure), close the journal
        (drain + final fsync, so a clean shutdown replays nothing), then
        stop the pre-warmer and the coalescer."""
        self._stop_health()
        self.residency.shutdown()
        self._stop_snapshotter()
        self._stop_sweeper()
        if self.config.snapshot_dir:
            try:
                self.snapshot(self.config.snapshot_dir)
            except Exception:
                _log.exception("snapshot on shutdown to %s failed", self.config.snapshot_dir)
        j, self.journal = self.journal, None
        if j is not None:
            if self.coalescer is not None:
                self.coalescer.journal_lag_s = None
            j.close()
        self._stop_prewarmer()
        self._stop_coalescer()
        if self._owns_process_group:
            import torch.distributed as dist

            dist.destroy_process_group()
            self._owns_process_group = False

    def _stop_prewarmer(self) -> None:
        if self.prewarmer is not None:
            self.prewarmer.shutdown()

    def _stop_coalescer(self) -> None:
        if self.coalescer is not None:
            self.coalescer.shutdown()

    def _drain(self) -> None:
        """Direct state reads must observe all queued coalesced ops."""
        if self.coalescer is not None:
            self.coalescer.drain()

    def _nc_mutate(self, name: str, structural: bool = False):
        """Near-cache write discipline for a mutating op on ``name``:
        bump the write epoch at entry AND exit (structural ops bump the
        structural epoch too — they retire monotone positives).  Every
        path that can change the object's readable state crosses this
        (or drop_object/invalidate_all) — mirror-served writes included,
        which it gets for free by wrapping the ENGINE entry points those
        paths all flow through."""
        nc = self.nearcache
        return _EpochGuard(nc.note_structural if structural else nc.note_write, name)

    def prewarm_wait(self, timeout=None) -> bool:
        """Block until the bucket pre-warmer has driven every scheduled
        ladder (True on drained; trivially True when pre-warm is off).
        A warm launch that failed raises here."""
        if self.prewarmer is None:
            return True
        return self.prewarmer.wait_idle(timeout)

    def _prewarm_keyed(self, pool, k: int, L: int, blocks, lengths) -> None:
        """Register the device-hash warm ladders for an observed codec
        signature (lane count L, trim depth Lt and the const-length flag
        are parts of the launch shapes only real key bytes reveal).
        Called once per coarse (pool, k, L) signature — the caller's
        seen-set gate keeps the scans below off the per-submit path."""
        Lt = _trim_lanes(blocks)[0].shape[1]
        const = lengths.ndim == 0 or bool(np.all(lengths == lengths[0]))
        if self.executor.supports_runs_metadata:
            self.prewarmer.register(
                pool, ("bloom_mixkr", k, L, Lt, const),
                prewarm.warm_bloom_mixed_keys_runs(k, L, Lt, const),
            )
        self.prewarmer.register(
            pool, ("bloom_mixk", k, L, Lt),
            prewarm.warm_bloom_mixed_keys(k, L, Lt),
        )

    def _submit(self, key, dispatch, arrays, nops, pool_key=None, meta=None,
                tenant=None):
        """Queue ops on the coalescer.  The tenant governor sheds an
        over-quota tenant here, before its ops cost anyone queue wait;
        the ambient deadline rides into the coalescer (admission control
        and queue shedding) and bounds the returned future's wait."""
        deadline = _ovl.current_deadline()
        gov = self.governor
        governed = tenant is not None and gov.active
        if governed:
            gov.admit(tenant, nops)  # raises TenantThrottledError
        try:
            fut = self.coalescer.submit(
                key, dispatch, arrays, nops, pool_key=pool_key, meta=meta,
                tenant=tenant, deadline=deadline,
            )
        except BaseException:
            if governed:
                gov.release(tenant, nops)
            raise
        if governed and gov.max_inflight > 0:
            fut.add_done_callback(lambda _f: gov.release(tenant, nops))
        return HintedFuture(fut, self.coalescer, deadline=deadline,
                            op=_op_label(key), nops=nops)

    # -- crash-safe durability: the op journal ------------------------------

    def _journal_attach(self, jdir: str, recover: bool, fresh: bool = False) -> None:
        """Open (and optionally recover) the op journal.  ``recover``
        replays the post-snapshot tail through the golden mirrors into
        device rows (durability/recovery.py); ``fresh`` wipes existing
        segments first (the live-enable path: pre-enable state is covered
        by the coordinating snapshot, and stale segments of an earlier
        lineage must not replay on the next boot)."""
        from redisson_tpu_torch.durability import OpJournal, replay_journal

        cfg = self.config
        j = OpJournal(
            jdir, fsync_policy=cfg.journal_fsync,
            max_segment_bytes=cfg.journal_max_segment_bytes,
            obs=self.obs, fresh=fresh,
        )
        if recover:
            try:
                n = replay_journal(self, j, self._restored_journal_seq)
            except BaseException:
                j.close()
                raise
            if n:
                self.obs.journal_replayed.inc((), n)
        self.journal = j
        if self.coalescer is not None:
            self.coalescer.journal_lag_s = j.lag_s

    def journal_set_enabled(self, enabled: bool) -> None:
        """Live ``CONFIG SET appendonly yes|no``.  Enabling starts a FRESH
        journal lineage and, when a snapshot dir is configured, takes a
        coordinating snapshot so recovery = snapshot + tail; disabling
        closes the journal after a final drain + fsync."""
        if enabled:
            jdir = self.config.journal_dir
            if not jdir:
                raise ValueError(
                    "journal_dir is not configured (set Config.journal_dir "
                    "before enabling appendonly)"
                )
            with self._journal_gate:
                # Re-checked inside the gate: two racing enables must not
                # both attach (the loser's wipe would orphan the winner's
                # live segments).
                if self.journal is not None:
                    return
                self._journal_attach(jdir, recover=False, fresh=True)
            if self.config.snapshot_dir:
                self.snapshot(self.config.snapshot_dir)
        else:
            with self._journal_gate:
                j, self.journal = self.journal, None
                if self.coalescer is not None:
                    self.coalescer.journal_lag_s = None
            if j is not None:
                j.close()

    def journal_set_policy(self, policy: str) -> None:
        """Live ``CONFIG SET appendfsync always|everysec|no``."""
        from redisson_tpu_torch.durability import FSYNC_POLICIES

        if policy not in FSYNC_POLICIES:
            raise ValueError(f"journal_fsync must be one of {FSYNC_POLICIES}, got {policy!r}")
        self.config.journal_fsync = policy
        j = self.journal
        if j is not None:
            j.set_policy(policy)

    def journal_fence(self, timeout=None) -> bool:
        """The WAIT fence: force an fsync covering every record appended
        so far and block until it lands (True; False on timeout).
        Trivially True with journaling off."""
        j = self.journal
        if j is None:
            return True
        return j.wait_durable(timeout=timeout)

    def _journal_rec(self, op: str, name: str, **fields) -> Optional[int]:
        """Append one ACCEPTED-mutation record; its seq, or None when
        journaling is off or this is replay (a recovery never journals
        its own replay)."""
        j = self.journal
        if j is None or self._journal_replaying:
            return None
        rec = {"op": op, "name": name}
        rec.update(fields)
        return j.append(rec)

    def _durable(self, res, seq: Optional[int]):
        """Gate a result-like's ack on its record's fsync under
        ``appendfsync=always`` (the other policies' durability window is
        the fsync cadence, not the ack)."""
        j = self.journal
        if seq is None or j is None or j.policy != "always":
            return res
        return _DurableResult(res, j, seq)

    def _ack(self, value, seq: Optional[int]):
        """Durability fence for synchronously returning mutations
        (delete/rename/expire/merge/...): under ``always`` the method
        returns only once its record is fsynced.  Called OUTSIDE the
        gate: waiting under it would serialize every writer behind one
        barrier (group commit amortizes because waiters overlap)."""
        j = self.journal
        if seq is not None and j is not None and j.policy == "always":
            if not j.wait_durable(seq):
                raise TimeoutError(f"journal record {seq} not fsynced")
        return value

    def _commit(self, res, op: str, name: str, **fields):
        """Journal an accepted mutation and gate its ack: the one-call
        form for result-returning engine methods."""
        return self._durable(res, self._journal_rec(op, name, **fields))

    # -- graceful degradation: host golden-mirror failover -----------------

    def _degraded(self, entry) -> bool:
        """True when ``entry`` must serve from its host mirror: a breaker
        has failed its kind over, or it is not DEVICE-resident.  The
        healthy fast path is an attribute read, a dict probe and a branch
        — no lock.

        Residency ladder: the same boundary serves DEMOTED sketches — a
        HOST-resident entry's mirror answers here (no breaker, no
        degraded flag), a DISK-resident or born-cold entry loads its
        mirror first.  The membership probe is lock-free (GIL-atomic): a
        stale True is re-checked by _mirror_call under the lock, and a
        promote racing a stale False repoints entry.row to a fully
        written device row BEFORE dropping the mirror.

        Seeding a missing mirror runs OUTSIDE the mirror lock (its drain
        and row read can take seconds, and every degraded op of every
        kind serializes on that lock).  The install re-checks under the
        lock: a racing seeder's mirror wins, a reconcile that cleared the
        kind mid-seed routes back to the device, and a reconcile that
        WROTE mirrors back mid-seed (epoch bump) discards the possibly
        stale row and retries."""
        if entry.row < 0 and entry.name not in self._mirrors:
            self._ensure_resident(entry)
        if entry.name in self._mirrors:
            return True
        if not self.health.any_degraded:
            return False
        for _ in range(4):
            with self._mirror_lock:
                if entry.name in self._mirrors:
                    return True
                if not self.health.degraded_kind(entry.kind):
                    return False
                epoch = self._mirror_epoch
            row = self._seed_row(entry)
            with self._mirror_lock:
                if entry.name in self._mirrors:
                    return True
                if not self.health.degraded_kind(entry.kind):
                    return False
                if self._mirror_epoch != epoch:
                    continue  # reconciled mid-seed: the row may be stale
                if row is None:
                    return False
                self._install_mirror(entry, row)
                return True
        return False  # flapping hard: let the device surface the failure

    def _ensure_resident(self, entry) -> None:
        """Row-less entry (DISK-resident, or born cold past the device
        budget): install its HOST mirror — from the CRC-checked blob, or
        from zeros for a never-touched tenant.  A corrupt or missing blob
        raises (the op fails typed; serving garbage state is the one
        thing a tier must never do)."""
        self.residency.load(entry.name)

    def _tier_row(self, entry, row0: int) -> int:
        """Resolve the device row for a READ dispatch that captured
        ``row0`` BEFORE its residency check and then got no mirror
        result.  Readers do not hold the gate, so a transition can
        interleave with their check→dispatch window:

        - a PROMOTE racing the check leaves row0 at -1 while entry.row is
          already live (promote repoints the row before dropping the
          mirror) — re-read it;
        - a DEMOTE racing it leaves row0 pointing at the QUARANTINED row,
          whose contents stay identical to the pre-demotion state until a
          later maintenance cycle's post-drain reclaim — dispatching
          against it is linearizable (the read began before the demotion
          completed).

        Every read site captures entry.row before its
        _serve_degraded/_degraded check and resolves through here —
        reading entry.row AFTER the check races the demote's row
        retirement."""
        return entry.row if row0 < 0 else row0

    def _install_residency_mirror(self, entry, row=None, mirror=None):
        """Install ``entry`` as HOST-resident from a row array or a
        ready-made mirror (snapshot restore, a DUMP restored into a
        born-cold entry).  The residency manager owns the mirror install
        and the host-bytes accounting in one place."""
        self.residency.install_host(entry, row=row, mirror=mirror)

    def _seed_row(self, entry):
        """The entry's device row for mirror seeding (no lock held).  A
        few retries ride out a partial fault schedule; when the device is
        unreachable (a sticky CUDA error poisons the context for good),
        None — the op then goes to the device and fails typed instead of
        silently serving empty state."""
        try:
            self._drain()
        except Exception:
            pass  # queued segments fail typed on their own futures
        for _ in range(4):
            try:
                return self.executor.read_row(entry.pool, entry.row)
            except Exception:
                continue
        return None

    def _install_mirror(self, entry, row) -> None:
        """Install ``entry``'s mirror from ``row`` (under the mirror lock)
        and register the kind's recovery probe: a real read dispatch
        against the degraded pool, through the full ``_locked`` path, run
        by the health monitor while the breaker is open."""
        self._mirrors[entry.name] = mirror_for_entry(entry, row)
        pool, prow = entry.pool, entry.row
        self.health.ensure_probe(entry.kind, lambda: self.executor.read_row(pool, prow))

    def _mirror_call(self, entry, nops: int, fn):
        """Apply a degraded-mode or demoted-tier op to the entry's mirror
        (serialized by the mirror lock); an ImmediateResult, or None when
        the mirror was reconciled or promoted away between the check and
        the call.  Demoted is NOT degraded: a residency mirror's serves
        count in ``residency.host_serves``, never in ``degraded_ops``."""
        with self._mirror_lock:
            mirror = self._mirrors.get(entry.name)
            if mirror is None:
                return None
            out = fn(mirror)
            demoted = getattr(mirror, "residency", None) is not None
            if demoted:
                # Under the mirror lock: every demoted serve holds it.
                self.residency.host_serves += nops
        if not demoted:
            self.obs.degraded_ops.inc((entry.kind,), nops)
        return ImmediateResult(out)

    def _serve_degraded(self, entry, nops: int, fn):
        """The failover boundary every entry point crosses: the mirror's
        ImmediateResult when ``entry`` serves degraded, else None (the op
        proceeds to the device).  Every method that touches ``entry``'s
        row calls this (or _host_row) first, or acked state diverges from
        what reconcile writes back."""
        if self._degraded(entry):
            return self._mirror_call(entry, nops, fn)
        return None

    def _host_row(self, entry) -> np.ndarray:
        """``entry``'s current truth in device-row layout: its mirror's
        encoding while one is live (the device row is stale then, or
        there is none), else the device row.  Serves merge sources, BITOP
        operands and DUMP; a DISK-resident entry loads its mirror first."""
        row0 = entry.row  # BEFORE the residency check (see _tier_row)
        if row0 < 0 and entry.name not in self._mirrors:
            self._ensure_resident(entry)
        if self._mirrors:
            with self._mirror_lock:
                mirror = self._mirrors.get(entry.name)
                if mirror is not None:
                    return np.asarray(mirror.encode(entry.pool.row_units))
        self._drain()
        return np.asarray(
            self.executor.read_row(entry.pool, self._tier_row(entry, row0)))

    def _reconcile_kind(self, kind: str) -> bool:
        """Breaker-close hook (health.reconcile_cb): write every mirrored
        row of ``kind`` back to the device, then drop the mirrors — the
        device resumes from exactly the state the mirror served.  False
        (stay degraded; the breaker re-opens) if any write fails.  The
        write-back's wall time per kind (mirror encode + H2D) lands in
        ``reconcile_seconds``, the stall every op of the kind rode out."""
        t0 = time.monotonic()
        try:
            return self._reconcile_kind_inner(kind)
        finally:
            dt = time.monotonic() - t0
            self.reconcile_seconds[kind] = dt
            # LATENCY "reconcile": the write-back stall, beside
            # breaker-open and fsync-stall in LATENCY LATEST.
            lat = self.obs.latency
            if lat.threshold_ms > 0:
                lat.record("reconcile", dt * 1e3)

    def _reconcile_kind_inner(self, kind: str) -> bool:
        """The write-back holds the mirror lock: a degraded op between a
        write-back and the mirror's removal would land in a mirror about
        to be discarded.  The degraded flag clears under the same lock,
        so no serving thread sees "kind degraded, mirror missing" and
        seeds an orphan mirror."""
        with self._mirror_lock:
            # Residency mirrors are NOT breaker state: a demoted sketch
            # has no device row to write back to, and its mirror stays
            # the truth after the breaker closes.
            names = [n for n, m in self._mirrors.items()
                     if m.kind == kind and getattr(m, "residency", None) is None]
            for n in names:
                entry = self.registry.lookup(n)
                if entry is None:  # deleted while degraded
                    del self._mirrors[n]
                    continue
                # Sized to the entry's CURRENT pool: a degraded-window
                # bitset grow may have migrated it to a larger class.
                row = self._mirrors[n].encode(entry.pool.row_units)
                try:
                    # rtpulint: disable=RT001 write-back MUST hold the mirror lock: a degraded op interleaving between write-back and mirror drop would apply to a mirror about to be discarded (lost acked write); the degraded flag clears atomically with the mirrors below
                    self.executor.write_row(entry.pool, entry.row, row)
                except Exception:
                    return False
                del self._mirrors[n]
            self._mirror_epoch += 1
            self.health.clear_degraded(kind)
        return True

    def _guard_foreign(self, name: str) -> None:
        """Cross-backend WRONGTYPE: creating a sketch under a name the data
        grid holds is an error, not a shadow object.  ``foreign_exists``
        is the grid's lock-free probe (wired by the client)."""
        if (
            self.foreign_exists is not None
            and self.registry.lookup(name) is None
            and self.foreign_exists(name)
        ):
            raise TypeError(
                f"object {name!r} is held by the data grid (WRONGTYPE)"
            )

    def probe(self, name: str) -> bool:
        """Existence probe that never mutates (no expiry reap) and takes
        only the registry's lock."""
        entry = self.registry.lookup(name)
        return entry is not None and (
            entry.expire_at is None or time.time() < entry.expire_at
        )

    def collect_results(self, lazies) -> None:
        """Mailbox collect for the bulk APIs: honors ``mailbox_collect``;
        a failed group fetch leaves each item to its own ``.result()``."""
        if not self.config.gpu_sketch.mailbox_collect:
            return
        try:
            self.executor.collect_group(lazies)
        except Exception:
            pass

    # -- generic -----------------------------------------------------------

    def params(self, name: str) -> Optional[dict]:
        entry = self._live_lookup(name)
        return None if entry is None else entry.params

    def _lookup_kind(self, name: str, kind: str):
        """None if absent or expired; TypeError on a kind mismatch."""
        entry = self._live_lookup(name)
        if entry is not None and entry.kind != kind:
            raise TypeError(f"object {name!r} holds a {entry.kind}, not a {kind}")
        if entry is not None:
            # Residency heat feed: every read and write path resolves its
            # entry here (or via the ensure paths, which also touch) —
            # one decayed-counter bump per API call.
            self.residency.touch(name)
        return entry

    def exists(self, name: str) -> bool:
        return self._live_lookup(name) is not None

    def delete(self, name: str) -> bool:
        """Drop ``name``: detach, then zero, then free the row, so only one
        concurrent deleter (a user, the sweeper, a lazy expiry) wins and
        the row is reusable only once clean.  An expired but unswept
        entry is freed too, but reports False (Redis DEL on an expired
        key)."""
        with self._journal_gate:
            entry = self.registry.detach(name)
            if entry is None:
                return False
            seq = self._journal_rec("obj.del", name)
            was_expired = entry.expire_at is not None and time.time() >= entry.expire_at
            self._drain()
            # change_topology takes the gate held here, so no swap runs
            # between the detach and the reap: the epoch read now is the
            # detach's.
            self._reap_rows(entry.pool, self._entry_rows(entry),
                            entry.pool.topology_epoch)
            self.topk.drop(name)
            # Structural epoch advance + entry drop: a successor object
            # under this name continues the epoch sequence, so an
            # in-flight read of the OLD object never installs as fresh.
            self.nearcache.drop_object(name)
            if self._mirrors:
                with self._mirror_lock:
                    self._mirrors.pop(name, None)
            # Residency state dies with the object: heat, host-bytes
            # accounting, and the disk blob (retired into blob GC).
            self.residency.drop(name)
        return self._ack(not was_expired, seq)

    def rename(self, old: str, new: str) -> bool:
        """RENAME: False (nothing changes) when ``old`` is missing or
        expired.  Queued ops are drained first: queued bitset ops resolve
        their row by entry at flush time, and must land before the names
        move.  A displaced destination's row is zeroed before reuse."""
        with self._journal_gate:
            if old == new or self._live_lookup(old) is None:
                return False
            self._guard_foreign(new)
            self._drain()
            ok, dest = self.registry.rename_detach_dest(old, new)
            if not ok:  # the source expired since the check
                return False
            seq = self._journal_rec("obj.rename", old, new=new)
            if dest is not None:
                self._reap_rows(dest.pool, self._entry_rows(dest),
                                dest.pool.topology_epoch)
            self.topk.rename(old, new)
            # Both names change identity: drop entries + structural bumps.
            self.nearcache.drop_object(old)
            self.nearcache.drop_object(new)
            if self._mirrors:
                with self._mirror_lock:
                    self._mirrors.pop(new, None)
                    m = self._mirrors.pop(old, None)
                    if m is not None:
                        self._mirrors[new] = m
            # Residency state follows the rename (heat, host bytes, the
            # blob index; a displaced destination's blob retires).
            self.residency.rename(old, new)
        return self._ack(True, seq)

    def names(self, kind=None) -> list:
        for e in self.registry.entries():
            if e.expire_at is not None:
                self._expire_if_due(e)
        return self.registry.names(kind)

    def _require(self, name: str, kind: str):
        entry = self._lookup_kind(name, kind)
        if entry is None:
            raise RuntimeError(f"{kind} object {name!r} is not initialized")
        # Per-tenant call counter: every op path (coalesced or direct),
        # one inc per API call.
        self.obs.tenant_calls.inc((name, kind))
        return entry

    # -- bloom -------------------------------------------------------------

    def bloom_try_init(self, name, expected_insertions, false_probability) -> bool:
        m = golden.optimal_num_of_bits(expected_insertions, false_probability)
        k = golden.optimal_num_of_hash_functions(expected_insertions, m)
        params = {
            "size": m,
            "hash_iterations": k,
            "expected_insertions": expected_insertions,
            "false_probability": false_probability,
        }
        with self._journal_gate:
            self._live_lookup(name)  # reap an expired holder before tryInit
            self._guard_foreign(name)
            entry, created = self.registry.try_create(
                name, PoolKind.BLOOM, (class_words_for_bits(m),), params
            )
            # Journaled only when the create WON (replay of a lost race
            # must not re-parameterize the incumbent).
            seq = self._journal_rec(
                "bloom.init", name,
                ei=int(expected_insertions), fp=float(false_probability),
            ) if created else None
        if self.prewarmer is not None:
            # Pool attach: warm the host-hashed mixed ladder in the
            # background (the keyed ladders register on the first sight
            # of a codec signature, _bloom_submit_mixed_keys).
            self.prewarmer.register(
                entry.pool, ("bloom_mixed", k), prewarm.warm_bloom_mixed(k)
            )
        return self._ack(created, seq)

    def bloom_count(self, name) -> LazyResult:
        nc = self.nearcache
        captured = nc.epochs(name)  # before entry resolution, see contains
        entry = self._require(name, PoolKind.BLOOM)
        if nc.active(1):
            return nc.lookup_scalar(
                "bloom", name, ("count",),
                lambda: self._bloom_count_dispatch(entry), captured=captured,
            )
        return self._bloom_count_dispatch(entry)

    def _bloom_count_dispatch(self, entry) -> LazyResult:
        row0 = entry.row  # BEFORE the residency check (see _tier_row)
        res = self._serve_degraded(entry, 1, lambda mir: mir.count())
        if res is not None:
            return res
        self._drain()
        return self.executor.bloom_count(
            entry.pool, self._tier_row(entry, row0),
            entry.params["size"], entry.params["hash_iterations"],
        )

    # -- bloom read replication (the ReadMode.SLAVE analog): a hot
    # filter's row copies to every shard; reads rotate across the copies,
    # writes broadcast to all -------------------------------------------

    def bloom_replicate(self, name: str) -> bool:
        """Replicate a Bloom filter's row to every shard.  False on the
        single-device executor: there is nothing to spread reads over.

        Ordering against concurrent writers (Bloom bits only turn on, so
        an OR-merge is safe): the replica rows are published FIRST (new
        writers broadcast from then on), THEN queued primary-only writes
        drain, THEN the primary is OR-merged into each replica — a
        broadcast bit is never erased and a drained primary bit reaches
        every copy.  The drain and merge run twice, for writers that read
        the pre-publish state but had not submitted at the first drain;
        later ones are closed by ``_replication_fence``."""
        S = getattr(self.executor, "S", 1)
        if S <= 1:
            return False
        entry = self._lookup_kind(name, PoolKind.BLOOM)
        if entry is None:
            raise RuntimeError(f"bloom filter {name!r} is not initialized")
        if entry.row < 0 and not self.residency.promote(name):
            # Replication spreads DEVICE rows over shards.
            raise RuntimeError(
                f"bloom filter {name!r} could not promote to the device "
                f"tier for replication"
            )
        # The object's reads change placement: retire every cached entry.
        self.nearcache.note_structural(name)
        with self.registry._lock:
            if entry.replica_rows:
                return True
            replicas = [None] * S
            replicas[entry.row % S] = entry.row
            for s in range(S):
                if replicas[s] is None:
                    replicas[s] = entry.pool.alloc_row_with_residue(s, S)
            entry.replica_rows = replicas  # published: writers broadcast now
        for _ in range(2):
            self._drain()
            for r in replicas:
                if r != entry.row:
                    # replica |= primary, on the device (rows are uint32
                    # bitmaps, so the BitSet OR applies as it is).
                    self.executor.bitset_bitop(entry.pool, r, [r, entry.row], "or")
        return True

    def bloom_is_replicated(self, name: str) -> bool:
        entry = self._lookup_kind(name, PoolKind.BLOOM)
        return bool(entry is not None and entry.replica_rows)

    def _bloom_expand_ops(self, entry, B: int, is_add):
        """(rows[B'], expand_idx[B'], primary_pos[B]) for a replicated
        entry: each add fans out to every replica (consecutive slots,
        replica 0..S-1; the copies' results are identical, so any one
        stands in), each read goes to one replica in rotation.
        ``expand_idx`` maps an expanded op to its source op."""
        replicas = np.asarray(entry.replica_rows, np.int32)
        S = len(replicas)
        base = getattr(self, "_rr_counter", 0)
        self._rr_counter = base + B  # a benign race: balance, not correctness
        is_add = np.asarray(is_add, bool)
        counts = np.where(is_add, S, 1)
        primary_pos = np.zeros(B, np.int64)
        np.cumsum(counts[:-1], out=primary_pos[1:])
        expand_idx = np.repeat(np.arange(B, dtype=np.int64), counts)
        ranks = np.arange(len(expand_idx), dtype=np.int64) - primary_pos[expand_idx]
        rows = np.where(
            is_add[expand_idx],
            replicas[ranks % S],
            replicas[(base + expand_idx) % S],
        ).astype(np.int32)
        return rows, expand_idx, primary_pos

    def _replication_fence(self, entry, saw_replicas, redispatch) -> None:
        """Close the writer-vs-replicate race: a writer that read
        ``replica_rows`` as unset and submitted before the publish is
        reached by bloom_replicate's drain and merge; one whose submit
        lands after the merge re-checks here and, seeing the publish,
        re-dispatches the same ops as a broadcast.  Bloom bits only turn
        on, so the re-write is idempotent and the first result stands."""
        if not saw_replicas and entry.replica_rows:
            # The primary write already applied: this broadcast COMPLETES
            # an acked write, so it must not shed on the caller's deadline
            # (the replicas would diverge and rotating reads flap).  The
            # explicit None frame shadows any ambient deadline.
            with _ovl.deadline_scope(None):
                redispatch()

    # -- host-hashed bloom: callers hash on the host (H1, H2 are the 64-bit
    # murmur halves of each key, ``hashing.hash128_np``); the engine
    # reduces them mod the filter's m and ships the reduced pair ----------

    def _bloom_reduce(self, entry, H1, H2):
        return hashing.km_reduce_mod(H1, H2, entry.params["size"])

    def _bloom_dispatch_hashed(self, entry, h1m, h2m, is_add) -> LazyResult:
        """One mixed dispatch of reduced hashes, honouring replication:
        a replicated entry expands its ops (writes to every copy, reads
        rotating) and gathers results back per source op."""
        m, k = entry.params["size"], entry.params["hash_iterations"]
        B = len(h1m)
        is_add = np.asarray(is_add, bool)
        row0 = entry.row  # BEFORE the residency check (see _tier_row)
        res = self._serve_degraded(entry, B, lambda mir: mir.mixed(h1m, h2m, is_add))
        if res is not None:
            return res
        orig = (h1m, h2m, is_add)
        saw_replicas = bool(entry.replica_rows)
        if saw_replicas:
            rows, eidx, ppos = self._bloom_expand_ops(entry, B, is_add)
            h1m, h2m, is_add = h1m[eidx], h2m[eidx], is_add[eidx]
            gather = lambda v: v[ppos]  # noqa: E731
        else:
            rows = np.full(B, self._tier_row(entry, row0), np.int32)
            gather = None
        m_arr = np.full(len(rows), m, np.uint32)
        pool = entry.pool
        if self.coalescer is not None:
            # Adds and contains share ONE segment per (pool, k): the mixed
            # op keeps exact arrival-order results while mixed traffic
            # coalesces instead of fragmenting.
            fut = self._submit(
                ("bloom_mix", id(pool), k),
                lambda cols: self.executor.bloom_mixed(
                    pool, cols[0], cols[1], k, cols[2], cols[3], cols[4]
                ),
                (rows, m_arr, h1m, h2m, is_add),
                len(rows),
                pool_key=id(pool),
                tenant=entry.name,
            )
        else:
            fut = self.executor.bloom_mixed(pool, rows, m_arr, k, h1m, h2m, is_add)
        if bool(np.any(orig[2])):
            self._replication_fence(
                entry, saw_replicas,
                lambda: self._bloom_dispatch_hashed(entry, *orig),
            )
        return fut if gather is None else MappedFuture(fut, gather)

    def bloom_add(self, name, H1, H2) -> LazyResult:
        """Add host-hashed keys (``H1, H2``: uint64[B] murmur halves)."""
        with self._nc_mutate(name), self._journal_gate:
            entry = self._require(name, PoolKind.BLOOM)
            h1m, h2m = self._bloom_reduce(entry, H1, H2)
            m, k = entry.params["size"], entry.params["hash_iterations"]
            if (
                not self.config.gpu_sketch.exact_add_semantics
                and not entry.replica_rows
                # Degraded: the hashed path owns the mirror failover.
                and not self._degraded(entry)
            ):
                # The single-tenant bulk add dispatches at once, after the
                # queued coalesced ops flush: a contains submitted before
                # this add never observes its writes.
                self._drain()
                res = self.executor.bloom_add_fast_st(entry.pool, entry.row, m, k, h1m, h2m)
                self._replication_fence(
                    entry, False,
                    lambda: self._bloom_dispatch_hashed(
                        entry, h1m, h2m, np.ones(len(H1), bool)),
                )
            else:
                res = self._bloom_dispatch_hashed(entry, h1m, h2m, np.ones(len(H1), bool))
            # Journaled before the reduction (the raw twins): replay
            # reduces against the entry's params, as the live path does.
            return self._commit(
                res, "bloom.add", name, h1=np.asarray(H1), h2=np.asarray(H2),
            )

    def bloom_contains(self, name, H1, H2) -> LazyResult:
        """Membership of host-hashed keys: bool[B]."""
        # Epoch capture BEFORE entry resolution (see
        # bloom_contains_encoded).
        nc = self.nearcache
        captured = nc.epochs(name)
        entry = self._require(name, PoolKind.BLOOM)
        if nc.active(len(H1)):
            H1a, H2a = np.asarray(H1), np.asarray(H2)
            return nc.lookup_batch(
                "bloom", name, nc.hashed_keys(H1a, H2a), np.bool_,
                lambda idx: self._bloom_contains_dispatch(
                    entry,
                    H1a if idx is None else H1a[idx],
                    H2a if idx is None else H2a[idx],
                ),
                monotone=True, captured=captured,
            )
        return self._bloom_contains_dispatch(entry, H1, H2)

    def _bloom_contains_dispatch(self, entry, H1, H2) -> LazyResult:
        h1m, h2m = self._bloom_reduce(entry, H1, H2)
        m, k = entry.params["size"], entry.params["hash_iterations"]
        row0 = entry.row  # BEFORE the residency check (see _tier_row)
        if (
            self.coalescer is not None
            or entry.replica_rows
            or self._degraded(entry)  # the hashed path serves the mirror
        ):
            return self._bloom_dispatch_hashed(entry, h1m, h2m, np.zeros(len(H1), bool))
        return self.executor.bloom_contains_st(
            entry.pool, self._tier_row(entry, row0), m, k, h1m, h2m
        )

    def _runs_dispatch(self, pool, k):
        """Flush-time dispatch for the run-length mixed path: folds the
        segment's per-chunk metas into per-RUN arrays (row, m, is_add once
        per chunk + cumulative starts) and ships them with the
        concatenated key blocks.  Key lengths collapse to one scalar when
        every chunk is const-length."""

        def dispatch(cols, metas):
            C = len(metas)
            run_rows = np.empty(C, np.int32)
            run_m = np.empty(C, np.uint32)
            run_flags = np.empty(C, np.bool_)
            starts = np.zeros(C + 1, np.int32)
            const_val = None
            all_const = True
            for i, (nops, (row, m, flag, ln)) in enumerate(metas):
                run_rows[i] = row
                run_m[i] = m
                run_flags[i] = flag
                starts[i + 1] = starts[i] + nops
                if isinstance(ln, (int, np.integer)):
                    if const_val is None:
                        const_val = int(ln)
                    elif const_val != int(ln):
                        all_const = False
                else:
                    all_const = False
            if all_const:
                lengths = np.uint32(0 if const_val is None else const_val)
            else:
                lengths = np.concatenate([
                    np.full(nops, ln, np.uint32)
                    if isinstance(ln, (int, np.integer))
                    else np.asarray(ln, np.uint32)
                    for nops, (_, _, _, ln) in metas
                ])
            if not self.executor.supports_runs_metadata or C > 1024:
                # Expand the runs on the host and take the per-op path, as
                # the JAX engine does, when the executor has no runs path
                # (a live change_topology may swap in the sharded
                # executor under a queued segment; rows are topology-
                # stable, so the queued ops stay valid as they are) or
                # for a degenerate many-tiny-chunk segment (the JAX engine
                # caps its compiled run-table size at 1024).
                counts = np.diff(starts)
                if np.ndim(lengths) == 0:
                    lengths = np.full(int(starts[-1]), lengths, np.uint32)
                return self.executor.bloom_mixed_keys(
                    pool, np.repeat(run_rows, counts), np.repeat(run_m, counts),
                    k, cols[0], lengths, np.repeat(run_flags, counts),
                )
            return self.executor.bloom_mixed_keys_runs(
                pool, k, cols[0], lengths, run_rows, run_m, run_flags, starts
            )

        return dispatch

    def _bloom_submit_mixed_keys(self, entry, blocks, lengths, is_add):
        """Device-hash path: raw codec lanes ride the mixed kernel, so
        producer threads never hash.  ``is_add`` is a scalar for uniform
        batches or a per-op bool array for an ordered add/contains mix;
        uniform coalesced batches ride the run-length path where the
        executor has one.  A replicated entry expands its ops (writes to
        every copy, reads rotating) and gathers the results back per
        source op.  The lane count is part of the segment key, so
        concatenated chunks agree on shape."""
        m, k = entry.params["size"], entry.params["hash_iterations"]
        pool = entry.pool
        B, L = blocks.shape
        lengths = np.asarray(lengths, np.uint32)
        uniform = np.ndim(is_add) == 0
        row0 = entry.row  # BEFORE the residency check (see _tier_row)
        if self._degraded(entry):
            # Degraded: hash on the host (the mirror takes reduced hashes)
            # and serve from the golden mirror.
            flags = np.full(B, bool(is_add)) if uniform else np.asarray(is_add, bool)
            h1m, h2m = hashing.km_reduce_mod(
                *hashing.hash128_np(blocks, np.broadcast_to(lengths, (B,))), m)
            res = self._mirror_call(entry, B, lambda mir: mir.mixed(h1m, h2m, flags))
            if res is not None:
                return res
            # reconciled or promoted mid-call: on to the device
        if self.prewarmer is not None and B:
            # Codec-shaped signatures are unknown at pool attach: the
            # first sight of a coarse (pool, k, L) signature schedules
            # its ladders in the background; the seen-set keeps the
            # scans off every later submit.
            coarse = (id(pool), k, L)
            if coarse not in self._prewarm_seen:
                self._prewarm_seen.add(coarse)
                self._prewarm_keyed(pool, k, L, blocks, lengths)
        saw_replicas = bool(entry.replica_rows)
        any_add = bool(np.any(is_add))
        if (
            self.coalescer is not None
            and uniform
            and not saw_replicas
            and self.executor.supports_runs_metadata
        ):
            if lengths.ndim == 0:
                len_meta = int(lengths)
            else:
                const = B > 0 and bool(np.all(lengths == lengths[0]))
                len_meta = int(lengths[0]) if const else lengths
            fut = self._submit(
                ("bloom_mixkr", id(pool), k, L),
                self._runs_dispatch(pool, k),
                (blocks,),
                B,
                pool_key=id(pool),
                meta=(self._tier_row(entry, row0), m, bool(is_add), len_meta),
                tenant=entry.name,
            )
            if any_add:
                self._replication_fence(
                    entry, saw_replicas,
                    lambda: self._bloom_submit_mixed_keys(entry, blocks, lengths, True),
                )
            return fut
        lengths = np.broadcast_to(lengths, (B,))
        flags = np.full(B, bool(is_add)) if uniform else np.asarray(is_add, bool)
        orig = (blocks, lengths, flags)
        if saw_replicas:
            rows, eidx, ppos = self._bloom_expand_ops(entry, B, flags)
            blocks, lengths, flags = blocks[eidx], lengths[eidx], flags[eidx]
            gather = lambda v: v[ppos]  # noqa: E731
        else:
            rows = np.full(B, self._tier_row(entry, row0), np.int32)
            gather = None
        m_arr = np.full(len(rows), m, np.uint32)
        if self.coalescer is not None:
            fut = self._submit(
                ("bloom_mixk", id(pool), k, L),
                lambda cols: self.executor.bloom_mixed_keys(
                    pool, cols[0], cols[1], k, cols[2], cols[3], cols[4]
                ),
                (rows, m_arr, blocks, lengths, flags),
                len(rows),
                pool_key=id(pool),
                tenant=entry.name,
            )
        else:
            fut = self.executor.bloom_mixed_keys(
                pool, rows, m_arr, k, blocks, lengths, flags
            )
        if any_add:
            # The fence re-applies WRITES only: a mixed batch re-broadcasts
            # its add subset.
            ob, ol, of = orig
            self._replication_fence(
                entry, saw_replicas,
                lambda: self._bloom_submit_mixed_keys(entry, ob[of], ol[of], True),
            )
        return fut if gather is None else MappedFuture(fut, gather)

    def bloom_add_encoded(self, name, blocks, lengths):
        with self._nc_mutate(name), self._journal_gate:
            entry = self._require(name, PoolKind.BLOOM)
            # The mixed-keys path owns the degraded-mirror failover and
            # the replicated broadcast.
            if (
                self.config.gpu_sketch.exact_add_semantics
                or entry.replica_rows
                or self._degraded(entry)
            ):
                res = self._bloom_submit_mixed_keys(entry, blocks, lengths, True)
            else:
                m, k = entry.params["size"], entry.params["hash_iterations"]
                self._drain()
                res = self.executor.bloom_add_keys_st(
                    entry.pool, entry.row, m, k, blocks,
                    np.broadcast_to(np.asarray(lengths, np.uint32), (blocks.shape[0],)),
                )
                self._replication_fence(
                    entry, False,
                    lambda: self._bloom_submit_mixed_keys(entry, blocks, lengths, True),
                )
            # Journaled as the raw codec lanes already on the host (replay
            # hashes them there, bit-identical to the card's hash).
            return self._commit(
                res, "bloom.addk", name,
                blocks=np.asarray(blocks), lengths=np.asarray(lengths),
            )

    def bloom_contains_encoded(self, name, blocks, lengths):
        nc = self.nearcache
        # Epoch capture BEFORE entry resolution: a delete racing the
        # lookup bumps epochs in between, and a late capture would tag
        # the old object's results as fresh for its successor.
        captured = nc.epochs(name)
        entry = self._require(name, PoolKind.BLOOM)
        if nc.active(blocks.shape[0]):
            lengths_arr = np.asarray(lengths)

            def fetch(idx):
                if idx is None:
                    return self._bloom_contains_encoded_dispatch(entry, blocks, lengths)
                sub_l = lengths if lengths_arr.ndim == 0 else lengths_arr[idx]
                return self._bloom_contains_encoded_dispatch(entry, blocks[idx], sub_l)

            return nc.lookup_batch(
                "bloom", name, nc.encoded_keys(blocks, lengths), np.bool_,
                fetch, monotone=True, captured=captured,
            )
        return self._bloom_contains_encoded_dispatch(entry, blocks, lengths)

    def _bloom_contains_encoded_dispatch(self, entry, blocks, lengths):
        row0 = entry.row  # BEFORE the residency check (see _tier_row)
        if (
            self.coalescer is not None
            or entry.replica_rows
            or self._degraded(entry)
        ):
            return self._bloom_submit_mixed_keys(entry, blocks, lengths, False)
        m, k = entry.params["size"], entry.params["hash_iterations"]
        return self.executor.bloom_contains_keys_st(
            entry.pool, self._tier_row(entry, row0), m, k, blocks,
            np.broadcast_to(np.asarray(lengths, np.uint32), (blocks.shape[0],)),
        )

    def bloom_mixed_encoded(self, name, blocks, lengths, flags):
        """One ordered add/contains mix on one filter as ONE engine call;
        per-op results come back in command order."""
        flags = np.asarray(flags, bool)
        if not flags.any():
            return self.bloom_contains_encoded(name, blocks, lengths)
        if flags.all():
            return self.bloom_add_encoded(name, blocks, lengths)
        with self._nc_mutate(name), self._journal_gate:
            entry = self._require(name, PoolKind.BLOOM)
            res = self._bloom_submit_mixed_keys(entry, blocks, lengths, flags)
            if self.journal is None:
                return res  # the ADD subset below is a copy: skip it
            # The ADD subset only (contains ops change no state); adds of
            # one call are order-independent.
            lens_arr = np.asarray(lengths, np.uint32)
            if lens_arr.ndim == 0:
                lens_arr = np.full(blocks.shape[0], lens_arr, np.uint32)
            return self._commit(
                res, "bloom.addk", name,
                blocks=np.asarray(blocks)[flags], lengths=lens_arr[flags],
            )

    # -- hll ---------------------------------------------------------------

    def hll_ensure(self, name):
        self._live_lookup(name)  # reap an expired holder first
        self._guard_foreign(name)
        entry, _ = self.registry.try_create(name, PoolKind.HLL, (), {})
        self.residency.touch(name)  # heat feed (see _lookup_kind)
        if self.prewarmer is not None:
            # Seen-set gate: hll_ensure runs on EVERY op — register once
            # per pool, off the hot path.
            coarse = (id(entry.pool), "hll")
            if coarse not in self._prewarm_seen:
                self._prewarm_seen.add(coarse)
                self.prewarmer.register(
                    entry.pool, ("hll_add",), prewarm.warm_hll_add_changed())
        return entry

    def hll_add(self, name, c0, c1, c2):
        """PFADD of host-hashed lanes; the result is True iff a register
        grew.  Coalesced: one segment per HLL pool, per-op changed flags
        reduced with ``any``."""
        with self._nc_mutate(name), self._journal_gate:
            res = self._hll_add_impl(name, c0, c1, c2)
            return self._commit(
                res, "hll.add", name,
                c0=np.asarray(c0, np.uint32),
                c1=np.asarray(c1, np.uint32),
                c2=np.asarray(c2, np.uint32),
            )

    def _hll_add_impl(self, name, c0, c1, c2):
        entry = self.hll_ensure(name)
        res = self._serve_degraded(
            entry, len(c0), lambda mir: bool(np.any(mir.add_changed(c0, c1, c2))))
        if res is not None:
            return res
        if self.coalescer is not None:
            pool = entry.pool
            rows = np.full(len(c0), entry.row, np.int32)
            fut = self._submit(
                ("hll_add", id(pool)),
                lambda cols: self.executor.hll_add_changed(
                    pool, cols[0], cols[1], cols[2], cols[3]
                ),
                (rows, c0, c1, c2),
                len(c0),
                pool_key=id(pool),
                tenant=entry.name,
            )
            return MappedFuture(fut, lambda v: bool(np.any(v)))
        return self.executor.hll_add_single(entry.pool, entry.row, c0, c1, c2)

    def hll_add_encoded(self, name, blocks, lengths):
        """PFADD of raw codec lanes: without the coalescer the device
        hashes them (``hll_add_keys_single``); with it, or while the
        object serves degraded, the host does."""
        if self.coalescer is None:
            with self._nc_mutate(name), self._journal_gate:
                entry = self.hll_ensure(name)
                if not self._degraded(entry):
                    res = self.executor.hll_add_keys_single(
                        entry.pool, entry.row, blocks,
                        np.broadcast_to(np.asarray(lengths, np.uint32), (blocks.shape[0],)),
                    )
                    # Raw key lanes; replay hashes them on the host.
                    return self._commit(
                        res, "hll.addk", name,
                        blocks=np.asarray(blocks), lengths=np.asarray(lengths),
                    )
        c0, c1, c2, _ = hashing.murmur3_x86_128(blocks, lengths)
        return self.hll_add(name, c0, c1, c2)

    def hll_count(self, name):
        nc = self.nearcache
        captured = nc.epochs(name)  # before entry resolution
        entry = self._lookup_kind(name, PoolKind.HLL)
        if entry is None:
            return ImmediateResult(0)
        if nc.active(1):
            return nc.lookup_scalar(
                "hll", name, ("count",),
                lambda: self._hll_count_dispatch(entry), captured=captured,
            )
        return self._hll_count_dispatch(entry)

    def _hll_count_dispatch(self, entry):
        row0 = entry.row  # BEFORE the residency check (see _tier_row)
        res = self._serve_degraded(entry, 1, lambda mir: mir.count())
        if res is not None:
            return res
        self._drain()
        return self.executor.hll_count(entry.pool, self._tier_row(entry, row0))

    def hll_count_with(self, name, other_names) -> int:
        """PFCOUNT over several keys (the union's cardinality) without
        changing any: host max of the rows (16 KiB each), then the
        histogram and the Ertl estimate."""
        entries = [self._lookup_kind(n, PoolKind.HLL) for n in (name, *other_names)]
        entries = [e for e in entries if e is not None]
        if not entries:
            return 0
        self._drain()
        regs = None
        for e in entries:
            r = None
            row0 = e.row  # BEFORE the residency check (see _tier_row)
            if row0 < 0 and e.name not in self._mirrors:
                self._ensure_resident(e)  # DISK/born-cold union source
            if self._mirrors:
                # A degraded or demoted entry contributes its mirror's
                # registers (its device row is stale or absent), copied
                # under the mirror lock.
                with self._mirror_lock:
                    mir = self._mirrors.get(e.name)
                    if mir is not None:
                        r = mir.regs.copy()
            if r is None:
                r = self.executor.read_row(e.pool, self._tier_row(e, row0))
            regs = r if regs is None else np.maximum(regs, r)
        hist = np.bincount(regs, minlength=golden.HLL_Q + 2)
        return int(round(golden.ertl_estimate(hist)))

    def hll_merge_with(self, name, other_names) -> None:
        """PFMERGE: this = max(this, sources)."""
        with self._nc_mutate(name), self._journal_gate:
            self._hll_merge_with_impl(name, other_names)
            seq = self._journal_rec("hll.merge", name, srcs=[str(n) for n in other_names])
        self._ack(None, seq)

    def _hll_merge_with_impl(self, name, other_names) -> None:
        entry = self.hll_ensure(name)
        srcs = [e for e in (self._lookup_kind(n, PoolKind.HLL) for n in other_names)
                if e is not None]
        if not srcs:
            return
        if self._degraded(entry):
            # Merge on the host: each source gives its current truth (its
            # mirror if degraded, else its device row), gathered before
            # the dest's mirror lock is taken.
            rows = [self._host_row(e) for e in srcs]
            if self._mirror_call(entry, 1, lambda mir: mir.merge_rows(rows)) is not None:
                return
        if any(e.row < 0 for e in srcs):
            # A source without a device row (HOST/DISK tier): merge its
            # truth on the host into the destination row.
            self._merge_on_host(entry, srcs, np.maximum)
            return
        self._drain()
        self.executor.hll_merge(entry.pool, entry.row, [e.row for e in srcs])

    def _merge_on_host(self, entry, srcs, combine) -> None:
        """dst row = combine(dst row, each source's truth), read and
        written through the host: the merge path for a device-resident
        destination with a source on the host or disk tier (the device
        merge takes source rows on the card only).  The caller holds the
        gate, so no write lands on the destination in between."""
        rows = [self._host_row(e) for e in srcs]
        self._drain()
        dst = np.asarray(self.executor.read_row(entry.pool, entry.row))
        for r in rows:
            dst = combine(dst, np.asarray(r, dst.dtype))
        self.executor.write_row(entry.pool, entry.row, dst)

    # -- bitset ------------------------------------------------------------

    def _bitset_entry_with_capacity(self, name, min_bits: int):
        """Placement only: create the bitset, or migrate it to a size class
        that holds ``min_bits``, without extending its logical length
        (BITOP operands keep their true lengths)."""
        self._live_lookup(name)  # reap an expired holder first
        self._guard_foreign(name)
        entry, created = self.registry.try_create(
            name, PoolKind.BITSET, (class_words_for_bits(min_bits),), {"nbits": 0}
        )
        self.residency.touch(name)  # heat feed (see _lookup_kind)
        if not created:
            self._bitset_grow(entry, min_bits)
        return entry

    def bitset_ensure(self, name, min_bits: int = 1):
        entry = self._bitset_entry_with_capacity(name, min_bits)
        # Logical length: Redis string-length semantics (SETBIT grows the
        # value to cover the highest index ever touched).
        entry.params["nbits"] = max(entry.params.get("nbits", 0), int(min_bits))
        if self.prewarmer is not None:
            # Seen-set gate: bitset_ensure runs on EVERY op (see
            # hll_ensure) — register once per pool, off the hot path.
            coarse = (id(entry.pool), "bitset")
            if coarse not in self._prewarm_seen:
                self._prewarm_seen.add(coarse)
                if self.executor.supports_runs_metadata:
                    self.prewarmer.register(
                        entry.pool, ("bs_mixed_runs",),
                        prewarm.warm_bitset_mixed_runs())
                self.prewarmer.register(
                    entry.pool, ("bs_mixed",), prewarm.warm_bitset_mixed())
        return entry

    def _bitset_grow(self, entry, min_bits: int) -> None:
        """Auto-grow of Redis bitmaps: migrate the tenant to a larger size
        class.  Structural for the near cache: entry and exit bumps
        bracket the whole commit, so no read captured mid-migration can
        install."""
        need_words = class_words_for_bits(min_bits)
        if need_words <= entry.pool.row_units:
            return
        with self._nc_mutate(entry.name, structural=True):
            if entry.row < 0:
                # HOST/DISK residency: no device row to migrate — repoint
                # the entry to the larger size class.  The mirror's golden
                # model grows on demand, the blob loader zero-pads, and
                # promote/encode size to the entry's CURRENT pool.
                # Mutating callers hold the gate, so no transition can
                # interleave.
                entry.pool = self.registry.pool_for(PoolKind.BITSET, (need_words,))
                return
            self._bitset_migrate(entry, need_words)

    def _bitset_migrate(self, entry, need_words: int) -> None:
        """Copy the row into a row of the larger class on the device, then
        zero and free the old row, all under the dispatch lock, so no
        flush applies ops to the old row in between.  Queued ops resolve
        their row at flush time (``_bitset_submit_mixed``), so they follow
        the move."""
        self._drain()
        while True:
            old_pool, old_row = entry.pool, entry.row
            epoch_old = old_pool.topology_epoch
            new_pool = self.registry.pool_for(PoolKind.BITSET, (need_words,))
            with old_pool._dispatch_lock:
                if (
                    old_pool.topology_epoch != epoch_old
                    or entry.pool is not old_pool
                    or entry.row != old_row
                ):
                    # A topology swap rebuilt the layouts, or a concurrent
                    # grow moved the entry first: nothing is allocated
                    # yet, so re-evaluate.
                    if entry.pool.row_units >= need_words:
                        return
                    continue
                new_row = new_pool.alloc_row()
                self.executor.copy_row(old_pool, old_row, new_pool, new_row)
                # rtpulint: disable=RT001 zero-then-free must be atomic vs reallocation (the _reap_rows discipline): releasing between would hand out a dirty row
                self.executor.zero_row(old_pool, old_row)
                old_pool.free_row(old_row)
                entry.pool, entry.row = new_pool, new_row
                return

    def bitset_capacity_bits(self, name) -> int:
        entry = self._lookup_kind(name, PoolKind.BITSET)
        return 0 if entry is None else entry.pool.row_units * 32

    def _bitset_dispatch_group(self, pool, gidx, runs):
        """One resolved-placement group of a mixed-bit segment -> one
        launch: the run-length form up to 1024 runs (the JAX package's
        run-table size) where the executor has one, per-op arrays
        otherwise."""
        if self.executor.supports_runs_metadata and len(runs) <= 1024:
            run_rows = np.array([r for _, r, _ in runs], np.int32)
            run_ops = np.array([o for _, _, o in runs], np.uint32)
            starts = np.zeros(len(runs) + 1, np.int32)
            starts[1:] = np.cumsum([n for n, _, _ in runs])
            return self.executor.bitset_mixed_runs(pool, gidx, run_rows, run_ops, starts)
        rows = np.concatenate([np.full(n, r, np.int32) for n, r, _ in runs])
        ops_col = np.concatenate([np.full(n, o, np.uint32) for n, _, o in runs])
        return self.executor.bitset_mixed(pool, rows, gidx, ops_col)

    def _bitset_submit_mixed(self, entry, idx, opcode: int):
        """Coalesced path: every single-bit opcode rides ONE segment per
        pool through the affine op (exact sequential semantics), so
        interleaved set/clear/flip/get never fragment.

        Placement resolves at FLUSH time, under the dispatch lock, from
        the per-chunk metas: a migration committing while ops sit queued
        repoints the entry, and rows fixed at submit would land writes in
        the old, freed row."""

        def dispatch(cols, metas):
            offs = [0]
            for nops, _m in metas:
                offs.append(offs[-1] + nops)
            # Residency stragglers: a chunk whose entry DEMOTED between
            # submit and flush serves from the mirror — flush-time
            # residency resolution, the same discipline as the flush-time
            # row resolution below.  Applied OUTSIDE the dispatch lock:
            # mirror → dispatch is the engine-wide lock order (snapshot
            # capture, reconcile, promote).  A None from _mirror_call
            # means the entry promoted mid-flight — its row is live again
            # and the group pass re-reads it under the lock.
            mirror_parts = {}
            # Rows as this pass saw them: a reader chunk (readers enqueue
            # gate-free) whose entry demotes after this pass dispatches
            # against the quarantined row, intact until a later drain —
            # linearizable, as in _tier_row.
            rows_seen = [e.row for _n, (e, _op) in metas]
            for mi, (nops, (e, op)) in enumerate(metas):
                if rows_seen[mi] >= 0:
                    continue
                gidx = np.asarray(cols[0][offs[mi]:offs[mi + 1]])
                ops_col = np.full(nops, op, np.uint32)
                res = None
                for _ in range(4):
                    res = self._mirror_call(
                        e, nops, lambda mir, g=gidx, o=ops_col: mir.mixed(g, o))
                    if res is not None or e.row >= 0:
                        break
                    # Row-less with no mirror: the entry SPILLED between
                    # this chunk queueing and the flush (spill drains
                    # first, but readers enqueue gate-free) — reload the
                    # mirror and re-apply.  load_nowait, never load: the
                    # gate holder may be draining on THIS flush.
                    if not self.residency.load_nowait(e):
                        time.sleep(0.001)
                if res is not None:
                    mirror_parts[mi] = res
                elif e.row < 0:
                    raise NonRetryableDispatchError(
                        f"bitset chunk for {e.name!r} has neither a device "
                        f"row nor a loadable mirror")
            with self.executor._dispatch_lock:  # atomic vs a migration commit
                # Consecutive device chunks grouped by their resolved pool
                # (op order is kept — groups split at chunk boundaries and
                # at mirror-served chunks); more than one group only when
                # a migration or a demotion committed mid-segment.
                groups = []  # ["dev", pool, runs, lo, hi] | ["mir", res, None, lo, hi]
                off = 0
                for mi, (nops, (e, op)) in enumerate(metas):
                    part = mirror_parts.get(mi)
                    row = e.row if e.row >= 0 else rows_seen[mi]
                    if part is not None:
                        groups.append(["mir", part, None, off, off + nops])
                    elif groups and groups[-1][0] == "dev" and groups[-1][1] is e.pool:
                        groups[-1][2].append((nops, row, op))
                        groups[-1][4] = off + nops
                    else:
                        groups.append(["dev", e.pool, [(nops, row, op)], off, off + nops])
                    off += nops
                results = []
                # Mirror parts already applied: a later failure must not
                # be retried blind (it would re-apply them).
                applied = bool(mirror_parts)
                for tag, pool, runs, lo, hi in groups:
                    if tag == "mir":
                        results.append(pool)  # the ImmediateResult
                        continue
                    try:
                        results.append(
                            self._bitset_dispatch_group(pool, cols[0][lo:hi], runs))
                    except NonRetryableDispatchError:
                        raise
                    except Exception as exc:
                        if not applied:
                            raise  # nothing applied yet: retryable
                        # Earlier groups already changed state: a retry
                        # would apply OP_SET/OP_FLIP twice.
                        raise NonRetryableDispatchError(
                            "a later group of a split mixed-bit launch failed "
                            "after earlier groups applied"
                        ) from exc
                    applied = True
            return results[0] if len(results) == 1 else _ConcatLazy(results)

        return self._submit(
            ("bs_mix", id(entry.pool)),
            dispatch,
            (np.asarray(idx, np.uint32),),
            len(idx),
            pool_key=id(entry.pool),
            meta=(entry, opcode),
            tenant=entry.name,
        )

    def _bitset_rw(self, opcode: int, method, entry, idx):
        res = self._serve_degraded(
            entry, len(idx),
            lambda mir: mir.mixed(idx, np.full(len(idx), opcode, np.uint32)),
        )
        if res is not None:
            return res
        if self.coalescer is not None:
            return self._bitset_submit_mixed(entry, idx, opcode)
        # Placement and dispatch atomic vs a concurrent migration.
        with self.executor._dispatch_lock:
            rows = np.full(len(idx), entry.row, np.int32)
            return method(entry.pool, rows, idx)

    def bitset_set(self, name, idx, value: bool):
        """SETBIT of every index to ``value``; previous bit per op.
        Clearing bits retires monotone positives: a structural bump."""
        idx = np.asarray(idx, np.uint32)
        with self._nc_mutate(name, structural=not value), self._journal_gate:
            entry = self.bitset_ensure(name, int(idx.max()) + 1 if idx.size else 1)
            if value:
                res = self._bitset_rw(bitset_ops.OP_SET, self.executor.bitset_set, entry, idx)
            else:
                res = self._bitset_rw(
                    bitset_ops.OP_CLEAR, self.executor.bitset_clear_bits, entry, idx
                )
            return self._commit(res, "bitset.set", name, idx=idx, value=bool(value))

    def bitset_flip(self, name, idx):
        idx = np.asarray(idx, np.uint32)
        # Flips clear bits: structural.
        with self._nc_mutate(name, structural=True), self._journal_gate:
            entry = self.bitset_ensure(name, int(idx.max()) + 1 if idx.size else 1)
            res = self._bitset_rw(bitset_ops.OP_FLIP, self.executor.bitset_flip, entry, idx)
            return self._commit(res, "bitset.flip", name, idx=idx)

    def bitset_get(self, name, idx):
        """GETBIT; an index past the row's capacity reads 0 (it is sent as
        index 0 and its result masked)."""
        idx = np.asarray(idx, np.uint32)
        nc = self.nearcache
        captured = nc.epochs(name)  # before entry resolution
        entry = self._lookup_kind(name, PoolKind.BITSET)
        if entry is None:
            return ImmediateResult(np.zeros(len(idx), bool))
        if nc.active(len(idx)):
            return nc.lookup_batch(
                "bitset", name, [int(i) for i in idx], np.bool_,
                lambda midx: self._bitset_get_dispatch(
                    entry, idx if midx is None else idx[midx]),
                monotone=True,  # OP_CLEAR/OP_FLIP/replace are structural
                captured=captured,
            )
        return self._bitset_get_dispatch(entry, idx)

    def _bitset_get_dispatch(self, entry, idx):
        in_range = idx < entry.pool.row_units * 32
        safe_idx = np.where(in_range, idx, 0).astype(np.uint32)
        row0 = entry.row  # BEFORE the residency check (see _tier_row)
        res = self._serve_degraded(
            entry, len(idx),
            lambda mir: mir.mixed(
                safe_idx, np.full(len(idx), bitset_ops.OP_GET, np.uint32)) & in_range,
        )
        if res is not None:
            return res
        if self.coalescer is not None:
            fut = self._bitset_submit_mixed(entry, safe_idx, bitset_ops.OP_GET)
            return MappedFuture(fut, lambda v: v & in_range)
        rows = np.full(len(idx), self._tier_row(entry, row0), np.int32)
        res = self.executor.bitset_get(entry.pool, rows, safe_idx)
        return MappedFuture(res, lambda v: v & in_range)

    def bitset_set_range(self, name, from_bit, to_bit, value: bool):
        with self._nc_mutate(name, structural=not value), self._journal_gate:
            entry = self.bitset_ensure(name, int(to_bit))
            res = self._serve_degraded(
                entry, 1, lambda mir: mir.set_range(int(from_bit), int(to_bit), bool(value)))
            if res is None:
                self._drain()
                res = self.executor.bitset_set_range(
                    entry.pool, entry.row, int(from_bit), int(to_bit), value
                )
            return self._commit(
                res, "bitset.range", name,
                frm=int(from_bit), to=int(to_bit), value=bool(value),
            )

    def _nc_scalar(self, kind, name, key, dispatch, captured) -> int:
        """Near-cache plumbing shared by every scalar read-through (bitset
        cardinality/length/bitpos, CMS total): epoch-tagged, one host
        int.  ``captured``: the epoch pair sampled before entry
        resolution."""
        nc = self.nearcache
        if nc.active(1):
            return int(nc.lookup_scalar(kind, name, key, dispatch, captured=captured).result())
        return int(dispatch().result())

    def _bitset_scalar(self, name, empty: int, key, mirror_fn, method, *args) -> int:
        captured = self.nearcache.epochs(name)  # before entry resolution
        entry = self._lookup_kind(name, PoolKind.BITSET)
        if entry is None:
            return empty

        def dispatch():
            row0 = entry.row  # BEFORE the residency check (see _tier_row)
            res = self._serve_degraded(entry, 1, mirror_fn)
            if res is not None:
                return res
            self._drain()
            return method(entry.pool, self._tier_row(entry, row0), *args)

        return self._nc_scalar("bitset", name, key, dispatch, captured)

    def bitset_cardinality(self, name) -> int:
        return self._bitset_scalar(
            name, 0, ("card",), lambda mir: mir.cardinality(),
            self.executor.bitset_cardinality)

    def bitset_length(self, name) -> int:
        return self._bitset_scalar(
            name, 0, ("len",), lambda mir: mir.length(), self.executor.bitset_length)

    def bitset_bitpos(self, name, target_bit: int) -> int:
        return self._bitset_scalar(
            name, -1 if target_bit else 0, ("bitpos", int(target_bit)),
            lambda mir: mir.bitpos(int(target_bit)),
            self.executor.bitset_bitpos, target_bit,
        )

    def bitset_bitop(self, dest: str, src_names, op: str) -> None:
        """BITOP dest = op(srcs).  Every operand (dest included) is grown
        into one size class first, so their rows share a pool.  Redis
        semantics: dest is replaced, and the result's length is the
        longest source's; unary NOT complements the source's whole
        byte-aligned string and is masked there, so the row's tail bits
        stay 0."""
        # dest is REPLACED: structural.
        with self._nc_mutate(dest, structural=True), self._journal_gate:
            self._bitset_bitop_impl(dest, src_names, op)
            seq = self._journal_rec(
                "bitset.bitop", dest, srcs=[str(n) for n in src_names], bop=str(op)
            )
        self._ack(None, seq)

    def _bitset_bitop_impl(self, dest: str, src_names, op: str) -> None:
        max_bits = max(
            (self.bitset_capacity_bits(n) for n in (dest, *src_names)), default=0
        ) or 32 * 32
        dst = self._bitset_entry_with_capacity(dest, max_bits)
        srcs, src_nbits, src_entries = [], [], []
        for n in src_names:
            e = self._bitset_entry_with_capacity(n, max_bits)
            srcs.append(e.row)
            src_nbits.append(e.params.get("nbits", 0))
            src_entries.append(e)
        nbits = -(-src_nbits[0] // 8) * 8 if op == "not" else max(src_nbits, default=0)
        row_less = any(e.row < 0 for e in src_entries)
        if self._degraded(dst) or row_less:
            # BITOP on the host: decode every source's current truth (all
            # operands share one size class after the grow above),
            # combine, and REPLACE the dest — its mirror while it has
            # one, else its device row (a source on the host or disk
            # tier has no row for the device BITOP to read).
            nb_phys = dst.pool.row_units * 32
            src_bits = [_bits_from_words(self._host_row(e), nb_phys) for e in src_entries]
            if op == "not":
                out = np.zeros(nb_phys, bool)
                out[:nbits] = ~src_bits[0][:nbits]
            else:
                fn = {"and": np.logical_and, "or": np.logical_or,
                      "xor": np.logical_xor}[op]
                out = src_bits[0].copy()
                for b in src_bits[1:]:
                    out = fn(out, b)
            if self._mirror_call(dst, 1, lambda mir: mir.replace_bits(out)) is not None:
                dst.params["nbits"] = nbits
                return
            if row_less and dst.row >= 0:
                self._drain()
                self.executor.write_row(
                    dst.pool, dst.row, _words_from_bits(out, dst.pool.row_units))
                dst.params["nbits"] = nbits
                return
        self._drain()
        self.executor.bitset_bitop(
            dst.pool, dst.row, srcs, op, limit_bits=nbits if op == "not" else None
        )
        dst.params["nbits"] = nbits

    def bitset_to_bytes(self, name) -> bytes:
        """The row's bytes trimmed to the logical length (Redis STRLEN
        semantics), so both packages return identical bytes."""
        entry = self._lookup_kind(name, PoolKind.BITSET)
        if entry is None:
            return b""
        nbytes = -(-entry.params.get("nbits", 0) // 8)
        row0 = entry.row  # BEFORE the residency check (see _tier_row)
        res = self._serve_degraded(
            entry, 1,
            lambda mir: np.packbits(mir.bits, bitorder="little").tobytes()[:nbytes])
        if res is not None:
            return res.result()
        self._drain()
        return self.executor.read_row(
            entry.pool, self._tier_row(entry, row0)).tobytes()[:nbytes]

    # -- cms ---------------------------------------------------------------

    def cms_try_init(self, name, depth: int, width: int) -> bool:
        with self._journal_gate:
            self._live_lookup(name)  # reap an expired holder before tryInit
            self._guard_foreign(name)
            entry, created = self.registry.try_create(
                name, PoolKind.CMS, (depth, width),
                {"depth": depth, "width": width},
            )
            seq = self._journal_rec(
                "cms.init", name, depth=int(depth), width=int(width)
            ) if created else None
        if self.prewarmer is not None:
            self.prewarmer.register(
                entry.pool, ("cms_updest", depth, width),
                prewarm.warm_cms_update_estimate(depth, width),
            )
        return self._ack(created, seq)

    def cms_total(self, name) -> int:
        """Total inserted weight: every increment adds its weight to one
        cell per depth row, so row 0's sum is the total."""
        captured = self.nearcache.epochs(name)  # before entry resolution
        entry = self._require(name, PoolKind.CMS)
        w = entry.params["width"]

        def dispatch():
            row0 = entry.row  # BEFORE the residency check (see _tier_row)
            res = self._serve_degraded(entry, 1, lambda mir: mir.total())
            if res is not None:
                return res
            self._drain()
            row = self.executor.read_row(entry.pool, self._tier_row(entry, row0))
            return ImmediateResult(int(np.asarray(row[:w], np.uint64).sum()))

        return self._nc_scalar("cms", name, ("total",), dispatch, captured)

    def cms_reset(self, name) -> None:
        """Zero a CMS's counters in place; the object and its top-K
        configuration stay.  Counters are REPLACED: structural."""
        with self._nc_mutate(name, structural=True), self._journal_gate:
            entry = self._require(name, PoolKind.CMS)
            if self._serve_degraded(entry, 1, lambda mir: mir.reset()) is None:
                self._drain()
                self.executor.zero_row(entry.pool, entry.row)
            seq = self._journal_rec("cms.reset", name)
        self._ack(None, seq)

    def cms_merge(self, name, other_names) -> None:
        """CMS.MERGE: this += each source, counter for counter (mod 2**32);
        every source must share this sketch's geometry."""
        with self._nc_mutate(name), self._journal_gate:
            self._cms_merge_impl(name, other_names)
            seq = self._journal_rec("cms.merge", name, srcs=[str(n) for n in other_names])
        self._ack(None, seq)

    def _cms_merge_impl(self, name, other_names) -> None:
        entry = self._require(name, PoolKind.CMS)
        srcs = []
        for n in other_names:
            e = self._require(n, PoolKind.CMS)
            if (e.params["depth"], e.params["width"]) != (
                entry.params["depth"], entry.params["width"]
            ):
                raise ValueError("cannot merge CMS with different geometry")
            srcs.append(e)
        if not srcs:
            return
        if self._degraded(entry):
            # CMS.MERGE on the host: each source's current truth summed
            # into the dest mirror (see hll_merge_with).
            rows = [self._host_row(e) for e in srcs]
            if self._mirror_call(entry, 1, lambda mir: mir.merge_rows(rows)) is not None:
                return
        if any(e.row < 0 for e in srcs):
            self._merge_on_host(entry, srcs, np.add)  # uint32: wraps mod 2**32
            return
        self._drain()
        self.executor.cms_merge(entry.pool, entry.row, [e.row for e in srcs])

    def cms_add(self, name, H1, H2, weights):
        with self._nc_mutate(name), self._journal_gate:
            res = self._cms_add_impl(name, H1, H2, weights)
            return self._commit(
                res, "cms.add", name,
                h1=np.asarray(H1), h2=np.asarray(H2),
                w=np.asarray(weights, np.uint32),
            )

    def _cms_add_impl(self, name, H1, H2, weights):
        entry = self._require(name, PoolKind.CMS)
        d, w = entry.params["depth"], entry.params["width"]
        t = _spans.clock()
        h1w, h2w = hashing.km_reduce_mod(H1, H2, w)
        _spans.spent("hash", t)
        wts = np.asarray(weights, np.uint32)
        res = self._serve_degraded(
            entry, len(H1), lambda mir: mir.update_estimate(h1w, h2w, wts))
        if res is not None:
            return res
        # After the residency check (writers hold the gate: the row is
        # stable; a born-cold entry has none until promoted).
        rows = np.full(len(H1), entry.row, np.int32)
        if self.coalescer is not None:
            # Updates and estimates share one segment per (pool, d, w);
            # estimate ops ride with weight 0.
            pool = entry.pool
            return self._submit(
                ("cms_mix", id(pool), d, w),
                lambda cols: self.executor.cms_update_estimate(
                    pool, cols[0], cols[1], cols[2], cols[3], d, w
                ),
                (rows, h1w, h2w, wts),
                len(H1),
                pool_key=id(pool),
                tenant=entry.name,
            )
        return self.executor.cms_update_estimate(
            entry.pool, rows, h1w, h2w, wts, d, w
        )

    def cms_estimate(self, name, H1, H2):
        nc = self.nearcache
        captured = nc.epochs(name)  # before entry resolution
        entry = self._require(name, PoolKind.CMS)
        if nc.active(len(H1)):
            H1a, H2a = np.asarray(H1), np.asarray(H2)
            return nc.lookup_batch(
                "cms", name, nc.hashed_keys(H1a, H2a), np.uint32,
                lambda idx: self._cms_estimate_dispatch(
                    entry,
                    H1a if idx is None else H1a[idx],
                    H2a if idx is None else H2a[idx],
                ),
                monotone=False,  # any add can raise an estimate
                captured=captured,
            )
        return self._cms_estimate_dispatch(entry, H1, H2)

    def _cms_estimate_dispatch(self, entry, H1, H2):
        d, w = entry.params["depth"], entry.params["width"]
        t = _spans.clock()
        h1w, h2w = hashing.km_reduce_mod(H1, H2, w)
        _spans.spent("hash", t)
        row0 = entry.row  # BEFORE the residency check (see _tier_row)
        res = self._serve_degraded(
            entry, len(H1),
            lambda mir: mir.update_estimate(h1w, h2w, np.zeros(len(H1), np.uint32)))
        if res is not None:
            return res
        rows = np.full(len(H1), self._tier_row(entry, row0), np.int32)
        if self.coalescer is not None:
            pool = entry.pool
            return self._submit(
                ("cms_mix", id(pool), d, w),
                lambda cols: self.executor.cms_update_estimate(
                    pool, cols[0], cols[1], cols[2], cols[3], d, w
                ),
                (rows, h1w, h2w, np.zeros(len(H1), np.uint32)),
                len(H1),
                pool_key=id(pool),
                tenant=entry.name,
            )
        return self.executor.cms_estimate(entry.pool, rows, h1w, h2w, d, w)

    def cms_add_seq(self, name, H1, H2, weights):
        """Streaming add+estimate via kernel K1: op j's estimate is its
        at-sequence-point value.  Falls back to the vectorized path (whose
        estimates include the whole batch) in exactly the JAX engine's
        cases: the object serves degraded (its mirror has whole-call
        semantics), no sequential kernel, ``(d*w) % 128 != 0``,
        ``d*w*4 > 8 MiB``, or an empty batch.  K1 itself has none of these
        limits; the gate keeps both packages' answers the same.  A row
        that the residency ladder demoted serves from its mirror (whole
        call semantics, like the degraded case); once promoted back, K1
        runs on its new row.  The wait for the gate and the coalescer's
        drain are the calling data call's ``drain`` stage, the mod-w
        reduction its ``hash``."""
        t = _spans.clock(wait=True)
        with self._nc_mutate(name), self._journal_gate:
            _spans.spent("drain", t)
            res = self._cms_add_seq_impl(name, H1, H2, weights)
            # Same record as cms_add: the STATE effect of the sequential
            # and the vectorized add is identical (only the returned
            # estimates' sequence point differs), so replay shares one
            # path.
            return self._commit(
                res, "cms.add", name,
                h1=np.asarray(H1), h2=np.asarray(H2),
                w=np.asarray(weights, np.uint32),
            )

    def _cms_add_seq_impl(self, name, H1, H2, weights):
        entry = self._require(name, PoolKind.CMS)
        d, w = entry.params["depth"], entry.params["width"]
        if (
            self._degraded(entry)
            or not self.executor.supports_seq_cms
            or (d * w) % 128 != 0
            or d * w * 4 > (8 << 20)
            or len(H1) == 0
        ):
            # _cms_add_impl, not cms_add: this call already holds the
            # gate and bumped the epochs.
            return self._cms_add_impl(name, H1, H2, weights)
        t = _spans.clock()
        h1w, h2w = hashing.km_reduce_mod(H1, H2, w)
        _spans.spent("hash", t)
        weights = np.asarray(weights, np.uint32)
        t = _spans.clock(wait=True)
        self._drain()  # sequential semantics: all queued ops land first
        _spans.spent("drain", t)
        B = len(h1w)
        if B <= self._SEQ_CHUNK:
            return self.executor.cms_update_estimate_seq(
                entry.pool, entry.row, h1w, h2w, weights, d, w
            )
        parts = [
            self.executor.cms_update_estimate_seq(
                entry.pool, entry.row,
                h1w[i : i + self._SEQ_CHUNK],
                h2w[i : i + self._SEQ_CHUNK],
                weights[i : i + self._SEQ_CHUNK],
                d, w,
            )
            for i in range(0, B, self._SEQ_CHUNK)
        ]
        return ImmediateResult(
            np.concatenate([np.asarray(p.result()) for p in parts])
        )


class HostSketchEngine:
    """Golden-model backend (``Config().use_host_sketch()``): the golden
    NumPy models on the host, the 'Redis server on the host' analog and
    the plain reference a benchmark of the card engine compares with.
    Same hash material and formulas as the card engine, so the answers
    agree bit for bit; the same TTL, DUMP and RESTORE surface.  Nothing
    routes here on its own: the caller chooses it."""

    def __init__(self, config):
        self.config = config
        self._lock = _witness.named(threading.RLock(), "engine.host")
        self._objects: dict[str, dict] = {}
        # Same observability surface as the card engine (so a RESP server
        # or client fronting either backend finds one bundle to record
        # into); the host engine has no coalescer/executor to instrument.
        self.obs = Observability(
            trace_sample_rate=getattr(config, "trace_sample_rate", 0.0),
            trace_max_spans=getattr(config, "trace_max_spans", 2048),
            latency_threshold_ms=getattr(
                config, "latency_monitor_threshold_ms", 0
            ),
        )
        self.topk = TopKStore()
        # Wired by the client to the grid store's lock-free ``probe`` (one
        # logical keyspace — same contract as TorchSketchEngine).  Called
        # while holding self._lock, so it MUST NOT take the grid's lock.
        self.foreign_exists = None

    def _guard_foreign(self, name: str) -> None:
        if (
            self.foreign_exists is not None
            and name not in self._objects
            and self.foreign_exists(name)
        ):
            raise TypeError(
                f"object {name!r} is held by the data grid (WRONGTYPE)"
            )

    def probe(self, name: str) -> bool:
        """Lock-free existence probe for the grid's guard."""
        o = self._objects.get(name)
        if o is None:
            return False
        exp = o.get("expire_at")
        return exp is None or time.time() < exp

    def shutdown(self) -> None:
        pass

    # -- generic -----------------------------------------------------------

    def _live(self, name):
        """Lazy expiry (Redis-style): an overdue object vanishes on touch."""
        o = self._objects.get(name)
        if o is not None and o.get("expire_at") is not None:
            if time.time() >= o["expire_at"]:
                del self._objects[name]
                self.topk.drop(name)
                return None
        return o

    def exists(self, name) -> bool:
        with self._lock:
            return self._live(name) is not None

    def delete(self, name) -> bool:
        with self._lock:
            live = self._live(name) is not None
            self._objects.pop(name, None)
            self.topk.drop(name)
            return live

    def rename(self, old, new) -> bool:
        with self._lock:
            if old == new or self._live(old) is None:
                return False
            self._guard_foreign(new)  # one keyspace: RENAME can't shadow grid
            self._objects[new] = self._objects.pop(old)
            self.topk.rename(old, new)
            return True

    def names(self, kind=None):
        with self._lock:
            return [
                n
                for n in list(self._objects)
                if self._live(n) is not None
                and (kind is None or self._objects[n]["kind"] == kind)
            ]

    def params(self, name):
        with self._lock:
            o = self._live(name)
            return None if o is None else o["params"]

    def _require(self, name, kind):
        o = self._lookup_kind(name, kind)
        if o is None:
            raise RuntimeError(f"{kind} object {name!r} is not initialized")
        return o

    def _lookup_kind(self, name, kind):
        with self._lock:
            o = self._live(name)
            if o is not None and o["kind"] != kind:
                raise TypeError(f"object {name!r} holds a {o['kind']}, not a {kind}")
            return o

    # -- TTL / dump parity with the card engine ----------------------------

    def expire(self, name, ttl_s: float) -> bool:
        return self.expire_at(name, time.time() + ttl_s)

    def expire_at(self, name, ts: float) -> bool:
        with self._lock:
            o = self._live(name)
            if o is None:
                return False
            o["expire_at"] = float(ts)
            return True

    def clear_expire(self, name) -> bool:
        with self._lock:
            o = self._live(name)
            if o is None or o.get("expire_at") is None:
                return False
            o["expire_at"] = None
            return True

    def remain_ttl_ms(self, name) -> int:
        with self._lock:
            o = self._live(name)
            if o is None:
                return -2
            if o.get("expire_at") is None:
                return -1
            return max(0, int((o["expire_at"] - time.time()) * 1000))

    # Data-only dump wire format (no pickle: dump blobs may cross trust
    # boundaries): RTPH | u32 header_len | json header | npy arrays.  The
    # header records the golden-model class by NAME and its int scalars;
    # arrays ride as concatenated .npy blobs in header order.  Byte-equal
    # to the JAX package's host engine.  A card engine's dump (RTPU)
    # restores here too, and this engine's dumps restore there.
    _DUMP_MAGIC = HOST_DUMP_MAGIC

    def dump(self, name):
        with self._lock:
            o = self._live(name)
            if o is None:
                return None
            m = o["model"]
            scalars, arrays = {}, []
            for k_, v_ in vars(m).items():
                if isinstance(v_, np.ndarray):
                    arrays.append(k_)
                elif isinstance(v_, (int, np.integer)):
                    scalars[k_] = int(v_)
                else:  # pragma: no cover — golden models hold ints+arrays
                    raise TypeError(f"non-serializable model field {k_!r}")
            header = json.dumps(
                {
                    "v": 2,
                    "kind": o["kind"],
                    "params": dict(o["params"]),
                    "model_cls": type(m).__name__,
                    "scalars": scalars,
                    "arrays": arrays,
                    "topk": self.topk.export_state(name),
                }
            ).encode("utf-8")
            buf = io.BytesIO()
            for k_ in arrays:
                np.save(buf, getattr(m, k_), allow_pickle=False)
            return (
                self._DUMP_MAGIC
                + struct.pack("<I", len(header))
                + header
                + buf.getvalue()
            )

    # Per-class schemas for restore-time validation: dumps cross trust
    # boundaries, so field names, dtypes, shapes, and bounds are all
    # checked before a model is built (a forged blob must not create a
    # corrupt object or a giant allocation).
    _RESTORE_SCHEMAS = {
        "GoldenBloomFilter": {
            "scalars": {"size": (1, 1 << 33), "hash_iterations": (1, 64)},
            "arrays": {"bits": (np.bool_, lambda s: (s["size"],))},
        },
        "GoldenHyperLogLog": {
            "scalars": {},
            "arrays": {"regs": (np.uint8, lambda s: (golden.HLL_M,))},
        },
        "GoldenCountMinSketch": {
            "scalars": {"depth": (1, 64), "width": (1, 1 << 27)},
            "arrays": {
                "counts": (np.uint32, lambda s: (s["depth"], s["width"]))
            },
        },
        "GoldenBitSet": {
            "scalars": {},
            "arrays": {"bits": (np.bool_, None)},  # any 1-D length ≤ cap
        },
    }

    @classmethod
    def decode_dump(cls, data: bytes, name: str):
        """``(kind, params, model, topk state)`` of a host dump, every
        field checked against its class schema (the candidate table too)
        before anything is built."""
        if len(data) < 8 or data[:4] != cls._DUMP_MAGIC:
            raise ValueError("not a host-sketch dump (bad magic)")
        (hlen,) = struct.unpack("<I", data[4:8])
        if hlen > 1 << 16:
            raise ValueError("dump header too large")
        d = json.loads(data[8 : 8 + hlen].decode("utf-8"))
        if d.get("v") != 2:
            raise ValueError(f"unsupported dump version: {d.get('v')}")
        cls_name = d.get("model_cls")
        schema = cls._RESTORE_SCHEMAS.get(cls_name)
        if schema is None:
            raise ValueError(f"unknown model class {cls_name!r}")
        # kind must agree with the model class — a forged blob pairing
        # kind='cms' with a bloom model would create an object whose every
        # later op feeds the wrong model the wrong arguments.
        expected_kind = {
            "GoldenBloomFilter": PoolKind.BLOOM,
            "GoldenHyperLogLog": PoolKind.HLL,
            "GoldenCountMinSketch": PoolKind.CMS,
            "GoldenBitSet": PoolKind.BITSET,
        }[cls_name]
        if d.get("kind") != expected_kind:
            raise ValueError(
                f"dump kind {d.get('kind')!r} does not match {cls_name}"
            )
        if not isinstance(d.get("params"), dict):
            raise ValueError("dump params must be a dict")
        # Untrusted candidate table: validate BEFORE any mutation.
        TopKStore.decode_state(d.get("topk"), name)
        model_cls = getattr(golden, cls_name)
        scalars = d.get("scalars", {})
        if set(scalars) != set(schema["scalars"]):
            raise ValueError(f"dump scalar fields {sorted(scalars)} do not "
                             f"match {cls_name}")
        for k_, (lo, hi) in schema["scalars"].items():
            v_ = int(scalars[k_])
            if not lo <= v_ <= hi:
                raise ValueError(f"dump field {k_}={v_} out of range")
            scalars[k_] = v_
        if list(d.get("arrays", [])) != list(schema["arrays"]):
            raise ValueError(f"dump array fields {d.get('arrays')} do not "
                             f"match {cls_name}")
        model = object.__new__(model_cls)
        for k_, v_ in scalars.items():
            setattr(model, k_, v_)
        buf = io.BytesIO(data[8 + hlen :])
        for k_, (want_dtype, want_shape) in schema["arrays"].items():
            arr = safe_load_npy(buf)
            if arr.dtype != want_dtype:
                raise ValueError(f"dump array {k_} has dtype {arr.dtype}")
            if want_shape is not None and arr.shape != want_shape(scalars):
                raise ValueError(f"dump array {k_} has shape {arr.shape}")
            if want_shape is None and (arr.ndim != 1 or arr.size > 1 << 33):
                raise ValueError(f"dump array {k_} has bad geometry")
            setattr(model, k_, arr.copy())  # writable (frombuffer is RO)
        return d["kind"], d["params"], model, d.get("topk")

    def restore(self, name, data: bytes, replace: bool = False) -> None:
        if data[:4] == DEVICE_DUMP_MAGIC:
            # A card engine's dump: its row becomes the golden model.
            d, row = parse_device_dump(data)
            topk = d.get("topk")
            TopKStore.decode_state(topk, name)
            check_dump_row(d, row)
            kind = d["kind"]
            model = model_from_row(kind, d["params"], row)
            params = {} if kind == PoolKind.BITSET else d["params"]
        else:
            kind, params, model, topk = self.decode_dump(data, name)
        topk_decoded = TopKStore.decode_state(topk, name)
        with self._lock:
            if self._live(name) is not None:
                if not replace:
                    raise ValueError(f"BUSYKEY: {name!r} already exists")
                del self._objects[name]
            self._guard_foreign(name)
            self._objects[name] = {
                "kind": kind,
                "model": model,
                "params": params,
            }
        # Unconditional: replaces (or clears) any previous object's table
        # so a ghost heavy-hitter set never survives a replace.
        self.topk.import_decoded(topk_decoded, name)

    # -- bloom -------------------------------------------------------------

    def bloom_try_init(self, name, expected_insertions, false_probability) -> bool:
        m = golden.optimal_num_of_bits(expected_insertions, false_probability)
        k = golden.optimal_num_of_hash_functions(expected_insertions, m)
        with self._lock:
            if self._lookup_kind(name, PoolKind.BLOOM) is not None:
                return False
            self._guard_foreign(name)
            self._objects[name] = {
                "kind": PoolKind.BLOOM,
                "model": golden.GoldenBloomFilter(m, k),
                "params": {
                    "size": m,
                    "hash_iterations": k,
                    "expected_insertions": expected_insertions,
                    "false_probability": false_probability,
                },
            }
            return True

    def bloom_add(self, name, H1, H2):
        o = self._require(name, PoolKind.BLOOM)
        model: golden.GoldenBloomFilter = o["model"]
        h1m, h2m = hashing.km_reduce_mod(H1, H2, model.size)
        with self._lock:
            return ImmediateResult(model.add_hashed(h1m, h2m))

    def bloom_contains(self, name, H1, H2):
        o = self._require(name, PoolKind.BLOOM)
        model = o["model"]
        h1m, h2m = hashing.km_reduce_mod(H1, H2, model.size)
        with self._lock:
            return ImmediateResult(model.contains_hashed(h1m, h2m))

    def bloom_count(self, name):
        o = self._require(name, PoolKind.BLOOM)
        with self._lock:
            return ImmediateResult(o["model"].cardinality_estimate())

    def bloom_add_encoded(self, name, blocks, lengths):
        return self.bloom_add(name, *hashing.hash128_np(blocks, lengths))

    def bloom_contains_encoded(self, name, blocks, lengths):
        return self.bloom_contains(name, *hashing.hash128_np(blocks, lengths))

    def bloom_mixed_encoded(self, name, blocks, lengths, flags):
        """Ordered add/contains mix on one filter (front-door fused runs):
        consecutive same-flag spans apply in order under one lock hold,
        so results are bit-identical to the sequential command stream."""
        o = self._require(name, PoolKind.BLOOM)
        model = o["model"]
        H1, H2 = hashing.hash128_np(blocks, lengths)
        h1m, h2m = hashing.km_reduce_mod(H1, H2, model.size)
        flags = np.asarray(flags, bool)
        n = len(flags)
        out = np.empty(n, bool)
        with self._lock:
            i = 0
            while i < n:
                j = i + 1
                while j < n and flags[j] == flags[i]:
                    j += 1
                if flags[i]:
                    out[i:j] = model.add_hashed(h1m[i:j], h2m[i:j])
                else:
                    out[i:j] = model.contains_hashed(h1m[i:j], h2m[i:j])
                i = j
        return ImmediateResult(out)

    def bloom_replicate(self, name) -> bool:
        return False  # one host copy; nothing to spread reads across

    def bloom_is_replicated(self, name) -> bool:
        return False

    # -- hll ---------------------------------------------------------------

    def _hll(self, name):
        with self._lock:
            o = self._lookup_kind(name, PoolKind.HLL)
            if o is None:
                self._guard_foreign(name)
                o = {
                    "kind": PoolKind.HLL,
                    "model": golden.GoldenHyperLogLog(),
                    "params": {},
                }
                self._objects[name] = o
            return o

    def hll_add(self, name, c0, c1, c2):
        o = self._hll(name)
        with self._lock:
            model = o["model"]
            before = int(model.regs.sum())
            model.add_hashed(c0, c1, c2)
            return ImmediateResult(int(model.regs.sum()) != before)

    def hll_add_encoded(self, name, blocks, lengths):
        c0, c1, c2, _ = hashing.murmur3_x86_128(blocks, lengths)
        return self.hll_add(name, c0, c1, c2)

    def hll_count(self, name):
        o = self._lookup_kind(name, PoolKind.HLL)
        with self._lock:
            return ImmediateResult(0 if o is None else o["model"].count())

    def hll_count_with(self, name, other_names) -> int:
        with self._lock:
            regs = None
            for n in (name, *other_names):
                o = self._lookup_kind(n, PoolKind.HLL)
                if o is not None:
                    r = o["model"].regs
                    regs = r.copy() if regs is None else np.maximum(regs, r)
            if regs is None:
                return 0
            hist = np.bincount(regs, minlength=golden.HLL_Q + 2)
            return int(round(golden.ertl_estimate(hist)))

    def hll_merge_with(self, name, other_names) -> None:
        o = self._hll(name)
        with self._lock:
            for n in other_names:
                src = self._lookup_kind(n, PoolKind.HLL)
                if src is not None:
                    o["model"].merge(src["model"])

    # -- bitset ------------------------------------------------------------

    def _bitset(self, name):
        with self._lock:
            o = self._lookup_kind(name, PoolKind.BITSET)
            if o is None:
                self._guard_foreign(name)
                o = {
                    "kind": PoolKind.BITSET,
                    "model": golden.GoldenBitSet(),
                    "params": {},
                }
                self._objects[name] = o
            return o

    def bitset_capacity_bits(self, name) -> int:
        with self._lock:
            o = self._lookup_kind(name, PoolKind.BITSET)
            return 0 if o is None else o["model"].bits.size

    def bitset_set(self, name, idx, value: bool):
        o = self._bitset(name)
        with self._lock:
            return ImmediateResult(o["model"].set(np.asarray(idx, np.int64), value))

    def bitset_flip(self, name, idx):
        o = self._bitset(name)
        with self._lock:
            model = o["model"]
            idx = np.asarray(idx, np.int64)
            model._grow(int(idx.max()) + 1 if idx.size else 1)
            prev = np.empty(len(idx), bool)
            for j, ix in enumerate(idx):
                prev[j] = model.bits[ix]
                model.bits[ix] = not model.bits[ix]
            return ImmediateResult(prev)

    def bitset_get(self, name, idx):
        with self._lock:
            o = self._lookup_kind(name, PoolKind.BITSET)
            if o is None:
                return ImmediateResult(np.zeros(len(idx), bool))
            return ImmediateResult(o["model"].get(np.asarray(idx, np.int64)))

    def bitset_set_range(self, name, from_bit, to_bit, value: bool):
        o = self._bitset(name)
        with self._lock:
            model = o["model"]
            model._grow(int(to_bit))
            model.bits[int(from_bit) : int(to_bit)] = value
            return ImmediateResult(None)

    def bitset_cardinality(self, name) -> int:
        with self._lock:
            o = self._lookup_kind(name, PoolKind.BITSET)
            return 0 if o is None else o["model"].cardinality()

    def bitset_length(self, name) -> int:
        with self._lock:
            o = self._lookup_kind(name, PoolKind.BITSET)
            return 0 if o is None else o["model"].length()

    def bitset_bitpos(self, name, target_bit: int) -> int:
        with self._lock:
            o = self._lookup_kind(name, PoolKind.BITSET)
            if o is None:
                return -1 if target_bit else 0
            bits = o["model"].bits
            matches = np.nonzero(bits == bool(target_bit))[0]
            return int(matches[0]) if matches.size else (-1 if target_bit else bits.size)

    def bitset_bitop(self, dest, src_names, op: str) -> None:
        """Redis BITOP: sources are zero-padded to the max source length
        (without mutating them), dest is replaced entirely; NOT complements
        its single source's byte-aligned string (padding bits up to the
        byte boundary flip to 1, as on a real Redis value) — mirrors
        TorchSketchEngine."""
        with self._lock:
            srcs = [self._bitset(n)["model"] for n in src_names]
            if op == "not":
                size = -(-srcs[0].bits.size // 8) * 8
                res = np.ones(size, dtype=bool)
                res[: srcs[0].bits.size] = ~srcs[0].bits
            else:
                size = max((s.bits.size for s in srcs), default=0)

                def padded(b):
                    if b.size == size:
                        return b
                    p = np.zeros(size, dtype=bool)
                    p[: b.size] = b
                    return p

                fn = {"and": np.logical_and, "or": np.logical_or, "xor": np.logical_xor}[op]
                res = padded(srcs[0].bits).copy()
                for s in srcs[1:]:
                    res = fn(res, padded(s.bits))
            d = self._bitset(dest)["model"]
            d.bits = np.array(res, dtype=bool)

    def bitset_to_bytes(self, name) -> bytes:
        with self._lock:
            o = self._lookup_kind(name, PoolKind.BITSET)
            if o is None:
                return b""
            return np.packbits(o["model"].bits, bitorder="little").tobytes()

    # -- cms ---------------------------------------------------------------

    def cms_try_init(self, name, depth, width) -> bool:
        with self._lock:
            if self._lookup_kind(name, PoolKind.CMS) is not None:
                return False
            self._guard_foreign(name)
            self._objects[name] = {
                "kind": PoolKind.CMS,
                "model": golden.GoldenCountMinSketch(depth, width),
                "params": {"depth": depth, "width": width},
            }
            return True

    def cms_total(self, name) -> int:
        o = self._require(name, PoolKind.CMS)
        with self._lock:
            return int(np.asarray(o["model"].counts[0], np.uint64).sum())

    def cms_reset(self, name) -> None:
        o = self._require(name, PoolKind.CMS)
        with self._lock:
            o["model"].counts[:] = 0

    def cms_add(self, name, H1, H2, weights):
        o = self._require(name, PoolKind.CMS)
        model: golden.GoldenCountMinSketch = o["model"]
        h1w, h2w = hashing.km_reduce_mod(H1, H2, model.width)
        with self._lock:
            model.add_hashed(h1w, h2w, weights)
            return ImmediateResult(
                model.estimate_hashed(h1w, h2w).astype(np.uint32)
            )

    def cms_estimate(self, name, H1, H2):
        o = self._require(name, PoolKind.CMS)
        model = o["model"]
        h1w, h2w = hashing.km_reduce_mod(H1, H2, model.width)
        with self._lock:
            return ImmediateResult(model.estimate_hashed(h1w, h2w).astype(np.uint32))

    def cms_add_seq(self, name, H1, H2, weights):
        """Exact-streaming semantics (parity with the card engine's K1 path):
        one-op-at-a-time through the golden model."""
        o = self._require(name, PoolKind.CMS)
        model = o["model"]
        h1w, h2w = hashing.km_reduce_mod(H1, H2, model.width)
        weights = np.asarray(weights, np.uint32)
        with self._lock:
            est = np.zeros(len(h1w), np.uint32)
            for j in range(len(h1w)):
                model.add_hashed(h1w[j : j + 1], h2w[j : j + 1], weights[j : j + 1])
                est[j] = model.estimate_hashed(h1w[j : j + 1], h2w[j : j + 1])[0]
            return ImmediateResult(est)

    def cms_merge(self, name, other_names) -> None:
        o = self._require(name, PoolKind.CMS)
        with self._lock:
            for n in other_names:
                src = self._require(n, PoolKind.CMS)
                if (
                    src["params"]["depth"] != o["params"]["depth"]
                    or src["params"]["width"] != o["params"]["width"]
                ):
                    raise ValueError("cannot merge CMS with different geometry")
                o["model"].merge(src["model"])
