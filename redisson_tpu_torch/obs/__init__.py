"""Observability bundle of the port's engine.

Counterpart of ``redisson_tpu/obs/__init__.py``.  One ``Observability``
per engine/client ties together:

- ``registry`` — labeled counters, gauges and log2 histograms
  (obs/registry.py) rendered as typed Prometheus text;
- ``spans`` — per-launch lifecycle spans feeding the phase histograms
  (obs/spans.py);
- ``calls`` — the encode, admission-wait and submit phases of every
  public data call (obs/spans.py);
- ``launches`` — event-timed device time per executor launch, billed to
  the load map, and each idle gap between launches put down to the host
  phase that held the next (obs/spans.py);
- ``slowlog`` — the SLOWLOG ring (obs/slowlog.py);
- ``trace`` — the head-sampled distributed tracer (obs/trace.py);
- ``latency`` — the LATENCY monitor (obs/latency.py);
- ``events`` — the flight-recorder ring (obs/events.py);
- ``loadmap`` — per-slot, per-key and per-tenant load (obs/loadmap.py).

The families carry the JAX package's names, help text and labels, but
for the three of ``calls`` and ``launches``, which the JAX package does
not have (README.md, "Port-only families and phases").  The
engine registers the health gauges (breaker state, degraded objects,
coalescer queue and windows) and the tier and near-cache occupancy
gauges on the same registry.
"""

from __future__ import annotations

from redisson_tpu_torch.obs.events import EventRing
from redisson_tpu_torch.obs.latency import LatencyMonitor
from redisson_tpu_torch.obs.loadmap import LoadMap
from redisson_tpu_torch.obs.registry import Family, MetricsRegistry
from redisson_tpu_torch.obs.slowlog import SlowLog, SlowLogEntry
from redisson_tpu_torch.obs.spans import (
    CallRecorder,
    LaunchTimer,
    OpSpan,
    SpanRecorder,
)
from redisson_tpu_torch.obs.trace import Tracer


class Observability:
    def __init__(self, slowlog_max_len: int = 128,
                 slowlog_threshold_us: int = 10_000,
                 trace_sample_rate: float = 0.0,
                 trace_max_spans: int = 2048,
                 latency_threshold_ms: int = 0):
        r = MetricsRegistry()
        self.registry = r
        # Telemetry plane: the latency monitor and the tracer's volume
        # counters come first, so the recorders below can ride them.
        self.latency_events = r.counter(
            "rtpu_latency_events",
            "latency-monitor samples recorded, by event "
            "(command | slow-launch | fsync-stall | breaker-open | "
            "migration | reconcile | election | rebalance-wave | "
            "full-resync)", ("event",))
        self.trace_sampled = r.counter(
            "rtpu_trace_sampled",
            "requests head-sampled into a distributed trace")
        self.trace_spans = r.counter(
            "rtpu_trace_spans",
            "trace spans recorded into the bounded per-process ring")
        self.latency = LatencyMonitor(
            latency_threshold_ms, counter=self.latency_events)
        self.trace = Tracer(
            trace_sample_rate, max_spans=trace_max_spans,
            sampled_counter=self.trace_sampled,
            span_counter=self.trace_spans,
        )
        self.spans = SpanRecorder(r, latency=self.latency)
        self.slowlog = SlowLog(slowlog_max_len, slowlog_threshold_us)
        # Engine submit (per-tenant / per-object-type dimensions).
        self.tenant_ops = r.counter(
            "rtpu_tenant_ops", "sketch ops submitted, by tenant and op",
            ("tenant", "op"), max_children=2048)
        self.tenant_calls = r.counter(
            "rtpu_tenant_calls", "sketch API calls, by tenant and kind",
            ("tenant", "kind"), max_children=2048)
        # Executor dispatch, per method (the direct-dispatch path; K1's
        # ``cms_update_estimate_seq`` is one).
        self.dispatches = r.counter(
            "rtpu_dispatches", "executor dispatches, by method", ("method",))
        self.dispatch_ops = r.counter(
            "rtpu_dispatch_ops", "ops dispatched, by executor method",
            ("method",))
        self.dispatch_seconds = r.histogram(
            "rtpu_dispatch_enqueue_seconds",
            "host-side dispatch enqueue time, by method", ("method",))
        # Ops the sharded executor routed to each logical shard.
        self.shard_ops = r.counter(
            "rtpu_shard_ops", "ops routed to each mesh shard", ("shard",))
        # Breaker state itself is a render-time gauge (rtpu_breaker_state,
        # registered by the engine).
        self.degraded_ops = r.counter(
            "rtpu_degraded_ops",
            "ops served from the host golden mirror while a breaker was "
            "open, by op kind", ("op",))
        self.faults_injected = r.counter(
            "rtpu_faults_injected",
            "chaos faults injected, by fault point and kind",
            ("point", "kind"))
        # Pre-dispatch shedding by reason (deadline | admission | tenant),
        # deadline failures by stage (submit | admission | queue | direct
        # | fetch_wait), per-tenant throttles, and fetch timeouts (the
        # kind that feeds the breaker).
        self.shed_ops = r.counter(
            "rtpu_shed_ops",
            "ops shed pre-dispatch by the overload control plane, "
            "by reason", ("reason",))
        self.deadline_exceeded = r.counter(
            "rtpu_deadline_exceeded",
            "ops that failed with DeadlineExceededError, by stage",
            ("stage",))
        self.tenant_throttled = r.counter(
            "rtpu_tenant_throttled",
            "ops shed by per-tenant quotas, by tenant",
            ("tenant",), max_children=2048)
        self.fetch_timeouts = r.counter(
            "rtpu_fetch_timeouts",
            "blocking result waits that hit the fetch timeout, by op",
            ("op",))
        # Near cache: hit/miss by result kind; evictions come from the
        # store's on_evict hook, byte occupancy is a render-time gauge.
        self.nearcache_hits = r.counter(
            "rtpu_nearcache_hits",
            "reads answered from the host near cache, by object kind",
            ("kind",))
        self.nearcache_misses = r.counter(
            "rtpu_nearcache_misses",
            "near-cache probes that went to the device, by object kind",
            ("kind",))
        self.nearcache_evictions = r.counter(
            "rtpu_nearcache_evictions",
            "near-cache entries evicted (quota or budget pressure)")
        # Residency ladder transitions (storage/residency.py); tier
        # occupancy (device rows, host and disk bytes) is a set of
        # render-time gauges the engine registers.
        self.residency_promotions = r.counter(
            "rtpu_residency_promotions",
            "sketches promoted back to a device row (host/disk tier "
            "→ device)")
        self.residency_demotions = r.counter(
            "rtpu_residency_demotions",
            "sketches demoted from a device row to an exact host "
            "golden mirror (demoted is NOT degraded)")
        self.residency_spills = r.counter(
            "rtpu_residency_spills",
            "host mirrors spilled to CRC-framed per-object disk blobs")
        self.residency_loads = r.counter(
            "rtpu_residency_loads",
            "disk blobs loaded back into host mirrors (first touch of "
            "a DISK-resident sketch)")
        # RESP front door, per command: calls, errors, execution time
        # (INFO commandstats / latencystats).
        self.resp_commands = r.counter(
            "rtpu_resp_commands", "RESP commands processed", ("cmd",))
        self.resp_errors = r.counter(
            "rtpu_resp_errors", "RESP commands that returned an error",
            ("cmd",))
        self.resp_latency = r.histogram(
            "rtpu_resp_command_seconds", "RESP command execution time",
            ("cmd",))
        self.slow_client_disconnects = r.counter(
            "rtpu_slow_client_disconnects",
            "connections dropped by the output-buffer limits, by cause",
            ("cause",))
        self.resp_ingress_shed = r.counter(
            "rtpu_resp_ingress_shed",
            "RESP commands (or transactions) refused at ingress, by "
            "reason (pressure = admission watermark, tenant = over-quota "
            "tenant peek, conn_limit = max connections) — "
            "COMMAND-denominated, unlike the ops-denominated "
            "rtpu_shed_ops", ("reason",))
        # Front-door vectorization: pipelined command runs fused into
        # single engine calls, and the response cache for repeated
        # identical reads inside one window.
        self.resp_fused_cmds = r.counter(
            "rtpu_resp_fused_cmds",
            "RESP commands absorbed into fused front-door runs, by family",
            ("family",))
        self.resp_fused_ops = r.counter(
            "rtpu_resp_fused_ops",
            "engine ops carried by fused front-door runs, by family",
            ("family",))
        self.resp_fused_runs = r.counter(
            "rtpu_resp_fused_runs",
            "fused front-door runs dispatched, by family", ("family",))
        self.resp_cache_hits = r.counter(
            "rtpu_resp_response_cache_hits",
            "pipelined replies served from the response cache")
        self.resp_cache_misses = r.counter(
            "rtpu_resp_response_cache_misses",
            "response-cache probes that executed the command")
        # Reactor front door: event-loop ticks, connections ready per
        # tick, and ops that fused into one engine call together with
        # ops from OTHER connections.
        self.reactor_ticks = r.counter(
            "rtpu_reactor_ticks",
            "reactor event-loop ticks that processed at least one event")
        self.reactor_ready_conns = r.counter(
            "rtpu_reactor_ready_conns",
            "connections found ready across reactor ticks (avg per tick "
            "= this / rtpu_reactor_ticks)")
        self.cross_conn_fused_ops = r.counter(
            "rtpu_cross_conn_fused_ops",
            "engine ops fused into a launch together with ops from OTHER "
            "connections, by family", ("family",))
        # Per-core front door: K SO_REUSEPORT server processes per
        # node, an in-node slot->process map, and loopback handoff legs
        # over unix-domain sockets.  Per-worker series federate through
        # obs/federate.py — each worker process serves its own /metrics,
        # the parent's federation endpoint labels them.
        self.frontdoor_processes = r.gauge(
            "rtpu_frontdoor_processes",
            "front-door worker processes sharing this node's listen "
            "port (1 = single-process door, incl. the no-SO_REUSEPORT "
            "fallback)")
        self.frontdoor_worker_index = r.gauge(
            "rtpu_frontdoor_worker_index",
            "this worker's index in the node's in-node slot->process "
            "map (0 in single-process mode)")
        self.frontdoor_handoffs = r.counter(
            "rtpu_frontdoor_handoffs",
            "commands routed across the in-node worker boundary, by "
            "kind (forward = whole command to one sibling, split = "
            "per-key multi-key split, fanout = broadcast-and-merge)",
            ("kind",))
        self.frontdoor_handoff_errors = r.counter(
            "rtpu_frontdoor_handoff_errors",
            "in-node handoff legs that failed (peer gone / corrupt "
            "stream / injected fault) and surfaced -HANDOFFBROKEN",
            ("kind",))
        self.frontdoor_peer_accepts = r.counter(
            "rtpu_frontdoor_peer_accepts",
            "handoff legs accepted from sibling workers on the in-node "
            "unix-domain listener")
        # Cluster mode: redirect volume by kind (the door counts
        # moved/ask/tryagain/crossslot/asking_served as it emits or
        # honors them; the slot-aware client counts client_moved/
        # client_ask as it follows them), slot-ownership handoffs this
        # process finalized, and the scatter/gather client's fan-out
        # (legs / batches = average nodes touched per multi-slot batch).
        self.cluster_redirects = r.counter(
            "rtpu_cluster_redirects",
            "cluster redirects emitted by the door or followed by the "
            "slot-aware client, by kind", ("kind",))
        self.cluster_slot_migrations = r.counter(
            "rtpu_cluster_slot_migrations",
            "slot ownership handoffs finalized on this node (SETSLOT "
            "NODE closing an IMPORTING/MIGRATING state)")
        self.cluster_scatter_fanout = r.counter(
            "rtpu_cluster_scatter_fanout",
            "scatter/gather batches and the per-node pipeline legs they "
            "fanned out to, by unit", ("unit",))
        # Load attribution: device-time split per (tenant, op) — label
        # cardinality is bounded twice (the loadmap folds cold tenants
        # into "other" before the bump, max_children backstops it), and
        # the per-slot planes export as render-time gauges over the
        # top-N busiest slots only.
        self.tenant_device_us = r.counter(
            "rtpu_tenant_device_us",
            "device-side launch microseconds attributed by tenant and "
            "op (top-N tenants, cold ones fold into 'other')",
            ("tenant", "op"), max_children=256)
        self.loadmap = LoadMap()
        self.loadmap.tenant_device_us_family = self.tenant_device_us
        _lm = self.loadmap
        r.gauge_callback(
            "rtpu_loadmap_slot_ops",
            "commands accounted to the busiest slots (top-8 by ops — "
            "bounded export of the 16384-slot load vector)",
            lambda: {(str(s),): float(v) for s, v in _lm.top_slots(8)},
            labelnames=("slot",))
        r.gauge_callback(
            "rtpu_loadmap_sampled_keys",
            "keys sampled into the hot-key sketches at RESP ingress",
            _lm.sampled_keys)
        r.gauge_callback(
            "rtpu_loadmap_tracked_keys",
            "candidate keys currently monitored by the space-saving "
            "top-k",
            _lm.tracked_keys)
        # Flight recorder: the control planes' causal event record
        # (obs/events.py).  Kind cardinality is bounded by events.KINDS.
        self.events_emitted = r.counter(
            "rtpu_events_emitted",
            "flight-recorder events emitted, by kind (bounded by the "
            "events.KINDS catalog)", ("kind",))
        self.events_evicted = r.counter(
            "rtpu_events_evicted",
            "flight-recorder events evicted from the bounded ring "
            "(visible downstream as per-node seq gaps)")
        self.events = EventRing(
            counter=self.events_emitted,
            evicted_counter=self.events_evicted)
        # Durability: the op journal's append volume, group-commit fsync
        # latency, and recovery replay count.  Lag (appended-but-unfsynced
        # records) and live segment count are render-time gauges the
        # engine registers (rtpu_journal_lag_ops / rtpu_journal_segments).
        self.journal_records = r.counter(
            "rtpu_journal_records",
            "op records appended to the durability journal")
        self.journal_bytes = r.counter(
            "rtpu_journal_bytes",
            "bytes appended to the durability journal")
        self.journal_fsync_us = r.histogram(
            "rtpu_journal_fsync_us",
            "journal group-commit fsync latency")
        self.journal_replayed = r.counter(
            "rtpu_journal_replayed",
            "journal records replayed through the golden engine at "
            "recovery")
        # Replication: stream/ack volume counters plus offset/lag gauges
        # read through source callables the RESP door wires (0.0 until
        # then, so the families exist on every process whatever its
        # role).
        self.repl_acks = r.counter(
            "rtpu_repl_acks",
            "REPLCONF ACK frames accepted from replicas (primary side)")
        self.repl_fullresyncs = r.counter(
            "rtpu_repl_fullresyncs",
            "full resynchronizations served (snapshot + stream tail "
            "bootstrap) or performed (replica side)")
        self.repl_partial_resyncs = r.counter(
            "rtpu_repl_partial_resyncs",
            "partial resynchronizations (PSYNC CONTINUE on a matching "
            "replication id + backlog-covered offset)")
        self.repl_stream_records = r.counter(
            "rtpu_repl_stream_records",
            "journal records applied from the replication stream "
            "(replica side)")
        self.failover_elections = r.counter(
            "rtpu_failover_elections",
            "failover elections this node started as a candidate")
        self.failover_takeovers = r.counter(
            "rtpu_failover_takeovers",
            "slot takeovers this node performed after winning an "
            "election (or via manual FAILOVER promotion)")
        # Autonomous rebalancer (cluster/rebalancer.py).  `decisions`
        # kinds: planned (moves a wave scheduled), moved, failed, and
        # the last-moment vetoes skip_busy / skip_stale / skip_failover.
        self.rebalancer_decisions = r.counter(
            "rtpu_rebalancer_decisions",
            "rebalancer planning/execution decisions by kind",
            ("kind",))
        self.rebalancer_keys_moved = r.counter(
            "rtpu_rebalancer_keys_moved",
            "keys migrated by rebalancer-driven slot moves")
        self.rebalancer_migration_seconds = r.histogram(
            "rtpu_rebalancer_migration_seconds",
            "wall seconds per rebalancer-driven slot migration")
        self.rebalancer_imbalance_source = None  # wired by the agent
        r.gauge_callback(
            "rtpu_rebalancer_imbalance_ratio",
            "fleet imbalance (max node load / mean) from the planner's "
            "smoothed heat model; 1.0 = perfectly level",
            lambda: float(self.rebalancer_imbalance_source())
            if self.rebalancer_imbalance_source is not None else 1.0)
        # The continuous protocol auditor (obs/doctor.py).
        self.doctor_sweeps = r.counter(
            "rtpu_doctor_sweeps",
            "invariant-doctor sweeps completed on this node (only the "
            "elected coordinator sweeps)")
        self.doctor_findings = r.counter(
            "rtpu_doctor_findings",
            "invariant findings raised by the doctor, by kind",
            ("kind",))
        self.doctor_canary_rtt_us = r.histogram(
            "rtpu_doctor_canary_rtt_us",
            "black-box canary round trip (WAIT-fenced write-then-read "
            "through the real client path)")
        self.repl_offset_source = None  # wired by the RESP door
        self.repl_lag_source = None
        r.gauge_callback(
            "rtpu_repl_offset",
            "replication offset: journal head seq on a primary, last "
            "applied stream seq on a replica",
            lambda: float(self.repl_offset_source())
            if self.repl_offset_source is not None else 0.0)
        r.gauge_callback(
            "rtpu_repl_lag_ops",
            "replica staleness in journal records (master_offset - "
            "applied; 0 on a primary)",
            lambda: float(self.repl_lag_source())
            if self.repl_lag_source is not None else 0.0)
        # Port-only: the per-call phases, and the device's own time per
        # launch with the idle gaps between launches by cause; the load
        # map's per-tenant device time is the launches' event-timed time.
        self.calls = CallRecorder(r)
        self.launches = LaunchTimer(r)
        self.launches.loadmap = self.loadmap

    def record_resp_command(self, cmd: str, duration_s: float,
                            error: bool) -> None:
        self.resp_commands.inc((cmd,))
        if error:
            self.resp_errors.inc((cmd,))
        self.resp_latency.observe((cmd,), duration_s)

    def record_dispatch(self, method: str, nops: int, dur_s: float) -> None:
        self.dispatches.inc((method,))
        self.dispatch_ops.inc((method,), nops)
        self.dispatch_seconds.observe((method,), dur_s)

    def record_shard_counts(self, counts) -> None:
        """Per-shard op counts of one partitioned dispatch."""
        for s, c in enumerate(counts):
            if c:
                self.shard_ops.inc((str(s),), int(c))

    def reset_op_stats(self) -> None:
        """Zero the span-derived families, the call phases, the launch
        times and idle gaps, and the trace ring (benches call this after
        warmup, so compile-era samples stay out of the warm-path view)."""
        self.spans.reset()
        self.calls.reset()
        self.launches.reset()
        self.trace.reset()

    def reset_command_stats(self) -> None:
        """CONFIG RESETSTAT: zero the RESP per-command families."""
        self.resp_commands.reset()
        self.resp_errors.reset()
        self.resp_latency.reset()

    def command_stats(self) -> dict:
        """{cmd: {calls, errors, usec, usec_per_call}} for INFO
        commandstats and client.get_metrics()."""
        out = {}
        errs = {lv: c.value for lv, c in self.resp_errors.items()}
        lat = dict(self.resp_latency.items())
        for (cmd,), c in self.resp_commands.items():
            calls = int(c.value)
            h = lat.get((cmd,))
            usec = int((h.sum if h is not None else 0.0) * 1e6)
            out[cmd] = {
                "calls": calls,
                "errors": int(errs.get((cmd,), 0)),
                "usec": usec,
                "usec_per_call": round(usec / calls, 2) if calls else 0.0,
            }
        return out

    def latency_stats(self) -> dict:
        """{cmd: {p50_us, p99_us, p999_us}} for INFO latencystats."""
        out = {}
        for (cmd,), c in self.resp_latency.items():
            if c.count == 0:
                continue
            p50, p99, p999 = self.resp_latency.percentiles(
                (cmd,), (50, 99, 99.9))
            out[cmd] = {
                "p50_us": p50 * 1e6,
                "p99_us": p99 * 1e6,
                "p999_us": p999 * 1e6,
            }
        return out


    def op_stats(self) -> dict:
        """{op: {ops, launches, p50_ms, p99_ms}} from the span
        histograms — the per-command latency view of the engine."""
        out = {}
        ops = {lv: c.value for lv, c in self.spans._ops.items()}
        for (op,), c in self.spans._total_hist.items():
            if c.count == 0:
                continue
            p50, p99 = self.spans._total_hist.percentiles((op,), (50, 99))
            out[op] = {
                "ops": int(ops.get((op,), 0)),
                "launches": int(c.count),
                "p50_ms": p50 * 1e3,
                "p99_ms": p99 * 1e3,
            }
        return out

    def phase_stats(self) -> dict:
        """{op: {phase: {launches, p50_ms, p99_ms}}} from the lifecycle
        phase histograms (coalesce_wait / host_stage / slot_wait /
        enqueue / d2h_fetch: host intervals, not device time)."""
        out: dict = {}
        h = self.spans._phase_hist
        for (op, phase), c in h.items():
            if c.count == 0:
                continue
            p50, p99 = h.percentiles((op, phase), (50, 99))
            out.setdefault(op, {})[phase] = {
                "launches": int(c.count),
                "p50_ms": round(p50 * 1e3, 3),
                "p99_ms": round(p99 * 1e3, 3),
            }
        return out

    def tenant_stats(self) -> dict:
        """{tenant: ops} aggregated over op types."""
        out: dict = {}
        for (tenant, _op), c in self.tenant_ops.items():
            out[tenant] = out.get(tenant, 0) + int(c.value)
        return out


def total(family: Family) -> float:
    """Sum of a family's children (every label set)."""
    return sum(c.value for _, c in family.items())


__all__ = [
    "EventRing",
    "Family",
    "LatencyMonitor",
    "LoadMap",
    "MetricsRegistry",
    "Observability",
    "OpSpan",
    "SlowLog",
    "SlowLogEntry",
    "SpanRecorder",
    "Tracer",
    "total",
]
