"""Observability bundle of the port's engine.

Counterpart of ``redisson_tpu/obs/__init__.py`` for what the port records
so far: the failure-and-overload counters (degraded serving, injected
faults, shedding, deadlines, tenant throttling, fetch timeouts), the near
cache's hits, misses and evictions, the residency ladder's transitions,
and the RESP front door's families (per-command calls, errors and
latency; ingress sheds; fused runs and the response cache; reactor ticks
and cross-connection fusion; slow-client disconnects), with the JAX
package's names and labels, in one :class:`MetricsRegistry`.  The engine registers the health gauges
(breaker state, degraded objects, coalescer queue and windows) and the
tier and near-cache occupancy gauges on the same registry.
"""

from __future__ import annotations

from redisson_tpu_torch.obs.registry import Family, MetricsRegistry


class Observability:
    def __init__(self):
        r = MetricsRegistry()
        self.registry = r
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
        self.failover_takeovers = r.counter(
            "rtpu_failover_takeovers",
            "promotions of this node to primary (manual FAILOVER)")
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

    def record_resp_command(self, cmd: str, duration_s: float,
                            error: bool) -> None:
        self.resp_commands.inc((cmd,))
        if error:
            self.resp_errors.inc((cmd,))
        self.resp_latency.observe((cmd,), duration_s)

    def reset_command_stats(self) -> None:
        """CONFIG RESETSTAT: zero the RESP per-command families."""
        self.resp_commands.reset()
        self.resp_errors.reset()
        self.resp_latency.reset()

    def command_stats(self) -> dict:
        """{cmd: {calls, errors, usec, usec_per_call}} for INFO
        commandstats."""
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


def total(family: Family) -> float:
    """Sum of a family's children (every label set)."""
    return sum(c.value for _, c in family.items())


__all__ = ["Family", "MetricsRegistry", "Observability", "total"]
