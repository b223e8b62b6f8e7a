"""Observability bundle of the port's engine.

Counterpart of ``redisson_tpu/obs/__init__.py`` for what the port records
so far: the failure-and-overload counters (degraded serving, injected
faults, shedding, deadlines, tenant throttling, fetch timeouts), the near
cache's hits, misses and evictions, and the residency ladder's
transitions, with the JAX package's names and labels, in one
:class:`MetricsRegistry`.  The engine registers the health gauges
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


def total(family: Family) -> float:
    """Sum of a family's children (every label set)."""
    return sum(c.value for _, c in family.items())


__all__ = ["Family", "MetricsRegistry", "Observability", "total"]
