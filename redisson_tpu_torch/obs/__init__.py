"""Observability bundle of the port's engine.

Counterpart of ``redisson_tpu/obs/__init__.py`` for what the port records
so far: the failure-and-overload counters (degraded serving, injected
faults, shedding, deadlines, tenant throttling, fetch timeouts), with the
JAX package's names and labels, in one :class:`MetricsRegistry`.  The
engine registers the health gauges (breaker state, degraded objects,
coalescer queue and windows) on the same registry.
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


def total(family: Family) -> float:
    """Sum of a family's children (every label set)."""
    return sum(c.value for _, c in family.items())


__all__ = ["Family", "MetricsRegistry", "Observability", "total"]
