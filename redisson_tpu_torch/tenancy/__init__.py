"""Multi-tenant sketch storage: size-class pools, the name registry and
the per-tenant load governor."""

from redisson_tpu_torch.tenancy.registry import (
    PoolKind,
    SizeClassPool,
    TenantEntry,
    TenantGovernor,
    TenantRegistry,
)

__all__ = ["PoolKind", "SizeClassPool", "TenantEntry", "TenantGovernor",
           "TenantRegistry"]
