"""Multi-tenant sketch storage: size-class pools + name registry."""

from redisson_tpu_torch.tenancy.registry import (
    PoolKind,
    SizeClassPool,
    TenantEntry,
    TenantRegistry,
)

__all__ = ["PoolKind", "SizeClassPool", "TenantEntry", "TenantRegistry"]
