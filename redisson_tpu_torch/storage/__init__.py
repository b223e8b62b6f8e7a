"""Tiered sketch storage of the port (counterpart of
``redisson_tpu/storage``): the heat-based residency ladder.

Device rows become a CACHE over host golden mirrors over per-object
disk blobs — the addressable tenant population is bounded by host+disk,
not device memory.  ``heat.py`` tracks decayed access heat per object;
``residency.py`` drives demotion/promotion/spill/load against a
device-rows budget.
"""

from redisson_tpu_torch.storage.heat import HeatTracker
from redisson_tpu_torch.storage.residency import (
    DEVICE,
    DISK,
    HOST,
    ROW_NONE,
    ResidencyError,
    ResidencyManager,
)

__all__ = [
    "HeatTracker",
    "ResidencyManager",
    "ResidencyError",
    "DEVICE",
    "HOST",
    "DISK",
    "ROW_NONE",
]
