"""repro_torch.store — tiered feature store (device tier + unlimited host
tier; the budgeted host tier is not ported yet)."""
from repro_torch.store.budget import MemoryBudget, TierStats  # noqa: F401
from repro_torch.store.device_tier import DevicePayloadTier  # noqa: F401
from repro_torch.store.tiered import TieredFeatureStore  # noqa: F401
