"""repro_torch.store — tiered feature store (device / host / remote)."""
from repro_torch.store.budget import MemoryBudget, TierStats  # noqa: F401
from repro_torch.store.device_tier import DevicePayloadTier  # noqa: F401
from repro_torch.store.host_tier import HostTier  # noqa: F401
from repro_torch.store.tiered import (  # noqa: F401
    BlockCharge,
    TieredFeatureStore,
)
