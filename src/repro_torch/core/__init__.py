"""GreenDyGNN core: cost laws, energy meter, windowed cache, controller."""
from repro_torch.core.cost_model import (  # noqa: F401
    WINDOW_CHOICES,
    CostModelParams,
    congested_miss_latency,
    hit_rate,
    optimal_window,
    rebuild_time,
    rpc_energy_breakdown,
    rpc_time,
    sigma_from_delta,
    step_energy,
    step_time,
)
