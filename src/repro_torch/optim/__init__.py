from repro_torch.optim.optimizers import (  # noqa: F401
    OptState,
    adamw,
    apply_updates,
)
