from repro_torch.optim.optimizers import (  # noqa: F401
    OptState,
    adam,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
)
