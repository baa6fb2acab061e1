from repro_torch.optim.optimizers import (  # noqa: F401
    OptState,
    adam,
    adamw,
    apply_updates,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    sgd,
    warmup_cosine_schedule,
)
