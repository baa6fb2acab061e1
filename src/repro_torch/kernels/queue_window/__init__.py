from repro_torch.kernels.queue_window.ops import (  # noqa: F401
    FabricState,
    Volumes,
    queue_window,
    queue_window_plain,
)
