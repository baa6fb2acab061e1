from repro_torch.kernels.cluster_window.ops import (  # noqa: F401
    Peers,
    PeerState,
    cluster_window,
    cluster_window_plain,
)
