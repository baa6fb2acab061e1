"""repro_torch.net — deterministic discrete-event congestion fabric.

Models per-owner links (capacity, propagation delay, initiation cost)
behind an optional shared bottleneck with FIFO/processor-sharing queueing,
time-varying background traffic and trace replay, all on the trainer's
virtual clock. Port of ``repro/net`` with the same exports.
"""
from repro_torch.net.background import (
    ArchetypeDelta,
    ConstantDelta,
    ConstantLoad,
    DiurnalLoad,
    IncastLoad,
    MarkovOnOffLoad,
    PaperScheduleDelta,
    StragglerLoad,
    TraceDelta,
)
from repro_torch.net.fabric import (
    Fabric,
    NetClock,
    TransferResult,
    owner_links,
    probe_rpc,
)
from repro_torch.net.scenarios import (
    CLOSED_FORM,
    ScenarioRegistry,
    build_scenario,
    queue_training_code,
    queue_training_pool,
)
from repro_torch.net.trace_replay import DeltaTrace, load_trace

__all__ = [
    "ArchetypeDelta",
    "CLOSED_FORM",
    "ConstantDelta",
    "ConstantLoad",
    "DeltaTrace",
    "DiurnalLoad",
    "Fabric",
    "IncastLoad",
    "MarkovOnOffLoad",
    "NetClock",
    "PaperScheduleDelta",
    "ScenarioRegistry",
    "StragglerLoad",
    "TraceDelta",
    "TransferResult",
    "build_scenario",
    "load_trace",
    "owner_links",
    "probe_rpc",
    "queue_training_code",
    "queue_training_pool",
]
