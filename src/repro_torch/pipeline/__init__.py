"""Asynchronous double-buffered execution layer (Section V-A).

Port of ``repro/pipeline/``. Real threads of control replace what the
synchronous path only models (the alpha_crit leak):

  * ``CacheBuilder``   — Stage-2 background rebuild thread: plan_window +
                         bulk feature fetch (+ the device payload table
                         on a CUDA stream of its own), publishing
                         immutable ``PendingBuffer``s; generation-tagged
                         ``swap``.
  * ``PrefetchQueue``  — Stage-3 bounded (depth Q) batch resolver running
                         ahead of the consumer.
  * ``PipelineReport`` — measured rebuild/overlap/prefetch wall times.

``parity`` holds the harness proving the threaded pipeline produces the
exact hit/miss stream and per-owner byte counts of the synchronous path.
"""
from repro_torch.pipeline.cache_builder import (
    BuildTicket,
    CacheBuilder,
    PendingBuffer,
)
from repro_torch.pipeline.parity import ParityReport, check_parity
from repro_torch.pipeline.prefetch import PrefetchItem, PrefetchQueue
from repro_torch.pipeline.report import PipelineReport

__all__ = [
    "BuildTicket",
    "CacheBuilder",
    "PendingBuffer",
    "ParityReport",
    "PrefetchItem",
    "PrefetchQueue",
    "PipelineReport",
    "check_parity",
]
