"""Measured pipeline telemetry (replaces the alpha_crit leak approximation).

Port of ``repro/pipeline/report.py``.

``PipelineReport`` condenses what the threads actually measured into the
quantities the paper discusses: how much builder wall time existed, how much
of it leaked onto the critical path (the exposed wait), and how far ahead
the Stage-3 prefetcher ran.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.pipeline.cache_builder import CacheBuilder
from repro_torch.pipeline.prefetch import PrefetchQueue


@dataclasses.dataclass
class PipelineReport:
    n_rebuilds: int = 0
    builder_wall_s: float = 0.0     # total background build time (measured)
    exposed_wait_s: float = 0.0     # part of it the consumer blocked on
    swap_latency_s: float = 0.0     # mean atomic swap cost
    swap_latency_max_s: float = 0.0
    prefetch_batches: int = 0
    prefetch_wait_s: float = 0.0    # total consumer block time in get()
    prefetch_mean_lead_s: float = 0.0
    prefetch_resolve_s: float = 0.0
    prefetch_max_wait_s: float = 0.0
    prefetch_stalls: int = 0        # gets that blocked > 1 ms

    @property
    def hidden_s(self) -> float:
        return max(0.0, self.builder_wall_s - self.exposed_wait_s)

    @property
    def overlap_efficiency(self) -> float:
        """Fraction of builder wall time hidden behind consumer compute."""
        if self.builder_wall_s <= 0:
            return 1.0
        return self.hidden_s / self.builder_wall_s

    @classmethod
    def from_components(
        cls, builder: CacheBuilder | None, prefetch: PrefetchQueue | None
    ) -> "PipelineReport":
        r = cls()
        if builder is not None:
            r.n_rebuilds = builder.n_builds
            r.builder_wall_s = builder.builder_wall_s
            r.exposed_wait_s = builder.exposed_wait_s
            if builder.swap_latency_s:
                lat = np.asarray(builder.swap_latency_s)
                r.swap_latency_s = float(lat.mean())
                r.swap_latency_max_s = float(lat.max())
        if prefetch is not None:
            r.prefetch_batches = prefetch.n_got
            r.prefetch_wait_s = prefetch.wait_s
            r.prefetch_mean_lead_s = prefetch.mean_lead_s
            r.prefetch_resolve_s = prefetch.resolve_s
            r.prefetch_max_wait_s = prefetch.max_wait_s
            r.prefetch_stalls = prefetch.n_stalls
        return r

    def summary(self) -> dict:
        return {
            "n_rebuilds": self.n_rebuilds,
            "builder_wall_s": self.builder_wall_s,
            "exposed_wait_s": self.exposed_wait_s,
            "hidden_s": self.hidden_s,
            "overlap_efficiency": self.overlap_efficiency,
            "swap_latency_mean_s": self.swap_latency_s,
            "swap_latency_max_s": self.swap_latency_max_s,
            "prefetch_batches": self.prefetch_batches,
            "prefetch_wait_s": self.prefetch_wait_s,
            "prefetch_mean_lead_s": self.prefetch_mean_lead_s,
            "prefetch_max_wait_s": self.prefetch_max_wait_s,
            "prefetch_stalls": self.prefetch_stalls,
        }
