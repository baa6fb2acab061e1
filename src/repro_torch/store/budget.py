"""Memory budget + per-tier accounting for the tiered feature store.

``MemoryBudget`` is the single knob the trainer plumbs down (``RunConfig
.mem_budget`` -> ``worker.build_store``): how many bytes of feature rows the
host tier may keep resident, how rows are chunked into blocks, and how much
a locally-owned block materialization costs relative to the wire. A ``None``
``host_bytes`` means *unlimited* — the store then behaves bit-for-bit like
the legacy monolithic in-RAM ``ShardedFeatureStore`` (no block traffic, no
eviction, no extra fabric calls).

``TierStats`` is the deterministic per-tier counter block the acceptance
harness compares across same-seed runs (device hits / host hits / block
fetches / evictions / peak residency); the cluster merges the ranks'
counters with ``merge_tier_counts``. Port of ``repro/store/budget.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class MemoryBudget:
    """Host-tier byte budget for one rank's feature working set.

    host_bytes        byte budget for resident host-tier blocks; ``None``
                      disables the tier entirely (legacy in-RAM behavior).
    chunk_rows        feature rows per host-tier block (eviction granule).
    host_read_factor  cost of materializing a *locally-owned* block from
                      host storage, as a fraction of the calibrated wire
                      byte cost (``params.beta``); remote-owned blocks go
                      over the fabric owner link instead.
    device_payloads   device tier holds real payload rows and serves the
                      hit path through the ``embedding_bag`` gather kernel.
    """

    host_bytes: float | None = None
    chunk_rows: int = 2048
    host_read_factor: float = 0.25
    device_payloads: bool = True

    @property
    def unlimited(self) -> bool:
        return self.host_bytes is None

    def budget_blocks(self, bytes_per_row: float) -> int | None:
        """Block-count budget for a given row width (floor, min 1)."""
        if self.host_bytes is None:
            return None
        block_bytes = max(self.chunk_rows * bytes_per_row, 1.0)
        return max(int(self.host_bytes // block_bytes), 1)


@dataclasses.dataclass
class TierStats:
    """Cumulative per-tier traffic counters (all deterministic)."""

    device_hits: int = 0          # rows served from the device hot buffer
    host_hits: int = 0            # rows staged from already-resident blocks
    host_misses: int = 0          # rows whose block had to be materialized
    block_fetches: int = 0        # blocks materialized (remote + local)
    remote_block_rows: int = 0    # block rows pulled over owner links
    local_block_rows: int = 0     # block rows read from local host storage
    evictions: int = 0            # blocks evicted by the CLOCK hand
    peak_resident_bytes: float = 0.0
    pinned_over_budget: int = 0   # times pins alone exceeded the budget

    def counts(self) -> dict:
        """Plain-int dict (stable key order) for digests and reports."""
        return {
            "device_hits": int(self.device_hits),
            "host_hits": int(self.host_hits),
            "host_misses": int(self.host_misses),
            "block_fetches": int(self.block_fetches),
            "remote_block_rows": int(self.remote_block_rows),
            "local_block_rows": int(self.local_block_rows),
            "evictions": int(self.evictions),
            "peak_resident_bytes": float(self.peak_resident_bytes),
            "pinned_over_budget": int(self.pinned_over_budget),
        }

    @staticmethod
    def merge(stats: list["TierStats | None"]) -> dict | None:
        """Element-wise sum of counters (max for the peak) across workers,
        through :func:`merge_tier_counts`."""
        return merge_tier_counts(
            [s.counts() for s in stats if s is not None]
        )


def merge_tier_counts(counts: list) -> dict | None:
    """Merge per-worker ``TierStats.counts()`` dicts into cluster totals
    (sum, except the resident peak which takes the max: budgets are
    per-rank, so the cluster-wide figure is the worst rank), through the
    shared reduce law :func:`repro_torch.obs.reduce.merge_counters`."""
    from repro_torch.obs.reduce import merge_counters

    out = merge_counters(counts, max_keys=("peak_resident_bytes",))
    if out is None:
        return None
    return {
        k: (float(v) if k == "peak_resident_bytes" else int(v))
        for k, v in out.items()
    }


def tier_counts_array(counts: dict) -> np.ndarray:
    """Fixed-order float64 vector of a ``TierStats.counts()`` dict (digest
    input; keys in sorted order)."""
    return np.asarray([counts[k] for k in sorted(counts)], np.float64)
