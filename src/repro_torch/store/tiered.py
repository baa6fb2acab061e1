"""Three-tier feature store: device hot buffer / host tier / remote owner.

Port of ``repro/store/tiered.py`` for the unlimited host budget only:
every block is implicitly resident and uncharged, so the store is
bit-identical to the monolithic ``ShardedFeatureStore`` plus the per-tier
counters. The DEVICE tier (``DevicePayloadTier``, wired by the worker)
holds real capacity-bounded payload rows served through the
``embedding_bag`` gather kernel.

A budgeted HOST tier (``MemoryBudget.host_bytes`` set) needs
``store/host_tier.py``, which is not ported yet: such a budget raises
``NotImplementedError``. Out-of-core mode (``source``, a
``graph.datasets.StreamingFeatures``) regenerates rows on demand through
the pure ``peek_rows``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.features import ShardedFeatureStore
from repro_torch.store.budget import MemoryBudget, TierStats


class TieredFeatureStore(ShardedFeatureStore):
    """Tiered store over an unlimited host tier (legacy-identical)."""

    def __init__(
        self,
        features: np.ndarray | None,
        owner_of: np.ndarray,
        self_rank: int,
        n_parts: int,
        budget: MemoryBudget | None = None,
        source=None,
    ):
        if features is not None:
            super().__init__(features, owner_of, self_rank, n_parts)
        else:
            if source is None:
                raise ValueError(
                    "TieredFeatureStore needs features or a chunked source"
                )
            self.features = None
            self.owner_of = np.asarray(owner_of)
            self.self_rank = int(self_rank)
            self.n_parts = int(n_parts)
            self.bytes_per_row = float(source.bytes_per_row)
            remote = [p for p in range(n_parts) if p != self_rank]
            self.remote_owners = np.asarray(remote)
            self.remote_index_of = {int(p): i for i, p in enumerate(remote)}
        self.source = source
        self.budget = budget if budget is not None else MemoryBudget()
        if self.budget.host_bytes is not None:
            raise NotImplementedError(
                "a budgeted host tier needs store/host_tier.py, which is "
                "not ported yet (ROADMAP queue 1: host tier)"
            )
        self.tier_stats = TierStats()

    def peek_rows(self, node_ids: np.ndarray) -> np.ndarray:
        """Pure row gather: no residency mutation, safe off-thread."""
        node_ids = np.asarray(node_ids, np.int64).ravel()
        if self.features is not None:
            return self.features[node_ids]
        return self.source.rows(node_ids)
