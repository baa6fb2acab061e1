"""Owner-sharded distributed feature store (DistTensor stand-in).

Features are partitioned by node owner. A worker resolves a batch's input
features from three sources, in priority order:
  1. local partition   (owner == self, free),
  2. hot cache         (GreenDyGNN double-buffered buffer, free),
  3. remote fetch      (batched per-owner RPC — the energy hot path).

``resolve`` returns the gathered features *and* the accounting record
(per-owner miss counts and bytes) that drives the calibrated time/energy
model and the RL state.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.windowed_cache import CacheStats, DoubleBufferedCache


@dataclasses.dataclass
class FetchRecord:
    n_local: int
    n_cache_hit: int
    per_owner_miss: np.ndarray   # (P,) rows fetched remotely, indexed by owner
    bytes_fetched: float
    n_rpcs: int


class ShardedFeatureStore:
    """Host-side feature store; ``self_rank`` marks the local partition.

    ``remote_owner_index`` maps a global owner id to its index in the
    "remote owners" coordinate system (0..P-2) used by the controller.
    """

    def __init__(
        self,
        features: np.ndarray,
        owner_of: np.ndarray,
        self_rank: int,
        n_parts: int,
    ):
        self.features = features
        self.owner_of = np.asarray(owner_of)
        self.self_rank = int(self_rank)
        self.n_parts = int(n_parts)
        self.bytes_per_row = float(features.shape[1] * features.dtype.itemsize)
        remote = [p for p in range(n_parts) if p != self_rank]
        self.remote_owners = np.asarray(remote)
        self.remote_index_of = {int(p): i for i, p in enumerate(remote)}

    def peek_rows(self, node_ids: np.ndarray) -> np.ndarray:
        """Pure row gather (no side effects; overridden by the tiered
        store to serve chunked / out-of-core sources)."""
        return self.features[np.asarray(node_ids, np.int64).ravel()]

    def remote_ids_of(self, node_ids: np.ndarray) -> np.ndarray:
        node_ids = np.asarray(node_ids).ravel()
        return node_ids[self.owner_of[node_ids] != self.self_rank]

    def owner_index(self, node_ids: np.ndarray) -> np.ndarray:
        """Remote-owner coordinate (0..P-2) per node (local nodes -> -1)."""
        owners = self.owner_of[np.asarray(node_ids).ravel()]
        out = np.full(len(owners), -1, np.int64)
        for p, i in self.remote_index_of.items():
            out[owners == p] = i
        return out

    def resolve(
        self,
        node_ids: np.ndarray,
        cache: DoubleBufferedCache | None,
        stats: CacheStats | None,
    ) -> tuple[np.ndarray, FetchRecord]:
        """Gather features for ``node_ids``; account hit/miss traffic."""
        node_ids = np.asarray(node_ids).ravel()
        feats = self.peek_rows(node_ids)  # payload (simulated network below)

        owners = self.owner_of[node_ids]
        local_mask = owners == self.self_rank
        remote_ids = node_ids[~local_mask]
        remote_owners = owners[~local_mask]

        if cache is not None:
            hit_mask, _ = cache.lookup(remote_ids)
            if stats is not None:
                cache.access(remote_ids, stats)
        else:
            hit_mask = np.zeros(len(remote_ids), bool)
            if stats is not None:
                n_owners = self.n_parts - 1
                stats.misses += len(remote_ids)
                stats.n_owners = n_owners
                if stats.per_owner_hits is None:
                    stats.per_owner_hits = np.zeros(n_owners)
                    stats.per_owner_total = np.zeros(n_owners)
                if len(remote_ids):
                    ridx = self.owner_index(remote_ids)
                    stats.per_owner_total += np.bincount(
                        ridx, minlength=n_owners
                    )

        miss_owners = remote_owners[~hit_mask]
        per_owner = np.zeros(self.n_parts, np.int64)
        if len(miss_owners):
            per_owner += np.bincount(miss_owners, minlength=self.n_parts)
        n_miss = int((~hit_mask).sum())
        record = FetchRecord(
            n_local=int(local_mask.sum()),
            n_cache_hit=int(hit_mask.sum()),
            per_owner_miss=per_owner,
            bytes_fetched=n_miss * self.bytes_per_row,
            n_rpcs=int((per_owner > 0).sum()),
        )
        return feats, record

    def bulk_fetch_cost(self, per_owner_rows: np.ndarray) -> tuple[int, float]:
        """(n_rpcs, bytes) for a bulk cache-rebuild fetch."""
        n_rpcs = int((np.asarray(per_owner_rows) > 0).sum())
        total = float(np.sum(per_owner_rows) * self.bytes_per_row)
        return n_rpcs, total
