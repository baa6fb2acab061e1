"""Double-buffered windowed feature cache (paper Section V-A, Stage 2).

Host-side cache *management* (hot-set planning, buffer bookkeeping, hit/miss
accounting) lives here; the feature *payloads* are JAX arrays gathered by the
trainer. This mirrors the paper's split: a CPU cache-builder thread plans and
fetches, the GPU reads an immutable active buffer.

Planning contract (paper: "examines the next W batches in the shared buffer,
counts per-remote-node access frequencies weighted by the RL agent's
per-owner cost weights, selects the top-k hot nodes"):

    plan = cache.plan_window(next_batches, weights)
    ... overlap: trainer keeps using the active buffer ...
    cache.swap(plan)         # atomic at the window boundary

Hits are O(1) lookups through a node_id -> slot table.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RebuildPlan:
    hot_nodes: np.ndarray          # (n_hot,) global node ids, owner-sorted
    owners: np.ndarray             # (n_hot,) owner of each hot node
    fetched: np.ndarray            # bool mask: True = must fetch remotely
    persisted: np.ndarray          # bool mask: True = copied from active buffer
    per_owner_quota: np.ndarray    # (n_owners,) capacity split actually used
    per_owner_fetched: np.ndarray  # (n_owners,) newly fetched rows per owner
    built_from_generation: int = -1  # cache generation the plan was diffed
                                     # against (pipeline staleness check)


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    n_owners: int = 0
    per_owner_hits: np.ndarray | None = None
    per_owner_total: np.ndarray | None = None

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def per_owner_hit_rates(self) -> np.ndarray:
        if self.per_owner_total is None:
            return np.zeros(self.n_owners)
        t = np.maximum(self.per_owner_total, 1)
        return self.per_owner_hits / t


def _largest_remainder(weights: np.ndarray, total: int) -> np.ndarray:
    """Integer split of ``total`` proportional to ``weights`` that sums to
    exactly ``total`` (floor + distribute leftovers by fractional part)."""
    raw = weights * total
    quota = np.floor(raw).astype(np.int64)
    short = int(total - quota.sum())
    if short > 0:
        order = np.argsort(-(raw - quota))
        quota[order[:short]] += 1
    return quota


class DoubleBufferedCache:
    """Active/pending hot-node cache with per-owner capacity allocation."""

    def __init__(self, capacity: int, owner_of: np.ndarray, n_owners: int):
        self.capacity = int(capacity)
        self.owner_of = np.asarray(owner_of)
        self.n_owners = int(n_owners)
        self.active_nodes = np.empty((0,), np.int64)
        self._slot_of: dict[int, int] = {}
        self.generation = 0

    # ------------------------------------------------------------------ plan
    def plan_window(
        self, window_batches: list[np.ndarray], weights: np.ndarray
    ) -> RebuildPlan:
        """Select the hot remote set for the next window.

        window_batches: per-batch arrays of *remote* node ids needed.
        weights: (n_owners,) RL cost weights -> per-owner capacity quota.
        """
        weights = np.asarray(weights, np.float64)
        weights = weights / max(weights.sum(), 1e-9)

        if window_batches:
            all_ids = np.concatenate([np.asarray(b).ravel() for b in window_batches])
        else:
            all_ids = np.empty((0,), np.int64)
        ids, counts = np.unique(all_ids, return_counts=True)
        owners = self.owner_of[ids] if len(ids) else np.empty((0,), np.int64)
        avail = np.bincount(owners, minlength=self.n_owners).astype(np.int64)

        # Largest-remainder split (no floor()-stranded slots), then
        # redistribute capacity an owner cannot fill to owners that can,
        # so full utilization is reached whenever enough candidates exist.
        quota = _largest_remainder(weights, self.capacity)
        take = np.minimum(quota, avail)
        leftover = int(self.capacity - take.sum())
        while leftover > 0:
            spare = avail - take
            open_mask = spare > 0
            if not open_mask.any():
                break
            w_open = np.where(open_mask, np.maximum(weights, 1e-12), 0.0)
            add = _largest_remainder(w_open / w_open.sum(), leftover)
            add = np.minimum(add, spare)
            if add.sum() == 0:  # defensive (largest-remainder only lands on
                add = np.zeros_like(take)   # open owners, so not reachable)
                add[np.flatnonzero(open_mask)[:leftover]] = 1
            take += add
            leftover -= int(add.sum())
        quota = take

        hot_parts: list[np.ndarray] = []
        for o in range(self.n_owners):
            mask = owners == o
            ids_o, counts_o = ids[mask], counts[mask]
            k = min(int(quota[o]), len(ids_o))
            if k > 0:
                top = np.argpartition(counts_o, -k)[-k:]
                hot_parts.append(ids_o[top])
        hot = (
            np.sort(np.concatenate(hot_parts))
            if hot_parts
            else np.empty((0,), np.int64)
        )
        assert len(hot) <= self.capacity, (
            f"plan overflows capacity: {len(hot)} > {self.capacity}"
        )
        hot_owner = self.owner_of[hot] if len(hot) else np.empty((0,), np.int64)
        persisted = np.isin(hot, self.active_nodes, assume_unique=False)
        fetched = ~persisted
        per_owner_fetched = np.bincount(
            hot_owner[fetched], minlength=self.n_owners
        ).astype(np.int64) if len(hot) else np.zeros(self.n_owners, np.int64)
        return RebuildPlan(
            hot_nodes=hot,
            owners=hot_owner,
            fetched=fetched,
            persisted=persisted,
            per_owner_quota=quota,
            per_owner_fetched=per_owner_fetched,
            built_from_generation=self.generation,
        )

    # ------------------------------------------------------------------ swap
    def swap(self, plan: RebuildPlan) -> None:
        """Atomically promote the pending buffer (window boundary)."""
        self.active_nodes = plan.hot_nodes
        self._slot_of = {int(n): i for i, n in enumerate(plan.hot_nodes)}
        self.generation += 1

    # ------------------------------------------------------------------ read
    def lookup(self, remote_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Return (hit_mask, slots). slots[i] valid only where hit_mask[i]."""
        remote_ids = np.asarray(remote_ids).ravel()
        if len(self.active_nodes) == 0:
            return np.zeros(len(remote_ids), bool), np.zeros(len(remote_ids), np.int64)
        pos = np.searchsorted(self.active_nodes, remote_ids)
        pos = np.clip(pos, 0, len(self.active_nodes) - 1)
        hit = self.active_nodes[pos] == remote_ids
        return hit, pos

    def access(self, remote_ids: np.ndarray, *stat_sinks: CacheStats) -> np.ndarray:
        """Record hits/misses for one batch into every sink (ONE lookup —
        epoch- and window-scoped stats share the same searchsorted probe);
        returns the miss ids."""
        remote_ids = np.asarray(remote_ids).ravel()
        hit, _ = self.lookup(remote_ids)
        n_hit, n_miss = int(hit.sum()), int((~hit).sum())
        owners = self.owner_of[remote_ids]
        hit_counts = np.bincount(owners[hit], minlength=self.n_owners)
        total_counts = np.bincount(owners, minlength=self.n_owners)
        for stats in stat_sinks:
            stats.hits += n_hit
            stats.misses += n_miss
            stats.n_owners = self.n_owners
            if stats.per_owner_hits is None:
                stats.per_owner_hits = np.zeros(self.n_owners)
                stats.per_owner_total = np.zeros(self.n_owners)
            stats.per_owner_hits += hit_counts
            stats.per_owner_total += total_counts
        return remote_ids[~hit]
