"""Host tier: block residency under a byte budget with window-aware CLOCK.

Port of ``repro/store/host_tier.py`` (numpy, copied).

The host tier tracks WHICH fixed-size row blocks of this rank's feature
working set are resident in host memory. Residency mechanics only — feature
payload bytes live with the caller (``TieredFeatureStore`` materializes or
regenerates rows); what matters for the energy model is the deterministic
stream of block fetches and evictions the access pattern induces.

Eviction is second-chance CLOCK over the fixed block order: a hand sweeps
block ids, clearing reference bits, and evicts the first unreferenced,
unpinned block. The policy is a pure function of the touch sequence, so
same-seed runs produce identical fetch/eviction streams.

Window-aware pinning (the RapidGNN-flavored rule): blocks referenced by the
pending ``RebuildPlan`` are pinned until the next plan replaces them, so an
intra-epoch rebuild can never thrash its own prefetch — the CLOCK hand
skips pinned blocks even when that leaves the tier over budget (recorded in
``pinned_over_budget``).
"""
from __future__ import annotations

import numpy as np


class HostTier:
    """Budgeted block-residency table with deterministic CLOCK eviction."""

    def __init__(self, n_rows: int, chunk_rows: int,
                 budget_blocks: int | None):
        self.n_rows = int(n_rows)
        self.chunk_rows = int(chunk_rows)
        self.n_blocks = -(-self.n_rows // self.chunk_rows)  # ceil
        self.budget_blocks = (
            None if budget_blocks is None else int(budget_blocks)
        )
        self.resident = np.zeros(self.n_blocks, bool)
        self.ref = np.zeros(self.n_blocks, bool)
        self.pinned = np.zeros(self.n_blocks, bool)
        self.hand = 0
        self.n_resident = 0
        self.evictions = 0
        self.peak_resident = 0
        self.pinned_over_budget = 0

    # ------------------------------------------------------------- residency
    def block_of(self, node_ids: np.ndarray) -> np.ndarray:
        return np.asarray(node_ids, np.int64) // self.chunk_rows

    def touch(self, node_ids: np.ndarray) -> np.ndarray:
        """Reference the blocks covering ``node_ids``; admit absent ones.

        Returns the sorted block ids that had to be materialized (the
        caller charges their transfer/read cost). Reference bits are set on
        every touched block; eviction happens inside admission when the
        budget is exceeded.
        """
        blocks = np.unique(self.block_of(node_ids))
        if not len(blocks):
            return blocks
        fetched = blocks[~self.resident[blocks]]
        for b in fetched:
            self._admit(int(b))
        self.ref[blocks] = True
        return fetched

    def is_resident(self, block_ids: np.ndarray) -> np.ndarray:
        return self.resident[np.asarray(block_ids, np.int64)]

    def pin(self, node_ids: np.ndarray) -> None:
        """Replace the pin set with the blocks covering ``node_ids``.

        Pinned blocks are skipped by the CLOCK hand. Pinning does not force
        residency — the rebuild's own bulk fetch touches the blocks — but a
        pin set larger than the budget is recorded (the plan itself cannot
        fit, so the tier will run over budget until the next boundary).
        """
        self.pinned[:] = False
        blocks = np.unique(self.block_of(node_ids))
        if len(blocks):
            self.pinned[blocks] = True
        if (
            self.budget_blocks is not None
            and int(len(blocks)) > self.budget_blocks
        ):
            self.pinned_over_budget += 1

    # ------------------------------------------------------------- internals
    def _admit(self, b: int) -> None:
        if self.budget_blocks is not None:
            while self.n_resident >= self.budget_blocks:
                if not self._evict_one():
                    break
        self.resident[b] = True
        self.n_resident += 1
        self.peak_resident = max(self.peak_resident, self.n_resident)

    def _evict_one(self) -> bool:
        """Advance the CLOCK hand to one victim; False if none exists
        (everything resident is pinned)."""
        for _ in range(2 * self.n_blocks):
            b = self.hand
            self.hand = (self.hand + 1) % self.n_blocks
            if not self.resident[b] or self.pinned[b]:
                continue
            if self.ref[b]:
                self.ref[b] = False
                continue
            self.resident[b] = False
            self.n_resident -= 1
            self.evictions += 1
            return True
        return False
