"""Three-tier feature store: device hot buffer / host tier / remote owner.

Port of ``repro/store/tiered.py``, behind the monolithic
``ShardedFeatureStore``'s interface, with two more axes:

  * a HOST tier (``HostTier``): the rank's feature working set is chunked
    into fixed-size blocks that are materialized lazily under a byte
    budget with window-aware CLOCK eviction. Touching an absent block
    charges a block fetch: remote-owned rows go over the owner link on the
    network substrate (so memory pressure turns into the congestion the
    policies already reason about), locally-owned rows cost a host storage
    read (``MemoryBudget.host_read_factor``).
  * a DEVICE tier (``DevicePayloadTier``, wired by the worker): the hot
    cache's real payload rows on the card, the hit path served through the
    ``embedding_bag`` kernel.

With ``MemoryBudget.host_bytes=None`` (or no budget) every block is
implicitly resident and uncharged: ``touch`` returns ``None`` and the
store is bit-identical to the monolithic one.

Out-of-core mode: pass ``source`` (a ``graph.datasets.StreamingFeatures``)
instead of a features matrix; rows are a pure function of ``(seed,
block)`` and are regenerated on demand by the pure ``peek_rows``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.features import ShardedFeatureStore
from repro_torch.store.budget import MemoryBudget, TierStats
from repro_torch.store.host_tier import HostTier


@dataclasses.dataclass(frozen=True)
class BlockCharge:
    """Traffic induced by one residency update (``touch``)."""

    per_owner_rows: np.ndarray   # (P-1,) remote-coord block rows to fetch
    local_rows: int              # locally-owned block rows (host read)
    n_blocks: int                # blocks materialized

    @property
    def empty(self) -> bool:
        return self.n_blocks == 0


class TieredFeatureStore(ShardedFeatureStore):
    """Budgeted tiered store; identical to the monolithic store when the
    budget is unlimited."""

    def __init__(
        self,
        features: np.ndarray | None,
        owner_of: np.ndarray,
        self_rank: int,
        n_parts: int,
        budget: MemoryBudget | None = None,
        source=None,
        layout: np.ndarray | None = None,
    ):
        """``layout`` is the storage order: position ``p`` of the chunked
        host file holds row ``layout[p]`` (partition- and
        locality-contiguous, so one window's working set lands in few
        blocks); ``None`` is the identity."""
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
        self.n_rows = int(len(self.owner_of))
        self.tier_stats = TierStats()
        # storage order (position -> node id) and its inverse
        self.order = (
            np.asarray(layout, np.int64)
            if layout is not None
            else np.arange(self.n_rows, dtype=np.int64)
        )
        self.pos_of = np.empty(self.n_rows, np.int64)
        self.pos_of[self.order] = np.arange(self.n_rows, dtype=np.int64)
        self.host: HostTier | None = None
        if self.budget.host_bytes is not None:
            self.host = HostTier(
                self.n_rows, self.budget.chunk_rows,
                self.budget.budget_blocks(self.bytes_per_row),
            )
        self._block_owner_memo: dict[int, tuple[np.ndarray, int]] = {}

    # ------------------------------------------------------------- row reads
    def peek_rows(self, node_ids: np.ndarray) -> np.ndarray:
        """Pure row gather: no residency mutation, safe off-thread."""
        node_ids = np.asarray(node_ids, np.int64).ravel()
        if self.features is not None:
            return self.features[node_ids]
        return self.source.rows(node_ids)

    # ------------------------------------------------------------- residency
    def touch(self, node_ids: np.ndarray) -> BlockCharge | None:
        """Stage ``node_ids``'s blocks into the host tier; return the
        induced block traffic (None when the tier is unlimited)."""
        if self.host is None:
            return None
        node_ids = np.asarray(node_ids, np.int64).ravel()
        pos = self.pos_of[node_ids]
        resident_before = self.host.is_resident(self.host.block_of(pos))
        self.tier_stats.host_hits += int(resident_before.sum())
        self.tier_stats.host_misses += int((~resident_before).sum())
        fetched = self.host.touch(pos)
        per_owner = np.zeros(self.n_parts - 1, np.float64)
        local_rows = 0
        for b in fetched:
            rows_o, n_local = self._block_owner_rows(int(b))
            per_owner += rows_o
            local_rows += n_local
        self.tier_stats.block_fetches += int(len(fetched))
        self.tier_stats.remote_block_rows += int(per_owner.sum())
        self.tier_stats.local_block_rows += int(local_rows)
        self.tier_stats.evictions = self.host.evictions
        self.tier_stats.pinned_over_budget = self.host.pinned_over_budget
        block_bytes = self.budget.chunk_rows * self.bytes_per_row
        self.tier_stats.peak_resident_bytes = (
            self.host.peak_resident * block_bytes
        )
        return BlockCharge(
            per_owner_rows=per_owner,
            local_rows=int(local_rows),
            n_blocks=int(len(fetched)),
        )

    def pin_window(self, node_ids: np.ndarray) -> None:
        """Pin the blocks the pending RebuildPlan references (replaces the
        previous pin set); no-op on the unlimited tier."""
        if self.host is not None:
            self.host.pin(
                self.pos_of[np.asarray(node_ids, np.int64).ravel()]
            )

    def headroom(self) -> float:
        """Normalized free host budget in [0, 1] (1.0 when unlimited): the
        controller's cache-headroom observation."""
        if self.host is None or self.budget.host_bytes is None:
            return 1.0
        block_bytes = self.budget.chunk_rows * self.bytes_per_row
        resident = self.host.n_resident * block_bytes
        return float(np.clip(
            1.0 - resident / max(self.budget.host_bytes, 1.0), 0.0, 1.0
        ))

    # ------------------------------------------------------------- internals
    def _block_owner_rows(self, b: int) -> tuple[np.ndarray, int]:
        """(remote-coord per-owner row counts, local row count) of block
        ``b``: the traffic one block materialization induces. Blocks are
        slices of the STORAGE order, not of id space."""
        memo = self._block_owner_memo.get(b)
        if memo is not None:
            return memo
        lo = b * self.budget.chunk_rows
        hi = min(lo + self.budget.chunk_rows, self.n_rows)
        owners = self.owner_of[self.order[lo:hi]]
        per_owner = np.zeros(self.n_parts - 1, np.float64)
        for p, i in self.remote_index_of.items():
            per_owner[i] = float(np.sum(owners == p))
        n_local = int(np.sum(owners == self.self_rank))
        self._block_owner_memo[b] = (per_owner, n_local)
        return per_owner, n_local
