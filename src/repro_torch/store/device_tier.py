"""Device tier: capacity-bounded payload buffer over the hot-node cache.

Port of ``repro/store/device_tier.py``. The ``DoubleBufferedCache`` tracks
hot node *ids*; this tier holds the feature payload rows of the active
buffer as a (capacity, n_feat) tensor on the run's device and serves the
hit path through the ``embedding_bag`` kernel wrapper. One index per bag
with unit weight is an exact row gather, so the output is bit-equal to a
plain ``table[idx]``.

The gather pads the request length to the next power of two (pad bags
carry weight 0), as the reference does to bound its compile signatures.
The wrapper dispatches on the device of the table (the kernel on CUDA, its
plain version on the CPU); the reference's hard-coded ``interpret=True``
has no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.windowed_cache import DoubleBufferedCache, RebuildPlan
from repro_torch.kernels.embedding_bag import embedding_bag


class DevicePayloadTier:
    """Payload rows for the cache's active buffer + kernel-served hit path."""

    def __init__(self, cache: DoubleBufferedCache, n_feat: int,
                 device: torch.device | str = "cpu"):
        self.cache = cache
        self.n_feat = int(n_feat)
        self.dtype = np.dtype(np.float32)   # the kernel's table type
        self.device = torch.device(device)
        self.capacity = int(cache.capacity)
        self._payload = np.zeros((0, self.n_feat), self.dtype)
        self._table = None       # zero-padded (capacity, n_feat) on device

    # ---------------------------------------------------------------- loads
    def load(self, plan: RebuildPlan, peek_fn) -> None:
        """Assemble the payload for ``plan.hot_nodes``.

        MUST run before ``cache.swap(plan)``: persisted rows are copied out
        of the current payload via the *old* active-node table; fetched
        rows are peeked from the backing store.
        """
        ids = plan.hot_nodes
        new_payload = np.zeros((len(ids), self.n_feat), self.dtype)
        old_active = self.cache.active_nodes
        if plan.persisted.any() and len(old_active) == len(self._payload):
            kept = ids[plan.persisted]
            pos = np.searchsorted(old_active, kept)
            new_payload[plan.persisted] = self._payload[pos]
        if plan.fetched.any():
            new_payload[plan.fetched] = np.asarray(
                peek_fn(ids[plan.fetched]), self.dtype
            )
        self._payload = new_payload
        self._table = None  # padded device table rebuilt lazily on first hit

    # --------------------------------------------------------------- gather
    def gather_slots(self, slot_idx: np.ndarray) -> np.ndarray:
        """Rows for active-buffer slots via the embedding_bag kernel."""
        n = len(slot_idx)
        if n == 0 or len(self._payload) == 0:
            return np.zeros((0, self.n_feat), self.dtype)
        if self._table is None:
            padded = np.zeros((self.capacity, self.n_feat), self.dtype)
            padded[: len(self._payload)] = self._payload
            self._table = torch.as_tensor(padded).to(self.device)
        bucket = 1 << (n - 1).bit_length()
        idx = np.zeros(bucket, np.int32)
        idx[:n] = np.asarray(slot_idx, np.int32)
        w = np.zeros(bucket, np.float32)
        w[:n] = 1.0  # pad bags carry weight 0 -> exact gather after slicing
        out = embedding_bag(
            self._table,
            torch.as_tensor(idx).to(self.device),
            torch.arange(bucket, dtype=torch.int32, device=self.device),
            n_bags=bucket,
            weights=torch.as_tensor(w).to(self.device),
        )
        return out[:n].cpu().numpy().astype(self.dtype, copy=False)

    def gather(self, remote_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(hit_mask, rows for the hits) for a batch of remote node ids."""
        hit, slots = self.cache.lookup(remote_ids)
        return hit, self.gather_slots(slots[hit])
