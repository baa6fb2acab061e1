"""Device tier: capacity-bounded payload buffer over the hot-node cache.

Port of ``repro/store/device_tier.py``. The ``DoubleBufferedCache`` tracks
hot node *ids*; this tier holds the feature payload rows of the active
buffer as a (n_active, n_feat) tensor on the run's device and serves the
hit path through the ``embedding_bag`` kernel: one bag of one unit-weight
lookup per hit, which is an exact row gather, so the rows are bit-equal
to a plain ``table[idx]``. The gathered rows stay on the device.

The reference pads the request to a power of two to bound its compile
signatures; the port needs no such pad, so a gather of ``n`` hits is a
:class:`BagFormat` of exactly ``n`` bags, built in numpy and moved in one
copy. The kernel runs on a CUDA table and its plain version on a CPU one;
the reference's hard-coded ``interpret=True`` has no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.windowed_cache import DoubleBufferedCache, RebuildPlan
from repro_torch.kernels.embedding_bag import BagFormat, bag_sum


class DevicePayloadTier:
    """Payload rows for the cache's active buffer + kernel-served hit path."""

    def __init__(self, cache: DoubleBufferedCache, n_feat: int,
                 device: torch.device | str):
        self.cache = cache
        self.n_feat = int(n_feat)
        self.dtype = np.dtype(np.float32)   # the kernel's table type
        self.device = torch.device(device)
        self.capacity = int(cache.capacity)
        self._payload = np.zeros((0, self.n_feat), self.dtype)
        self._table = None       # the payload on the device, made on use

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
        self._table = None  # device table rebuilt lazily on first hit

    # --------------------------------------------------------------- gather
    def gather_rows(self, slot_idx: np.ndarray) -> torch.Tensor:
        """(n, n_feat) rows of active-buffer slots on the tier's device,
        gathered by the embedding_bag kernel."""
        n = len(slot_idx)
        if n == 0 or len(self._payload) == 0:
            return torch.zeros((0, self.n_feat), dtype=torch.float32,
                               device=self.device)
        if self._table is None:
            self._table = torch.as_tensor(self._payload).to(self.device)
        fmt = BagFormat.from_numpy(slot_idx, np.arange(n, dtype=np.int32), n,
                                   None, self.device)
        return bag_sum(fmt, self._table)

    def gather_slots(self, slot_idx: np.ndarray) -> np.ndarray:
        """Rows for active-buffer slots, on the host (the reference's
        interface)."""
        return self.gather_rows(slot_idx).cpu().numpy()

    def gather(self, remote_ids: np.ndarray
               ) -> tuple[np.ndarray, torch.Tensor]:
        """(hit_mask, rows for the hits on the device) for a batch of
        remote node ids."""
        hit, slots = self.cache.lookup(remote_ids)
        return hit, self.gather_rows(slots[hit])
