"""Device tier: capacity-bounded payload buffer over the hot-node cache.

Port of ``repro/store/device_tier.py``. The ``DoubleBufferedCache`` tracks
hot node *ids*; this tier holds the feature payload rows of the active
buffer as a (n_active, n_feat) tensor on the run's device and serves the
hit path through the ``embedding_bag`` kernel: one bag of one unit-weight
lookup per hit, which is an exact row gather, so the rows are bit-equal
to a plain ``table[idx]``. The gathered rows stay on the device.

A rebuild is double-buffered on the device too. :meth:`build` assembles
the next window's table while the active one serves hits: the persisted
rows are gathered device-to-device out of the active table by the same
kernel (one unit-weight bag per row), and only the fetched rows are
uploaded, from pinned memory, in one ``non_blocking`` copy together with
the gather's operands. :meth:`install` is the swap: the compute stream
waits for the event the build recorded, then the pointer flips. The
active table is never written. The pipeline's builder thread builds on a
CUDA stream of its own (``background=True``), so the upload and the
gather overlap the window's steps; the synchronous path builds on the
current stream. The host payload (``_payload``) is assembled as the
reference's ``load`` assembles it and stays bit-equal to it, for
:meth:`gather_slots` and :attr:`resident_bytes`.

The reference pads the request to a power of two to bound its compile
signatures; the port needs no such pad, so a gather of ``n`` hits is a
:class:`BagFormat` of exactly ``n`` bags, built in numpy and moved in one
copy. The kernel runs on a CUDA table and its plain version on a CPU one;
the reference's hard-coded ``interpret=True`` has no counterpart here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.windowed_cache import DoubleBufferedCache, RebuildPlan
from repro_torch.device import PinnedStaging, to_device_packed
from repro_torch.kernels.embedding_bag import BagFormat, bag_sum


@dataclasses.dataclass(frozen=True)
class PendingTable:
    """One rebuild's payload, built before the swap that installs it."""

    payload: np.ndarray      # host rows for plan.hot_nodes
    table: torch.Tensor      # the same rows on the tier's device
    generation: int          # cache generation the plan was diffed against
    ready: object | None     # CUDA event after the table's last write
                             # (None on the CPU)


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
        self._table = torch.zeros((0, self.n_feat), dtype=torch.float32,
                                  device=self.device)
        cuda = self.device.type == "cuda"
        # one pinned buffer: builds are serialized, and each waits for the
        # previous build's copy out of it before writing it again
        self._staging = PinnedStaging() if cuda else None
        self._side = None        # the builder's CUDA stream, made on use
        self.n_loads = 0

    @property
    def resident_bytes(self) -> float:
        return float(self._payload.nbytes)

    # ---------------------------------------------------------------- loads
    def build(self, plan: RebuildPlan, peek_fn,
              fetched_rows: np.ndarray | None = None,
              background: bool = False) -> PendingTable:
        """Assemble the payload for ``plan.hot_nodes`` against the active
        one; the active table is only read.

        MUST run before ``cache.swap(plan)``: persisted rows come out of
        the current payload via the *old* active-node table.
        ``fetched_rows`` are the rows for ``plan.hot_nodes[plan.fetched]``
        when the caller already gathered them; otherwise they are peeked
        from the backing store. ``background=True`` (the builder thread)
        runs the device work on the tier's own CUDA stream and waits for
        it before returning, so a CUDA error raises on the caller's
        thread."""
        ids = plan.hot_nodes
        payload = np.zeros((len(ids), self.n_feat), self.dtype)
        old_active = self.cache.active_nodes
        keep_pos = np.empty(0, np.int64)
        if plan.persisted.any() and len(old_active) == len(self._payload):
            keep_pos = np.searchsorted(old_active, ids[plan.persisted])
            payload[plan.persisted] = self._payload[keep_pos]
        rows = np.zeros((0, self.n_feat), self.dtype)
        if plan.fetched.any():
            if fetched_rows is None:
                fetched_rows = peek_fn(ids[plan.fetched])
            rows = np.asarray(fetched_rows, self.dtype)[
                : int(plan.fetched.sum())]
            payload[plan.fetched] = rows
        generation = self.cache.generation
        if not (background and self.device.type == "cuda"):
            table, ready = self._device_table(plan, keep_pos, rows)
            return PendingTable(payload, table, generation, ready)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._side):
            # the active table is read on this stream: its memory must not
            # be reused before this stream's reads are done
            self._table.record_stream(self._side)
            table, ready = self._device_table(plan, keep_pos, rows)
            self._side.synchronize()
        return PendingTable(payload, table, generation, ready)

    def _device_table(self, plan: RebuildPlan, keep_pos: np.ndarray,
                      rows: np.ndarray):
        """The plan's table on the current stream: the persisted rows
        gathered out of the active table, the fetched ``rows`` uploaded.
        Returns (table, the event after its last write or None)."""
        n_keep = len(keep_pos)
        keep_slots = (np.flatnonzero(plan.persisted) if n_keep
                      else np.empty(0, np.int64))
        fetch_slots = np.flatnonzero(plan.fetched)
        bag_arrays, n_rows, max_len = BagFormat.host_arrays(
            keep_pos, np.arange(n_keep), n_keep, None)
        upload = (to_device_packed if self._staging is None
                  else self._staging.to_device)
        idx, w, offsets, keep_dev, fetch_dev, rows_dev = upload(
            bag_arrays + [keep_slots, fetch_slots, rows], self.device)
        # every row is written unless persisted rows were dropped (an old
        # payload out of step with the cache), which stay zero as on the host
        covered = n_keep + len(fetch_slots) == len(plan.hot_nodes)
        table = (torch.empty if covered else torch.zeros)(
            (len(plan.hot_nodes), self.n_feat), dtype=torch.float32,
            device=self.device)
        if n_keep:
            kept = bag_sum(BagFormat(idx, w, offsets, n_rows, max_len),
                           self._table)
            table.index_copy_(0, keep_dev, kept)
        if len(fetch_slots):
            table.index_copy_(0, fetch_dev, rows_dev)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return table, ready

    def install(self, pending: PendingTable) -> None:
        """Make ``pending`` the active payload (the swap's pointer flip).

        MUST run before ``cache.swap(plan)``; refuses a table built
        against another generation. On the card the current stream first
        waits for the build's event, and the table is marked as used by
        that stream, so its memory outlives the stream's reads."""
        if pending.generation != self.cache.generation:
            raise RuntimeError(
                f"stale pending table: built against generation "
                f"{pending.generation}, cache is at {self.cache.generation}"
            )
        if pending.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(pending.ready)
            pending.table.record_stream(stream)
        self._payload, self._table = pending.payload, pending.table
        self.n_loads += 1

    def load(self, plan: RebuildPlan, peek_fn,
             fetched_rows: np.ndarray | None = None) -> None:
        """:meth:`build` on the current stream, then :meth:`install` (the
        reference's ``load``; MUST run before ``cache.swap(plan)``)."""
        self.install(self.build(plan, peek_fn, fetched_rows))

    # --------------------------------------------------------------- gather
    def gather_rows(self, slot_idx: np.ndarray) -> torch.Tensor:
        """(n, n_feat) rows of active-buffer slots on the tier's device,
        gathered by the embedding_bag kernel."""
        n = len(slot_idx)
        if n == 0 or len(self._payload) == 0:
            return torch.zeros((0, self.n_feat), dtype=torch.float32,
                               device=self.device)
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
