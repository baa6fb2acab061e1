"""Sum-mode EmbeddingBag: its operand format, the kernel wrapper and its
plain version.

Port of ``repro/kernels/embedding_bag/ops.py::embedding_bag_pallas``. The
hand-written CUDA kernel ``csrc/embedding_bag.cu`` replaces
``repro/kernels/embedding_bag/kernel.py:48``
(``embedding_bag_kernel``). Both give the TPU kernel's semantics: a bag's
first lookup assigns, later ones add, the product is rounded before the
sum, and a bag with no lookups is zero. One lookup per bag with unit
weight is therefore a bit-exact row gather.

The kernel takes its operands as a :class:`BagFormat`: the lookups
stably sorted by bag, their weights and the bag offsets, built and range
checked once in numpy (:meth:`BagFormat.from_numpy`) and moved to the
device in one copy, so a launch reads nothing back from the device.
:func:`bag_sum` launches the kernel for a CUDA table and takes
:func:`bag_plain` for a CPU one; for a ``meta`` table it returns the
output's shape and charges the counter (``launch.count``) what a launch
would do. The tensor wrapper :func:`embedding_bag`
sorts on the device instead, for callers that hold tensors.

Bound: bytes (one table row read per lookup, one row written per bag).
Design (note at the top of ``csrc/embedding_bag.cu``): a group of D/4
lanes owns a bag, one float4 a lane per row, one streaming store per
lane; exactly one lookup per bag (the gather) runs an instance that
reads no offsets and holds no row buffers, so every SM keeps 64 warps of
bags in flight, and any other bags one that loads a batch of lookups at
once with 8 rows in flight.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import to_device_packed
from repro_torch.kernels import _build


@dataclasses.dataclass(frozen=True)
class BagFormat:
    """Bag-sorted lookups on a device, checked when they were made."""

    idx: torch.Tensor       # (L,) int32 table rows, stably sorted by bag
    w: torch.Tensor         # (L,) float32 weights, in the same order
    offsets: torch.Tensor   # (n_bags + 1,) int32: bag b owns [o[b], o[b+1])
    n_rows: int             # rows the table needs: max(idx) + 1 (0 if L = 0)
    max_len: int            # lookups in the longest bag (0 if L = 0)

    @property
    def n_bags(self) -> int:
        return self.offsets.shape[0] - 1

    @classmethod
    def from_numpy(cls, indices, segment_ids, n_bags: int, weights,
                   device) -> BagFormat:
        """Sort (stably), offset and range-check ``(L,)`` lookups and their
        bags in numpy, then move them to ``device`` in one copy.
        ``weights`` None means unit weights."""
        arrays, n_rows, max_len = cls.host_arrays(indices, segment_ids,
                                                  n_bags, weights)
        return cls(*to_device_packed(arrays, device), n_rows, max_len)

    @staticmethod
    def host_arrays(indices, segment_ids, n_bags: int, weights
                    ) -> tuple[list[np.ndarray], int, int]:
        """The checked format in numpy: ``([idx, w, offsets], n_rows,
        max_len)``, for a caller that moves it to the device together with
        arrays of its own (then ``BagFormat(*tensors, n_rows, max_len)``)."""
        indices = np.asarray(indices)
        segment_ids = np.asarray(segment_ids)
        n_bags = int(n_bags)
        if indices.ndim != 1 or segment_ids.shape != indices.shape:
            raise ValueError("BagFormat: indices and segments must be (L,)")
        if n_bags < 0:
            raise ValueError("BagFormat: n_bags must be >= 0")
        w = (np.ones(indices.shape, np.float32) if weights is None
             else np.asarray(weights, np.float32))
        if w.shape != indices.shape:
            raise ValueError("BagFormat: weights must be (L,)")
        n_rows = 0
        if indices.size:
            lo, hi = int(indices.min()), int(indices.max())
            if lo < 0 or hi >= 2**31:
                raise IndexError("embedding_bag: indices out of range")
            if not (0 <= segment_ids.min() and segment_ids.max() < n_bags):
                raise IndexError("embedding_bag: segment ids out of range")
            n_rows = hi + 1
        order = np.argsort(segment_ids, kind="stable")
        offsets = np.searchsorted(segment_ids[order], np.arange(n_bags + 1),
                                  side="left")
        max_len = int(np.diff(offsets).max()) if indices.size else 0
        return ([indices[order].astype(np.int32), w[order],
                 offsets.astype(np.int32)], n_rows, max_len)


def embedding_bag_plain(table, idx, seg, w, n_bags: int) -> torch.Tensor:
    """Plain PyTorch version over bag-sorted lookups: the first lookup of
    each bag assigns its weighted row, the rest are added in order."""
    rows = table[idx.long()] * w[:, None]
    out = torch.zeros(
        (n_bags, table.shape[1]), dtype=table.dtype, device=table.device
    )
    first = torch.ones(seg.shape[0], dtype=torch.bool, device=seg.device)
    first[1:] = seg[1:] != seg[:-1]
    out[seg[first].long()] = rows[first]
    out.index_add_(0, seg[~first].long(), rows[~first])
    return out


def bag_plain(fmt: BagFormat, table) -> torch.Tensor:
    """:func:`embedding_bag_plain` over a :class:`BagFormat`."""
    seg = torch.repeat_interleave(
        torch.arange(fmt.n_bags, dtype=torch.int32, device=table.device),
        (fmt.offsets[1:] - fmt.offsets[:-1]).long(),
        output_size=fmt.idx.shape[0],
    )
    return embedding_bag_plain(table, fmt.idx, seg, fmt.w, fmt.n_bags)


def _check_table(fmt: BagFormat, table) -> None:
    if table.dtype != torch.float32 or table.dim() != 2:
        raise TypeError("embedding_bag: table must be (R, D) float32")
    if not (fmt.idx.device == fmt.w.device == fmt.offsets.device
            == table.device):
        raise ValueError("embedding_bag: all operands must be on one device")
    if table.shape[0] < fmt.n_rows:
        raise IndexError("embedding_bag: indices out of range of table")


def bag_sum(fmt: BagFormat, table) -> torch.Tensor:
    """(n_bags, D) bag sums of ``table`` rows: the CUDA kernel for a CUDA
    table, :func:`bag_plain` for a CPU one. Reads nothing back from the
    device."""
    if table.device.type == "cpu":
        _check_table(fmt, table)
        return bag_plain(fmt, table)
    out = torch.empty((fmt.n_bags, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    bag_launch(fmt, table, out)
    return out


def bag_work_bytes(n_lookups: int, n_bags: int, d: int) -> float:
    """Bytes of one launch, the bound's formula: a table row, an index
    and a weight read a lookup, the offsets read and a row written a bag.
    No matrix-class FLOPs: a bag sum is a gather and an elementwise sum
    (``launch.count`` counts such work in bytes)."""
    return 4.0 * (n_lookups * (d + 2) + n_bags + 1 + n_bags * d)


def bag_launch(fmt: BagFormat, table, out) -> None:
    """Launch the kernel into ``out`` (counts one launch). Checks device,
    dtype, shape and contiguity on the host; reads nothing on the
    device. Every launch charges :func:`bag_work_bytes` to the active
    counters (``_build.count_launch``); on ``meta`` the charge stands in
    for the launch."""
    _check_table(fmt, table)
    if table.device.type not in ("cuda", "meta"):
        raise ValueError(f"embedding_bag: kernel needs CUDA, got "
                         f"{table.device}")
    if out.dtype != torch.float32 or out.device != table.device \
            or tuple(out.shape) != (fmt.n_bags, table.shape[1]):
        raise ValueError("embedding_bag: out must be (n_bags, D) float32 "
                         "on the table's device")
    for name, t in (("table", table), ("out", out), ("idx", fmt.idx),
                    ("w", fmt.w), ("offsets", fmt.offsets)):
        if not t.is_contiguous():
            raise ValueError(f"embedding_bag: {name} must be contiguous")
    if fmt.n_bags == 0 or table.shape[1] == 0:
        return  # nothing to launch
    work = (0.0, bag_work_bytes(fmt.idx.shape[0], fmt.n_bags,
                                table.shape[1]))
    if table.device.type == "meta":
        _build.charge(embedding_bag, *work)
        return
    fn = _build.entry("embedding_bag_f32")
    err = fn(
        fmt.idx.data_ptr(), fmt.w.data_ptr(), fmt.offsets.data_ptr(),
        table.data_ptr(), out.data_ptr(), int(fmt.n_bags),
        int(table.shape[1]), int(fmt.idx.shape[0]), int(fmt.max_len),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    _build.count_launch(embedding_bag, *work)
    _build.check("embedding_bag_f32", err)


def sort_bags(indices, segment_ids, n_bags: int, weights):
    """The tensor wrapper's operands: lookups and weights stably sorted
    by bag on their device, and the bag offsets by ``searchsorted``.
    Returns ``(idx, w, offsets)``."""
    seg_s, order = torch.sort(segment_ids, stable=True)
    offsets = torch.searchsorted(
        seg_s, torch.arange(n_bags + 1, dtype=torch.int32,
                            device=seg_s.device), out_int32=True,
    )
    return indices[order].contiguous(), weights[order].contiguous(), offsets


def embedding_bag(table, indices, segment_ids, n_bags: int,
                  weights=None) -> torch.Tensor:
    """(n_bags, D) sum-mode bags of ``table`` rows.

    ``indices``/``segment_ids`` are (L,) int32 lookups and their bags (any
    order), ``weights`` an optional (L,) float32 per-lookup scale. The
    range check reads the extremes back to the host (a sync on the card);
    the trainer's path builds a :class:`BagFormat` in numpy instead.
    """
    if not (table.device == indices.device == segment_ids.device):
        raise ValueError("embedding_bag: all operands must be on one device")
    if table.dtype != torch.float32 or table.dim() != 2:
        raise TypeError("embedding_bag: table must be (R, D) float32")
    if indices.dtype != torch.int32 or segment_ids.dtype != torch.int32:
        raise TypeError("embedding_bag: indices and segments must be int32")
    if indices.dim() != 1 or segment_ids.shape != indices.shape:
        raise ValueError("embedding_bag: indices and segments must be (L,)")
    if weights is None:
        weights = torch.ones(indices.shape, dtype=table.dtype,
                             device=table.device)
    if weights.shape != indices.shape or weights.dtype != table.dtype \
            or weights.device != table.device:
        raise ValueError("embedding_bag: weights must be (L,) like table")
    if table.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"embedding_bag: unsupported device {table.device}")
    idx, w, offsets = sort_bags(indices, segment_ids, n_bags, weights)
    n_rows = max_len = 0
    if table.device.type == "meta":
        # shapes only: nothing to range-check, the longest bag unknown
        n_rows, max_len = table.shape[0], indices.shape[0]
    elif indices.shape[0]:
        lo, hi, s_lo, s_hi = torch.stack([
            indices.min(), indices.max(), segment_ids.min(),
            segment_ids.max(),
        ]).tolist()
        if not (0 <= lo and hi < table.shape[0]):
            raise IndexError("embedding_bag: indices out of range of table")
        if not (0 <= s_lo and s_hi < n_bags):
            raise IndexError("embedding_bag: segment ids out of range")
        n_rows = hi + 1
        max_len = int((offsets[1:] - offsets[:-1]).max())
    return bag_sum(BagFormat(idx, w, offsets, n_rows, max_len), table)


embedding_bag.launches = 0
embedding_bag.launches_by_thread = {}
