"""Sum-mode EmbeddingBag: the kernel wrapper and its plain version.

Port of ``repro/kernels/embedding_bag/ops.py::embedding_bag_pallas``.
``embedding_bag`` stable-sorts the lookups by bag, as the reference
wrapper does, then launches the hand-written CUDA kernel
``csrc/embedding_bag.cu`` (which replaces
``repro/kernels/embedding_bag/kernel.py::embedding_bag_kernel``) for CUDA
tensors, or takes :func:`embedding_bag_plain` for CPU tensors. Both give
the TPU kernel's semantics: a bag's first lookup assigns, later ones add,
and a bag with no lookups is zero. One lookup per bag with unit weight is
therefore a bit-exact row gather.

Bound: bytes (one table row read per lookup, one row written per bag).
Design (note at the top of ``csrc/embedding_bag.cu``): one warp per bag
over its run of sorted lookups, each warp load one coalesced row.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


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


def embedding_bag(table, indices, segment_ids, n_bags: int,
                  weights=None) -> torch.Tensor:
    """(n_bags, D) sum-mode bags of ``table`` rows.

    ``indices``/``segment_ids`` are (L,) int32 lookups and their bags (any
    order), ``weights`` an optional (L,) float32 per-lookup scale.
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
    seg_s, order = torch.sort(segment_ids, stable=True)
    idx_s = indices[order].contiguous()
    w_s = weights[order].contiguous()
    if table.device.type == "cpu":
        return embedding_bag_plain(table, idx_s, seg_s, w_s, n_bags)
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag: unsupported device {table.device}")
    if not table.is_contiguous():
        raise ValueError("embedding_bag: table must be contiguous")
    if idx_s.shape[0]:
        lo_hi = torch.stack([
            idx_s.min(), idx_s.max(), seg_s[0], seg_s[-1],
        ]).tolist()
        if not (0 <= lo_hi[0] and lo_hi[1] < table.shape[0]):
            raise IndexError("embedding_bag: indices out of range of table")
        if not (0 <= lo_hi[2] and lo_hi[3] < n_bags):
            raise IndexError("embedding_bag: segment ids out of range")
    offsets = torch.searchsorted(
        seg_s, torch.arange(n_bags + 1, dtype=torch.int32,
                            device=seg_s.device), out_int32=True,
    )
    out = torch.empty((n_bags, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    launch(idx_s, w_s, offsets, table, out)
    return out


def launch(idx, w, offsets, table, out) -> None:
    """Launch the kernel on checked, bag-sorted operands (counts one
    launch)."""
    fn = _build.entry("embedding_bag_f32")
    err = fn(
        idx.data_ptr(), w.data_ptr(), offsets.data_ptr(), table.data_ptr(),
        out.data_ptr(), int(out.shape[0]), int(out.shape[1]),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    embedding_bag.launches += 1
    _build.check("embedding_bag_f32", err)


embedding_bag.launches = 0
