"""Plain scatter oracle for the GNN SpMM (gather -> weight -> scatter-add).

Port of ``repro/kernels/segment_mm/ref.py::spmm_ref``.
"""
from __future__ import annotations

import torch


def spmm_ref(
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    x: torch.Tensor,
    n_dst: int,
    edge_weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """Y[d] = sum_{e: dst(e)=d} w_e * X[src(e)] — the message-passing SpMM."""
    msgs = x[edge_src.long()]
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    out = torch.zeros((n_dst, x.shape[1]), dtype=msgs.dtype, device=x.device)
    return out.index_add_(0, edge_dst.long(), msgs)
