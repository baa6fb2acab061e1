"""EmbeddingBag as a gather and segment reductions.

Port of ``repro/models/recsys/embedding.py``: the lookup is an
``index_select`` of table rows (its backward an ``index_add``), the bag
reduction an ``index_add`` (sum, mean) or a
``scatter_reduce`` (max), as the reference's are ``jnp.take`` and XLA
segment ops (no ``pl.pallas_call``; the trainer's EmbeddingBag kernel,
``kernels/embedding_bag``, is another path). Multi-field models use one
*concatenated* table with per-field row offsets so a whole example resolves
in a single gather. Ids and offsets are int64.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.gnn import common


def embedding_bag(
    table: torch.Tensor,        # (rows, dim)
    indices: torch.Tensor,      # (n_lookups,)
    segment_ids: torch.Tensor,  # (n_lookups,) -> bag id
    n_bags: int,
    mode: str = "sum",
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    rows = table.index_select(0, indices.long())
    if weights is not None:
        rows = rows * weights[:, None]
    if mode == "sum":
        return common.scatter_sum(rows, segment_ids, n_bags)
    if mode == "mean":
        s = common.scatter_sum(rows, segment_ids, n_bags)
        c = common.scatter_sum(
            torch.ones(indices.shape, dtype=s.dtype, device=s.device),
            segment_ids, n_bags)
        return s / torch.clamp(c, min=1.0)[:, None]
    if mode == "max":
        # an empty bag is -inf, as jax.ops.segment_max leaves it
        return common.segment_max(rows, segment_ids, n_bags,
                                  fill=float("-inf"))
    raise ValueError(mode)


def field_offsets(vocab_sizes: list[int]) -> np.ndarray:
    """Row offset of each field inside the concatenated table."""
    return np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]]).astype(np.int64)


def lookup_fields(
    table: torch.Tensor,     # (total_rows, dim) concatenated over fields
    ids: torch.Tensor,       # (B, F) per-field categorical ids
    offsets: torch.Tensor,   # (F,)
) -> torch.Tensor:
    """One fused gather for all fields: (B, F, dim). ``offsets`` may lie
    on another device than ``ids`` (a cell's, when its step is repeated on
    the CPU)."""
    flat = (ids.long() + offsets.to(ids.device).long()[None, :]).reshape(-1)
    return table.index_select(0, flat).reshape(*ids.shape, table.shape[-1])
