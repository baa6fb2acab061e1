"""Factorization Machine (Rendle, ICDM'10).

Port of ``repro/models/recsys/fm.py``. Assigned config: 39 sparse fields,
embed_dim 10, 2-way interactions via the O(nk) sum-square identity:

    sum_{i<j} <v_i, v_j> x_i x_j = 1/2 * ( (sum_i v_i x_i)^2 - sum_i (v_i x_i)^2 )

For categorical fields x_i = 1, so the per-example cost is one fused gather
(B, F, k) + two reductions. The reference's ``shard_activation`` hints are
dropped: without a mesh they do nothing.

``retrieval_scores`` scores one query against N candidates with a single
batched matvec (no loop): FM(query + candidate) decomposes into
query-constant terms + <sum_query_v, v_c> + linear_c.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import param
from repro_torch.models.recsys.embedding import field_offsets, lookup_fields

# Criteo-like vocabulary sizes for 39 categorical fields (26 raw categorical
# + 13 bucketized numeric): 33,775,577 rows in all (the reference's comment
# says ~38.8M).
CRITEO_VOCABS = [
    1460, 583, 10_131_227, 2_202_608, 305, 24, 12_517, 633, 3, 93_145,
    5_683, 8_351_593, 3_194, 27, 14_992, 5_461_306, 10, 5_652, 2_173, 4,
    7_046_547, 18, 15, 286_181, 105, 142_572,
] + [1_000] * 13


@dataclasses.dataclass(frozen=True)
class FMConfig:
    n_fields: int = 39
    embed_dim: int = 10
    vocab_sizes: tuple = tuple(CRITEO_VOCABS)
    pad_rows_to: int = 0  # pad total rows for shard divisibility

    @property
    def total_rows(self) -> int:
        raw = int(sum(self.vocab_sizes))
        return max(raw, self.pad_rows_to)


def init(cfg: FMConfig, seed: int = 0, device="cuda"):
    """``(params, axes)`` in the reference's tree, drawn on ``device`` from
    a generator seeded with ``seed`` (``device="meta"``: shapes only)."""
    assert len(cfg.vocab_sizes) == cfg.n_fields
    pb = param.builder(seed, device)
    pb.param("table", (cfg.total_rows, cfg.embed_dim),
             ("table_rows", "embed"), init="embedding")
    pb.param("linear", (cfg.total_rows, 1), ("table_rows", "embed"),
             init="embedding", scale=0.01)
    pb.param("bias", (1,), ("embed",), init="zeros")
    return pb.params, pb.axes


def offsets(cfg: FMConfig) -> np.ndarray:
    return field_offsets(list(cfg.vocab_sizes))


def scores(params, cfg: FMConfig, ids, field_offsets_arr):
    """ids: (B, F) categorical ids -> (B,) logits."""
    emb = lookup_fields(params["table"], ids, field_offsets_arr)   # (B,F,k)
    lin = lookup_fields(params["linear"], ids, field_offsets_arr)  # (B,F,1)
    s = emb.sum(dim=1)
    sq = (emb * emb).sum(dim=1)
    pair = 0.5 * (s * s - sq).sum(dim=-1)
    return params["bias"][0] + lin.sum(dim=(1, 2)) + pair


def bce_loss(params, cfg: FMConfig, ids, labels, field_offsets_arr):
    logits = scores(params, cfg, ids, field_offsets_arr).float()
    y = labels.float()
    # ``maximum`` splits a tie's gradient (a logit of exactly 0) as jnp does
    return torch.mean(
        torch.maximum(logits, logits.new_zeros(())) - logits * y
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def retrieval_scores(params, cfg: FMConfig, query_ids, field_offsets_arr,
                     candidate_rows):
    """Score ONE query (F-1 context fields) against N candidate items.

    candidate_rows: (N,) absolute row ids of the candidate field's values.
    FM(query || cand) = const(query) + <s_q, v_c> + lin_c, so scoring all
    candidates is a (N,k) @ (k,) matvec — batched-dot, not a loop.
    """
    q_emb = lookup_fields(
        params["table"], query_ids[None, :], field_offsets_arr
    )[0]                                           # (F-1, k)
    s_q = q_emb.sum(dim=0)                         # (k,)
    q_lin = lookup_fields(
        params["linear"], query_ids[None, :], field_offsets_arr
    )[0].sum()
    q_pair = 0.5 * ((s_q * s_q) - (q_emb * q_emb).sum(0)).sum()

    rows = candidate_rows.long()
    v_c = params["table"].index_select(0, rows)    # (N, k)
    lin_c = params["linear"].index_select(0, rows)[:, 0]
    cross = v_c @ s_q                              # (N,)
    return params["bias"][0] + q_lin + q_pair + lin_c + cross
