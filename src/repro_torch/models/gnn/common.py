"""Shared GNN machinery: scatter message passing, loss and accuracy.

Port of ``repro/models/gnn/common.py``. Scatter-reduce is ``index_add``
into the destination rows (sums, means, counts) or ``scatter_reduce``
with ``"amax"`` (maxima); this is the plain path the CSR SpMM kernel is
held against, and the path PNA and GatedGCN aggregate through, as the
reference's XLA segment ops do.

Three semantics follow ``jax.ops``: an empty or fully masked segment's
maximum is ``NEG_INF`` (``segment_max``'s -inf, mapped to 0 as the
reference maps anything at or below ``NEG_INF / 2``); the gradient of a
maximum splits evenly among tied maxima (``scatter_reduce``'s backward
does so); ``in_degrees`` is float32 whatever the messages' dtype.

Rows are gathered with ``index_select``, whose backward is an
``index_add``: the backward of indexing (``x[idx]``), ``index_put`` with
``accumulate``, sorts the indices, and on the card took 45 of the 100 ms
of a PNA ``minibatch_lg`` step and 356 of GatedGCN's 473.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def scatter_sum(messages, edge_dst, n_nodes, edge_mask=None):
    if edge_mask is not None:
        messages = torch.where(
            edge_mask.reshape((-1,) + (1,) * (messages.dim() - 1)),
            messages, 0.0)
    out = torch.zeros(
        (n_nodes,) + tuple(messages.shape[1:]), dtype=messages.dtype,
        device=messages.device,
    )
    return out.index_add(0, edge_dst.long(), messages)


def scatter_mean(messages, edge_dst, n_nodes, edge_mask=None):
    s = scatter_sum(messages, edge_dst, n_nodes, edge_mask)
    ones = torch.ones(
        messages.shape[0], dtype=messages.dtype, device=messages.device
    )
    if edge_mask is not None:
        ones = torch.where(edge_mask, ones, 0.0)
    cnt = scatter_sum(ones, edge_dst, n_nodes)
    return s / torch.clamp(cnt, min=1.0)[:, None]


def segment_max(values, edge_dst, n_nodes, fill=NEG_INF):
    """``jax.ops.segment_max``, with ``fill`` (-inf in JAX) in empty
    segments."""
    out = torch.full((n_nodes,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    idx = edge_dst.long().reshape((-1,) + (1,) * (values.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(values), values, "amax",
                              include_self=False)


def scatter_max(messages, edge_dst, n_nodes, edge_mask=None):
    if edge_mask is not None:
        messages = torch.where(edge_mask[:, None], messages, NEG_INF)
    out = segment_max(messages, edge_dst, n_nodes)
    return torch.where(out <= NEG_INF / 2, 0.0, out)


def scatter_min(messages, edge_dst, n_nodes, edge_mask=None):
    return -scatter_max(-messages, edge_dst, n_nodes, edge_mask)


def scatter_std(messages, edge_dst, n_nodes, edge_mask=None, eps=1e-5):
    mean = scatter_mean(messages, edge_dst, n_nodes, edge_mask)
    sq = scatter_mean(torch.square(messages), edge_dst, n_nodes, edge_mask)
    # ``maximum`` splits the gradient of a tie (var exactly 0) as
    # ``jnp.maximum`` does; ``clamp`` would pass all of it
    var = torch.maximum(sq - torch.square(mean), sq.new_zeros(()))
    return torch.sqrt(var + eps)


def segment_softmax(scores, edge_dst, n_nodes, edge_mask=None):
    """Numerically-stable softmax over each destination's incoming edges."""
    if edge_mask is not None:
        scores = torch.where(edge_mask, scores, NEG_INF)
    mx = segment_max(scores, edge_dst, n_nodes)
    mx = torch.where(mx <= NEG_INF / 2, 0.0, mx)
    dst = edge_dst.long()
    ex = torch.exp(scores - mx.index_select(0, dst))
    if edge_mask is not None:
        ex = torch.where(edge_mask, ex, 0.0)
    denom = scatter_sum(ex, dst, n_nodes)
    return ex / torch.clamp(denom.index_select(0, dst), min=1e-9)


def in_degrees(edge_dst, n_nodes, edge_mask=None):
    ones = torch.ones(edge_dst.shape[0], dtype=torch.float32,
                      device=edge_dst.device)
    if edge_mask is not None:
        ones = torch.where(edge_mask, ones, 0.0)
    return scatter_sum(ones, edge_dst, n_nodes)


def layer_norm(x, gamma, beta, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return gamma * (x - mu) / torch.sqrt(var + eps) + beta


def cross_entropy(logits, labels, mask=None):
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def accuracy(logits, labels, mask=None):
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == labels).float()
    if mask is not None:
        return torch.sum(correct * mask) / torch.clamp(mask.sum(), min=1.0)
    return correct.mean()
