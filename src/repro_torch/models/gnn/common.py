"""Shared GNN machinery: scatter message passing, loss and accuracy.

Port of ``repro/models/gnn/common.py`` (``scatter_sum``, ``scatter_mean``,
``cross_entropy``, ``accuracy``). Scatter-reduce is ``index_add`` into
the destination rows; this is the plain path the block-sparse kernel is
held against.
"""
from __future__ import annotations

import torch


def scatter_sum(messages, edge_dst, n_nodes, edge_mask=None):
    if edge_mask is not None:
        messages = torch.where(edge_mask[:, None], messages, 0.0)
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
