"""GraphSAGE (Hamilton et al. 2017) — the paper's training model
(Section VI-A: 2-layer, 16 hidden units, mean aggregator).

Port of ``repro/models/gnn/sage.py``. Parameters are a plain dict of
tensors in the reference's layout, ``{"layer_i": {"w_self", "w_neigh",
"b"}}``, so parameters carry across with ``repro_torch.convert``.

Two entry points:
  * ``apply_full``   — full-graph message passing over an edge list
  * ``apply_blocks`` — sampled mini-batch forward over sampler Blocks
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import param
from repro_torch.models.gnn import common


@dataclasses.dataclass(frozen=True)
class SageConfig:
    d_in: int
    d_hidden: int = 16
    n_classes: int = 41
    n_layers: int = 2
    dropout: float = 0.5


def init(cfg: SageConfig, generator: torch.Generator,
         device: torch.device | str = "cpu",
         dtype: torch.dtype = torch.float32) -> dict:
    """normal(0, 1/sqrt(fan_in)) weights, zero biases, drawn in the
    reference's order (layer by layer: w_self, w_neigh)."""
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    params = {}
    for i in range(cfg.n_layers):
        d_in, d_out = dims[i], dims[i + 1]
        params[f"layer_{i}"] = {
            "w_self": param.normal((d_in, d_out), generator, device, dtype),
            "w_neigh": param.normal((d_in, d_out), generator, device, dtype),
            "b": torch.zeros((d_out,), device=device, dtype=dtype),
        }
    return params


def param_axes(cfg: SageConfig) -> dict:
    """The logical axes of every leaf, as the reference's ``init(...,
    abstract=True)`` records them."""
    return {f"layer_{i}": {"w_self": ("gnn_in", "gnn_hidden"),
                           "w_neigh": ("gnn_in", "gnn_hidden"),
                           "b": ("gnn_hidden",)}
            for i in range(cfg.n_layers)}


def _sage_layer(lp, h_src, h_dst_self, edge_src, edge_dst, n_dst, edge_mask):
    agg = common.scatter_mean(h_src[edge_src.long()], edge_dst, n_dst,
                              edge_mask)
    return h_dst_self @ lp["w_self"] + agg @ lp["w_neigh"] + lp["b"]


def apply_full(params, cfg: SageConfig, x, edge_index, edge_mask=None):
    """x: (N, d_in); edge_index: (2, E) src->dst. Returns (N, n_classes)."""
    n = x.shape[0]
    h = x
    for i in range(cfg.n_layers):
        lp = params[f"layer_{i}"]
        h_new = _sage_layer(lp, h, h, edge_index[0], edge_index[1], n,
                            edge_mask)
        if i < cfg.n_layers - 1:
            h_new = torch.relu(h_new)
        h = h_new
    return h


def apply_blocks(params, cfg: SageConfig, x_input, blocks):
    """Sampled forward. ``blocks`` is a list of dicts of tensors:
    edge_src, edge_dst, edge_mask, dst_pos. x_input: features of
    blocks[0] src nodes."""
    h = x_input
    for i, blk in enumerate(blocks):
        lp = params[f"layer_{i}"]
        n_dst = blk["dst_pos"].shape[0]
        h_dst_self = h[blk["dst_pos"].long()]
        h_new = _sage_layer(
            lp, h, h_dst_self, blk["edge_src"], blk["edge_dst"], n_dst,
            blk["edge_mask"],
        )
        if i < cfg.n_layers - 1:
            h_new = torch.relu(h_new)
        h = h_new
    return h
