"""GatedGCN (Bresson & Laurent 2017; benchmarking config of Dwivedi 2020).

Port of ``repro/models/gnn/gatedgcn.py``. Assigned config: 16 layers,
d_hidden=70, gated aggregation. Per layer:

  e_ij'  = A h_i + B h_j + C e_ij                     (edge update)
  eta_ij = sigma(e_ij') / (sum_j sigma(e_ij') + eps)   (gates)
  h_i'   = h_i + ReLU(LN(U h_i + sum_j eta_ij * (V h_j)))

LayerNorm replaces BatchNorm, as in the reference. The gates are masked
before both segment sums (``index_add``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import param
from repro_torch.models.gnn import common


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    d_in: int
    d_hidden: int = 70
    n_classes: int = 47
    n_layers: int = 16
    d_edge_in: int = 0  # 0 -> edge features initialized from ones


def init(cfg: GatedGCNConfig, seed: int = 0, device="cuda"):
    """``(params, axes)`` in the reference's tree, drawn on ``device`` from
    a generator seeded with ``seed`` (``device="meta"``: shapes only)."""
    pb = param.builder(seed, device)
    d = cfg.d_hidden
    pb.param("w_in", (cfg.d_in, d), ("gnn_in", "gnn_hidden"))
    pb.param("b_in", (d,), ("gnn_hidden",), init="zeros")
    d_e = max(cfg.d_edge_in, 1)
    pb.param("w_edge_in", (d_e, d), ("gnn_in", "gnn_hidden"))
    for i in range(cfg.n_layers):
        layer = pb.scope(f"layer_{i}")
        for name in ("A", "B", "C", "U", "V"):
            layer.param(f"w_{name}", (d, d), ("gnn_hidden", "gnn_hidden"))
        layer.param("b_e", (d,), ("gnn_hidden",), init="zeros")
        layer.param("b_h", (d,), ("gnn_hidden",), init="zeros")
        layer.param("ln_h_g", (d,), ("gnn_hidden",), init="ones")
        layer.param("ln_h_b", (d,), ("gnn_hidden",), init="zeros")
        layer.param("ln_e_g", (d,), ("gnn_hidden",), init="ones")
        layer.param("ln_e_b", (d,), ("gnn_hidden",), init="zeros")
    pb.param("w_out", (d, cfg.n_classes), ("gnn_hidden", "classes"))
    pb.param("b_out", (cfg.n_classes,), ("classes",), init="zeros")
    return pb.params, pb.axes


def apply_full(params, cfg: GatedGCNConfig, x, edge_index, edge_feat=None,
               edge_mask=None):
    n = x.shape[0]
    src, dst = edge_index[0].long(), edge_index[1].long()
    h = x @ params["w_in"] + params["b_in"]
    if edge_feat is None:
        edge_feat = torch.ones((src.shape[0], 1), dtype=h.dtype,
                               device=h.device)
    e = edge_feat @ params["w_edge_in"]

    for i in range(cfg.n_layers):
        lp = params[f"layer_{i}"]
        h_src = h.index_select(0, src)
        e_new = (h.index_select(0, dst) @ lp["w_A"] + h_src @ lp["w_B"]
                 + e @ lp["w_C"] + lp["b_e"])
        gate = torch.sigmoid(e_new)
        if edge_mask is not None:
            gate = torch.where(edge_mask[:, None], gate, 0.0)
        denom = common.scatter_sum(gate, dst, n) + 1e-6
        msg = gate * (h_src @ lp["w_V"])
        agg = common.scatter_sum(msg, dst, n) / denom
        h_new = h @ lp["w_U"] + agg + lp["b_h"]
        h = h + torch.relu(
            common.layer_norm(h_new, lp["ln_h_g"], lp["ln_h_b"])
        )
        e = e + torch.relu(
            common.layer_norm(e_new, lp["ln_e_g"], lp["ln_e_b"])
        )
    return h @ params["w_out"] + params["b_out"]
