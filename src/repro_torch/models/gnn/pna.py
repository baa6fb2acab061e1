"""PNA — Principal Neighbourhood Aggregation (Corso et al. 2020).

Port of ``repro/models/gnn/pna.py``. Assigned config: 4 layers,
d_hidden=75, aggregators mean/max/min/std, scalers
identity/amplification/attenuation. Each layer:

  m_ij   = M(h_i, h_j)                      (pre-transform MLP on src||dst)
  agg    = [mean, max, min, std] of m_ij    (4 aggregators)
  scaled = [1, log(d+1)/delta, delta/log(d+1)] x agg  (3 scalers -> 12 blocks)
  h_i'   = U(h_i || scaled)                 (post-transform) + residual

The aggregators are ``common``'s ``index_add`` and ``scatter_reduce``
passes over per-edge messages, as the reference's are XLA segment ops.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import param
from repro_torch.models.gnn import common

AGGREGATORS = ("mean", "max", "min", "std")
N_SCALERS = 3


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    d_in: int
    d_hidden: int = 75
    n_classes: int = 47
    n_layers: int = 4
    delta: float = 2.5  # mean log-degree of the training graphs


def init(cfg: PNAConfig, seed: int = 0, device="cuda"):
    """``(params, axes)`` in the reference's tree, drawn on ``device`` from
    a generator seeded with ``seed`` (``device="meta"``: shapes only)."""
    pb = param.builder(seed, device)
    pb.param("w_in", (cfg.d_in, cfg.d_hidden), ("gnn_in", "gnn_hidden"))
    pb.param("b_in", (cfg.d_hidden,), ("gnn_hidden",), init="zeros")
    d = cfg.d_hidden
    n_agg_out = len(AGGREGATORS) * N_SCALERS * d
    for i in range(cfg.n_layers):
        layer = pb.scope(f"layer_{i}")
        layer.param("w_msg_src", (d, d), ("gnn_hidden", "gnn_hidden"))
        layer.param("w_msg_dst", (d, d), ("gnn_hidden", "gnn_hidden"))
        layer.param("b_msg", (d,), ("gnn_hidden",), init="zeros")
        layer.param("w_upd", (d + n_agg_out, d), ("gnn_in", "gnn_hidden"))
        layer.param("b_upd", (d,), ("gnn_hidden",), init="zeros")
        layer.param("ln_g", (d,), ("gnn_hidden",), init="ones")
        layer.param("ln_b", (d,), ("gnn_hidden",), init="zeros")
    pb.param("w_out", (d, cfg.n_classes), ("gnn_hidden", "classes"))
    pb.param("b_out", (cfg.n_classes,), ("classes",), init="zeros")
    return pb.params, pb.axes


def apply_full(params, cfg: PNAConfig, x, edge_index, edge_mask=None):
    n = x.shape[0]
    src, dst = edge_index[0].long(), edge_index[1].long()
    h = x @ params["w_in"] + params["b_in"]
    deg = common.in_degrees(dst, n, edge_mask)
    log_deg = torch.log(deg + 1.0)
    amp = (log_deg / cfg.delta)[:, None]
    att = (cfg.delta / torch.clamp(log_deg, min=1e-2))[:, None]

    for i in range(cfg.n_layers):
        lp = params[f"layer_{i}"]
        msg = torch.relu(
            h.index_select(0, src) @ lp["w_msg_src"]
            + h.index_select(0, dst) @ lp["w_msg_dst"] + lp["b_msg"]
        )
        aggs = [
            common.scatter_mean(msg, dst, n, edge_mask),
            common.scatter_max(msg, dst, n, edge_mask),
            common.scatter_min(msg, dst, n, edge_mask),
            common.scatter_std(msg, dst, n, edge_mask),
        ]
        scaled = []
        for a in aggs:
            scaled.extend([a, a * amp, a * att])
        z = torch.cat([h] + scaled, dim=-1)
        upd = z @ lp["w_upd"] + lp["b_upd"]
        h = h + common.layer_norm(torch.relu(upd), lp["ln_g"], lp["ln_b"])
    return h @ params["w_out"] + params["b_out"]
