"""NequIP (Batzner et al. 2021) — E(3)-equivariant interatomic potential.

Port of ``repro/models/gnn/nequip.py``. Assigned config: 5 layers, hidden
multiplicity 32, l_max=2, 8 Bessel RBFs, cutoff 5 A. Each interaction
layer:

  m_ij = TP(h_j, Y(r_hat_ij); R(r_ij))    (CG tensor product, radial weights)
  A_i  = sum_j m_ij                        (scatter over edges)
  h_i' = Linear(h_i) + Gate(Linear(A_i))   (self-connection + gated update)

Energy readout: per-atom scalar head on l=0 features, summed per graph.
``edge_basis`` and ``readout`` are shared with MACE.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models import param
from repro_torch.models.gnn import common, irreps


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    n_species: int = 8
    d_hidden: int = 32     # multiplicity per irrep
    n_layers: int = 5
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    radial_hidden: int = 64
    edge_chunk: int = 0   # >0: loop over edge blocks (huge-graph shapes)


def _ls(cfg) -> list[int]:
    return list(range(cfg.l_max + 1))


def init(cfg: NequIPConfig, seed: int = 0, device="cuda"):
    """``(params, axes)`` in the reference's tree, drawn on ``device`` from
    a generator seeded with ``seed`` (``device="meta"``: shapes only)."""
    pb = param.builder(seed, device)
    mul = cfg.d_hidden
    pb.param("embed", (cfg.n_species, mul), ("vocab", "gnn_hidden"),
             init="embedding", scale=1.0)
    paths = irreps.tp_paths(_ls(cfg), _ls(cfg), cfg.l_max)
    for i in range(cfg.n_layers):
        layer = pb.scope(f"layer_{i}")
        # radial MLP: rbf -> hidden -> one weight per (path, channel)
        layer.param("rad_w1", (cfg.n_rbf, cfg.radial_hidden),
                    ("gnn_in", "gnn_hidden"))
        layer.param("rad_b1", (cfg.radial_hidden,), ("gnn_hidden",),
                    init="zeros")
        layer.param("rad_w2", (cfg.radial_hidden, len(paths) * mul),
                    ("gnn_hidden", "gnn_in"))
        # per-l linear mixes (message and self-connection)
        lin_msg = layer.scope("lin_msg")
        lin_self = layer.scope("lin_self")
        for l in _ls(cfg):
            lin_msg.param(str(l), (mul, mul), ("gnn_hidden", "gnn_hidden"),
                          scale=1.0 / math.sqrt(mul))
            lin_self.param(str(l), (mul, mul), ("gnn_hidden", "gnn_hidden"),
                           scale=1.0 / math.sqrt(mul))
        # gate scalars for l>0 irreps
        layer.param("gate_w", (mul, mul * cfg.l_max),
                    ("gnn_hidden", "gnn_hidden"))
        layer.param("gate_b", (mul * cfg.l_max,), ("gnn_hidden",),
                    init="zeros")
    pb.param("out_w1", (mul, mul), ("gnn_hidden", "gnn_hidden"))
    pb.param("out_b1", (mul,), ("gnn_hidden",), init="zeros")
    pb.param("out_w2", (mul, 1), ("gnn_hidden", "classes"))
    return pb.params, pb.axes


def edge_basis(cfg, positions, src, dst, edge_mask):
    """The edges' spherical harmonics and their enveloped (masked) radial
    basis."""
    rel = positions.index_select(0, src) - positions.index_select(0, dst)
    r = torch.sqrt(torch.sum(rel**2, dim=-1) + 1e-9)
    sh = irreps.spherical_harmonics(rel, cfg.l_max)
    rbf = irreps.bessel_basis(r, cfg.n_rbf, cfg.cutoff)
    envelope = irreps.cosine_cutoff(r, cfg.cutoff)
    if edge_mask is not None:
        envelope = envelope * edge_mask.to(envelope.dtype)
    return sh, rbf * envelope[:, None]


def initial_features(params, cfg, species, dtype) -> dict:
    """l=0: the species embedding; l>0: zeros."""
    n, mul = species.shape[0], cfg.d_hidden
    h = {0: params["embed"].index_select(0, species.long())[:, :, None]}
    for l in _ls(cfg)[1:]:
        h[l] = torch.zeros((n, mul, 2 * l + 1), dtype=dtype,
                           device=species.device)
    return h


def radial_fn(lp, n_paths: int, mul: int):
    """The layer's radial MLP: rbf (E_b, n_rbf) -> (E_b, n_paths, mul)."""
    def rad_fn(rbf_b):
        r = F.silu(rbf_b @ lp["rad_w1"] + lp["rad_b1"]) @ lp["rad_w2"]
        return r.reshape(r.shape[0], n_paths, mul)
    return rad_fn


def readout(params, h, graph_id, n_graphs: int):
    """Per-atom energies from the l=0 features, summed over all atoms
    (``graph_id`` None) or per graph."""
    scalar = h[0][..., 0]
    atom_e = F.silu(scalar @ params["out_w1"] + params["out_b1"])
    atom_e = atom_e @ params["out_w2"]  # (N, 1)
    if graph_id is None:
        return torch.sum(atom_e, dim=0)
    return common.scatter_sum(atom_e[:, 0], graph_id, n_graphs)


def apply(params, cfg: NequIPConfig, species, positions, edge_index,
          edge_mask=None, graph_id=None, n_graphs: int = 1):
    """Returns per-graph energies (n_graphs,)."""
    n = species.shape[0]
    src, dst = edge_index[0].long(), edge_index[1].long()
    sh, rbf = edge_basis(cfg, positions, src, dst, edge_mask)

    mul = cfg.d_hidden
    ls = _ls(cfg)
    paths = irreps.tp_paths(ls, ls, cfg.l_max)
    h = initial_features(params, cfg, species, rbf.dtype)

    for i in range(cfg.n_layers):
        lp = params[f"layer_{i}"]
        agg = irreps.aggregate_tp_messages(
            h, src, dst, sh, rbf, radial_fn(lp, len(paths), mul), paths,
            cfg.l_max, n, mul, edge_mask, cfg.edge_chunk,
        )
        agg = irreps.irreps_linear(lp["lin_msg"], agg)
        self_conn = irreps.irreps_linear(lp["lin_self"], h)
        mixed = {l: self_conn[l] + agg.get(l, 0.0) for l in ls}
        gates = mixed[0][..., 0] @ lp["gate_w"] + lp["gate_b"]
        h = irreps.irreps_gate(mixed, gates)
    return readout(params, h, graph_id, n_graphs)
