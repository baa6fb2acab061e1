"""MACE (Batatia et al. 2022) — higher-order equivariant message passing.

Port of ``repro/models/gnn/mace.py``. Assigned config: 2 layers, hidden
multiplicity 128, l_max=2, correlation order 3, 8 RBFs, E(3)-ACE product
basis. Per layer:

  A_i  = sum_j TP(h_j, Y(r_hat_ij); R(r_ij))        (order-1 atomic basis)
  B_i  = [A, (A (x) A)_lmax, ((A (x) A) (x) A)_lmax]  (symmetric products,
         correlation order up to 3, contracted back to irreps <= l_max)
  m_i  = Linear(concat_nu B_i^(nu))                  (learnable coupling)
  h_i' = Linear(h_i) + Gate(m_i)

The channel-wise product ``"nui,nuj,ijk->nuk"`` is computed as the outer
product (N, mul, 2l1+1, 2l2+1) flattened against C reshaped to
(2l1+1)(2l2+1) x (2l3+1): one matrix product a path.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import param
from repro_torch.models.gnn import irreps, nequip


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    n_species: int = 8
    d_hidden: int = 128
    n_layers: int = 2
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0
    radial_hidden: int = 64
    edge_chunk: int = 0   # >0: loop over edge blocks (huge-graph shapes)


def _ls(cfg) -> list[int]:
    return list(range(cfg.l_max + 1))


def _unweighted_tp(a: dict, b: dict, l_max: int) -> dict:
    """CG product of two irrep dicts {l: (N, mul, 2l+1)} (channel-wise)."""
    out: dict[int, torch.Tensor] = {}
    for l1, f1 in a.items():
        for l2, f2 in b.items():
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                cg = irreps.cg_tensor(l1, l2, l3, f1.device, f1.dtype)
                outer = f1[..., :, None] * f2[..., None, :]
                term = outer.flatten(-2) @ cg.reshape(-1, cg.shape[-1])
                out[l3] = out.get(l3, 0.0) + term
    return out


def init(cfg: MACEConfig, seed: int = 0, device="cuda"):
    """``(params, axes)`` in the reference's tree, drawn on ``device`` from
    a generator seeded with ``seed`` (``device="meta"``: shapes only)."""
    pb = param.builder(seed, device)
    mul = cfg.d_hidden
    ls = _ls(cfg)
    pb.param("embed", (cfg.n_species, mul), ("vocab", "gnn_hidden"),
             init="embedding", scale=1.0)
    paths = irreps.tp_paths(ls, ls, cfg.l_max)
    for i in range(cfg.n_layers):
        layer = pb.scope(f"layer_{i}")
        layer.param("rad_w1", (cfg.n_rbf, cfg.radial_hidden),
                    ("gnn_in", "gnn_hidden"))
        layer.param("rad_b1", (cfg.radial_hidden,), ("gnn_hidden",),
                    init="zeros")
        layer.param("rad_w2", (cfg.radial_hidden, len(paths) * mul),
                    ("gnn_hidden", "gnn_in"))
        # product-basis coupling: one linear mix per correlation order per l
        for nu in range(1, cfg.correlation + 1):
            mix = layer.scope(f"prod_mix_{nu}")
            for l in ls:
                mix.param(str(l), (mul, mul), ("gnn_hidden", "gnn_hidden"),
                          scale=1.0 / math.sqrt(mul))
        lin_self = layer.scope("lin_self")
        for l in ls:
            lin_self.param(str(l), (mul, mul), ("gnn_hidden", "gnn_hidden"),
                           scale=1.0 / math.sqrt(mul))
        layer.param("gate_w", (mul, mul * cfg.l_max),
                    ("gnn_hidden", "gnn_hidden"))
        layer.param("gate_b", (mul * cfg.l_max,), ("gnn_hidden",),
                    init="zeros")
    pb.param("out_w1", (mul, mul), ("gnn_hidden", "gnn_hidden"))
    pb.param("out_b1", (mul,), ("gnn_hidden",), init="zeros")
    pb.param("out_w2", (mul, 1), ("gnn_hidden", "classes"))
    return pb.params, pb.axes


def apply(params, cfg: MACEConfig, species, positions, edge_index,
          edge_mask=None, graph_id=None, n_graphs: int = 1):
    """Returns per-graph energies (n_graphs,)."""
    n = species.shape[0]
    src, dst = edge_index[0].long(), edge_index[1].long()
    sh, rbf = nequip.edge_basis(cfg, positions, src, dst, edge_mask)

    mul = cfg.d_hidden
    ls = _ls(cfg)
    paths = irreps.tp_paths(ls, ls, cfg.l_max)
    h = nequip.initial_features(params, cfg, species, rbf.dtype)

    for i in range(cfg.n_layers):
        lp = params[f"layer_{i}"]
        A = irreps.aggregate_tp_messages(
            h, src, dst, sh, rbf, nequip.radial_fn(lp, len(paths), mul),
            paths, cfg.l_max, n, mul, edge_mask, cfg.edge_chunk,
        )
        # --- ACE product basis: symmetric powers up to correlation order ---
        powers = [A]
        for _ in range(cfg.correlation - 1):
            powers.append(_unweighted_tp(powers[-1], A, cfg.l_max))
        message = {l: torch.zeros((n, mul, 2 * l + 1), dtype=rbf.dtype,
                                  device=rbf.device) for l in ls}
        for nu, Bnu in enumerate(powers, start=1):
            mixed = irreps.irreps_linear(lp[f"prod_mix_{nu}"], Bnu)
            for l in ls:
                if l in mixed:
                    message[l] = message[l] + mixed[l]
        self_conn = irreps.irreps_linear(lp["lin_self"], h)
        mixed = {l: self_conn[l] + message[l] for l in ls}
        gates = mixed[0][..., 0] @ lp["gate_w"] + lp["gate_b"]
        h = irreps.irreps_gate(mixed, gates)
    return nequip.readout(params, h, graph_id, n_graphs)
