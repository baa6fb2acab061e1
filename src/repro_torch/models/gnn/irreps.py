"""O(3) irrep algebra: real spherical harmonics + Clebsch-Gordan products.

Port of ``repro/models/gnn/irreps.py``. Conventions match e3nn:
  * real spherical harmonics in m = -l..l order; the l=1 basis is (y, z, x),
  * component normalization (||Y_l(r_hat)||^2 = 2l+1),
  * real CG coefficients obtained from the complex su(2) coefficients via the
    real<->complex change of basis with the (-i)^l phase, which makes them
    purely real.

The CG coefficients (``_su2_cg``, ``_real_to_complex``, ``clebsch_gordan``)
are a copy of the reference's numpy code, so the tensors are bit-equal to
the reference's; each is put on a device once (``cg_tensor``), not copied
from the host on every call. Features are dicts {l: (..., mul, 2l+1)}.

The per-edge product ``"eui,ej,ijk,eu->euk"`` is computed in the order
(Y·C) first: ``ej,ijk->eik`` (an (E, 2l1+1, 2l3+1) temporary), then a
batched product with the features, ``eui,eik->euk``, then the per-channel
weight. Left to right it would make an (E, mul, 2l1+1, 2l2+1) temporary.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.gnn import common


# ----------------------------------------------------------------- complex CG
def _su2_cg(j1: float, j2: float, j3: float, m1: float, m2: float, m3: float) -> float:
    """Clebsch-Gordan <j1 m1 j2 m2 | j3 m3> (Racah formula, exact floats)."""
    if m3 != m1 + m2:
        return 0.0
    vmin = int(max(-j1 + j2 + m3, -j1 + m1, 0))
    vmax = int(min(j2 + j3 + m1, j3 - j1 + j2, j3 + m3))
    fact = math.factorial

    def f(n: float) -> int:
        assert n == round(n)
        return fact(round(n))

    C = (
        (2.0 * j3 + 1.0)
        * (
            f(j3 + j1 - j2) * f(j3 - j1 + j2) * f(j1 + j2 - j3)
            * f(j3 + m3) * f(j3 - m3)
        )
        / (
            f(j1 + j2 + j3 + 1) * f(j1 - m1) * f(j1 + m1)
            * f(j2 - m2) * f(j2 + m2)
        )
    ) ** 0.5
    S = 0.0
    for v in range(vmin, vmax + 1):
        S += (-1.0) ** (v + j2 + m2) * (
            f(j2 + j3 + m1 - v) * f(j1 - m1 + v)
        ) / (
            f(v) * f(j3 - j1 + j2 - v) * f(j3 + m3 - v) * f(v + j1 - j2 - m3)
        )
    return float(C * S)


@lru_cache(maxsize=None)
def _real_to_complex(l: int) -> np.ndarray:
    """Change of basis: complex SH = Q @ real SH (e3nn convention)."""
    q = np.zeros((2 * l + 1, 2 * l + 1), complex)
    for m in range(-l, 0):
        q[l + m, l + abs(m)] = 1 / np.sqrt(2)
        q[l + m, l - abs(m)] = -1j / np.sqrt(2)
    q[l, l] = 1.0
    for m in range(1, l + 1):
        q[l + m, l + abs(m)] = (-1) ** m / np.sqrt(2)
        q[l + m, l - abs(m)] = 1j * (-1) ** m / np.sqrt(2)
    return (-1j) ** l * q


@lru_cache(maxsize=None)
def clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real CG tensor C[m1, m2, m3]; zero unless |l1-l2| <= l3 <= l1+l2."""
    C = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return C
    Cc = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1), complex)
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) <= l3:
                Cc[l1 + m1, l2 + m2, l3 + m3] = _su2_cg(l1, l2, l3, m1, m2, m3)
    Q1, Q2, Q3 = _real_to_complex(l1), _real_to_complex(l2), _real_to_complex(l3)
    Cr = np.einsum("ij,kl,mn,ikm->jln", Q1, Q2, np.conj(Q3), Cc)
    assert np.abs(Cr.imag).max() < 1e-10
    return np.ascontiguousarray(Cr.real)


@lru_cache(maxsize=None)
def cg_tensor(l1: int, l2: int, l3: int, device: torch.device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``clebsch_gordan(l1, l2, l3)`` on ``device``, made once per (l1, l2,
    l3, device, dtype). Callers must not write to it."""
    return torch.as_tensor(clebsch_gordan(l1, l2, l3)).to(device=device,
                                                         dtype=dtype)


# ------------------------------------------------------- spherical harmonics
def spherical_harmonics(vectors, l_max: int):
    """Component-normalized real SH of unit-normalized ``vectors`` (..., 3).

    Returns {l: (..., 2l+1)}. l=1 returns sqrt(3)*(y, z, x) per e3nn.
    """
    eps = 1e-9
    norm = torch.sqrt(torch.sum(vectors**2, dim=-1, keepdim=True) + eps)
    v = vectors / norm
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    out = {0: torch.ones(v.shape[:-1] + (1,), dtype=v.dtype,
                         device=v.device)}
    if l_max >= 1:
        out[1] = math.sqrt(3.0) * torch.stack([y, z, x], dim=-1)
    if l_max >= 2:
        s15, s5 = math.sqrt(15.0), math.sqrt(5.0)
        out[2] = torch.stack(
            [
                s15 * x * y,
                s15 * y * z,
                s5 * 0.5 * (3 * z * z - 1.0),
                s15 * x * z,
                s15 * 0.5 * (x * x - y * y),
            ],
            dim=-1,
        )
    if l_max >= 3:
        raise NotImplementedError("l_max <= 2 supported")
    return out


# ---------------------------------------------------------- irrep operations
def irreps_linear(params_w: dict, feats: dict) -> dict:
    """Per-l linear mixing over multiplicity channels (equivariant)."""
    return {
        l: torch.einsum("...ui,uv->...vi", f, params_w[str(l)])
        for l, f in feats.items()
    }


def tensor_product(
    feats: dict, sh: dict, weights: dict, l_max: int
) -> dict:
    """Weighted CG tensor product TP(h, Y) -> irreps up to l_max.

    feats: {l1: (E, mul, 2l1+1)}; sh: {l2: (E, 2l2+1)};
    weights: {"l1_l2_l3": (E, mul)} per-edge per-channel path weights
    (from the radial MLP). Output {l3: (E, mul, 2l3+1)} summing all paths.
    """
    out: dict[int, torch.Tensor] = {}
    for l1, f in feats.items():
        for l2, y in sh.items():
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                cg = cg_tensor(l1, l2, l3, f.device, f.dtype)
                w = weights[f"{l1}_{l2}_{l3}"]
                yc = torch.einsum("ej,ijk->eik", y, cg)
                term = torch.bmm(f, yc) * w[..., None]
                out[l3] = out.get(l3, 0.0) + term
    return out


def tp_paths(l_in: list[int], l_sh: list[int], l_max: int) -> list[str]:
    paths = []
    for l1 in l_in:
        for l2 in l_sh:
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                paths.append(f"{l1}_{l2}_{l3}")
    return paths


def aggregate_tp_messages(
    h: dict,
    src: torch.Tensor,
    dst: torch.Tensor,
    sh: dict,
    rbf: torch.Tensor,
    rad_fn,
    paths: list[str],
    l_max: int,
    n_nodes: int,
    mul: int,
    edge_mask: torch.Tensor | None = None,
    edge_chunk: int = 0,
) -> dict:
    """A_i = sum_j TP(h_j, Y(r_ij); R(r_ij)) with optional edge chunking.

    edge_chunk > 0 loops over edge blocks in order, each block under
    non-reentrant ``torch.utils.checkpoint`` (the reference's ``lax.scan``
    of ``jax.checkpoint(block)``): the backward recomputes a block's
    per-edge messages instead of storing every block's, so only the
    node-level accumulator, summed in block order, is kept.
    ``rad_fn(rbf_block) -> (E_b, n_paths, mul)`` is the radial MLP.
    """
    ls = sorted(h)
    sh_ls = sorted(sh)

    def block(src_b, dst_b, rbf_b, mask_b, *sh_b):
        rad = rad_fn(rbf_b)
        weights = {p: rad[:, j, :] for j, p in enumerate(paths)}
        h_src = {l: h[l].index_select(0, src_b) for l in ls}
        msg = tensor_product(h_src, dict(zip(sh_ls, sh_b)), weights, l_max)
        return {
            l: common.scatter_sum(
                m.reshape(m.shape[0], -1), dst_b, n_nodes, mask_b
            ).reshape(n_nodes, mul, 2 * l + 1)
            for l, m in msg.items()
        }

    src, dst = src.long(), dst.long()
    sh_all = tuple(sh[l] for l in sh_ls)
    if edge_chunk <= 0 or src.shape[0] <= edge_chunk:
        return block(src, dst, rbf, edge_mask, *sh_all)

    e = src.shape[0]
    assert e % edge_chunk == 0, (e, edge_chunk)
    mask = (edge_mask if edge_mask is not None
            else torch.ones(e, dtype=torch.bool, device=src.device))
    acc = {
        l: torch.zeros((n_nodes, mul, 2 * l + 1), dtype=rbf.dtype,
                       device=rbf.device)
        for l in range(l_max + 1)
    }
    for start in range(0, e, edge_chunk):
        cut = slice(start, start + edge_chunk)
        out = checkpoint(block, src[cut], dst[cut], rbf[cut], mask[cut],
                         *(y[cut] for y in sh_all), use_reentrant=False)
        acc = {l: acc[l] + out[l] if l in out else acc[l] for l in acc}
    return acc


def irreps_gate(feats: dict, gate_scalars: torch.Tensor) -> dict:
    """Gated nonlinearity: l=0 -> silu; l>0 scaled by sigmoid(gate)."""
    out = {}
    g_idx = 0
    for l in sorted(feats):
        f = feats[l]
        if l == 0:
            out[l] = F.silu(f)
        else:
            mul = f.shape[-2]
            g = torch.sigmoid(gate_scalars[..., g_idx : g_idx + mul])
            out[l] = f * g[..., None]
            g_idx += mul
    return out


def irreps_norm_sq(feats: dict) -> torch.Tensor:
    """Rotation-invariant per-channel squared norms, concatenated."""
    parts = [torch.sum(f**2, dim=-1) for l, f in sorted(feats.items())]
    return torch.cat(parts, dim=-1)


def bessel_basis(r, n_rbf: int, cutoff: float):
    """Bessel radial basis (NequIP/DimeNet): sin(n pi r / rc) / r."""
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    r_ = torch.clamp(r[..., None], min=1e-9)
    return (
        math.sqrt(2.0 / cutoff)
        * torch.sin(n * math.pi * r_ / cutoff)
        / r_
    )


def cosine_cutoff(r, cutoff: float):
    """Smooth envelope that -> 0 at r = cutoff."""
    return torch.where(
        r < cutoff, 0.5 * (torch.cos(math.pi * r / cutoff) + 1.0), 0.0
    )
