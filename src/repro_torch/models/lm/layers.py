"""Transformer building blocks: RMSNorm, RoPE, SwiGLU.

Port of ``repro/models/lm/layers.py``: RMSNorm computes in float32, casts
back, then multiplies by the weight; RoPE is the half-split form
(``x1, x2 = split(x, 2)``), computed in float32. Over a mesh (x and the
positions DTensors) RoPE's frequencies are replicated onto the
positions' mesh; the rest runs as DTensor ops on the local shards, and
RMSNorm over a split dim (MLA's latent on ``kv_lora``) reduces its mean
of squares across the split before normalising.
SwiGLU over a mesh is Megatron's pair of products on each device's
``mlp`` slice (:func:`swiglu_over_mesh`): its output is a partial sum
over the ``mlp`` mesh dims, and nothing is gathered in either direction.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shlib


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    if shlib.is_dtensor(x32):
        # over a split dim the sum of squares is a partial sum: reduce it
        # here, so the normalisation (and its gradient) keeps x's split
        var = shlib.reduced(x32.square().sum(dim=-1, keepdim=True))
        var = var / x32.shape[-1]
    else:
        var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dtype) * weight


def rope_freqs(d_head: int, theta: float = 10_000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (
        torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
        / d_head
    ))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (..., S)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    if shlib.is_dtensor(positions):
        inv = shlib.replicate_on(inv, positions)
    angles = positions[..., None].float() * inv  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    if shlib.is_dtensor(x):
        return swiglu_over_mesh(x, w_gate, w_up, w_down)
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def swiglu_over_mesh(x, w_gate, w_up, w_down):
    """:func:`swiglu` of DTensors, x (..., D) whole along D, the weights
    as they stand (D whole, ``mlp`` split or not): each device's products
    on its local slices (``local_map``). The output is a partial sum over
    the mesh dims that split ``mlp`` (x's placements elsewhere); the
    gradients are partial sums where the other operand is split (x's
    over ``mlp``'s dims, the weights' over x's)."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    dmesh = x.device_mesh
    mlp = tuple(isinstance(p, Shard) for p in w_gate.placements)
    out_pl = [Partial() if m else p for m, p in zip(mlp, x.placements)]
    x_grad = tuple(out_pl)

    def w_grad(w):
        return tuple(Partial() if isinstance(xp, Shard) else wp
                     for xp, wp in zip(x.placements, w.placements))

    def body(x, wg, wu, wd):
        return (F.silu(x @ wg) * (x @ wu)) @ wd

    return local_map(
        body, out_placements=out_pl,
        in_placements=(tuple(x.placements), tuple(w_gate.placements),
                       tuple(w_up.placements), tuple(w_down.placements)),
        in_grad_placements=(x_grad, w_grad(w_gate), w_grad(w_up),
                            w_grad(w_down)),
        device_mesh=dmesh)(x, w_gate, w_up, w_down)
