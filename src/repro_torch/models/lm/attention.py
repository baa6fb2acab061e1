"""Attention: GQA with dense and blockwise (flash) paths and KV-cache
decode. All paths keep softmax statistics in float32.

Port of ``repro/models/lm/attention.py``. ``dense_attention`` and
``decode_attention`` stay plain torch, as the reference leaves them to
XLA. ``blockwise_attention``, which the reference writes as an XLA scan
over KV blocks ("the XLA analogue of kernels/flash_attention"), goes
through the port's flash-attention wrapper: the hand-written CUDA kernel
for CUDA tensors, its plain version for CPU tensors. Its gradient, which
the reference takes by autodiff of the scan, is the wrapper's
``FlashAttention`` Function: the backward kernels for CUDA tensors, the
plain backward for CPU tensors.

One stated divergence: the reference's blockwise path keeps the
accumulator in the activation dtype (bf16 for TinyLlama) and rounds its
scores to it; the port follows the Pallas kernel (float32 scores, running
max, sum and accumulator). At float32 the two agree to 2e-5/1e-4; at bf16
they differ by bf16 rounding (ROADMAP.md queue 3).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.flash_attention import flash_attention

NEG_INF = -1e30


@functools.lru_cache(maxsize=None)
def _scale(d: int, dtype: torch.dtype) -> torch.Tensor:
    """sqrt(d) in float32 cast to ``dtype``, as ``jnp.sqrt(d).astype``: a
    0-dim CPU tensor, which a CUDA op reads as a scalar (no copy, no
    sync). Made once per (d, dtype) and only ever read."""
    return torch.tensor(float(d), dtype=torch.float32).sqrt().to(dtype)


def _gqa_scores(q, k):
    """q: (B,Sq,Hq,D), k: (B,Sk,Hkv,D) -> (B,Hkv,G,Sq,Sk)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    return torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / _scale(d, q.dtype)


def dense_attention(q, k, v, causal: bool = True, q_offset: int = 0):
    """Reference path (small S). Returns (B,Sq,Hq,Dv)."""
    b, sq, hq, _ = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    scores = _gqa_scores(q, k).float()
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, dv)


def blockwise_attention(q, k, v, causal: bool = True, block_k: int = 1024):
    """Online-softmax attention over KV blocks: the flash-attention
    kernel, differentiable through its backward kernels. Memory: O(Sq * D)
    running state instead of O(Sq * Sk)."""
    sq, sk = q.shape[1], k.shape[1]
    assert sk % block_k == 0, (sk, block_k)
    # the plain version's q tile (the reference scans all of q at once;
    # the CUDA kernel runs its own tiles)
    block_q = 128 if sq % 128 == 0 else sq
    return flash_attention(q, k, v, causal=causal, block_q=block_q,
                           block_k=block_k)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token decode: q (B,1,Hq,D) against cache (B,Smax,Hkv,D);
    positions >= cache_len (a (B,) tensor) are masked out."""
    b, _, hq, d = q.shape
    smax, hkv, dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[-1]
    qg = q.reshape(b, hkv, hq // hkv, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).float()
    s = s / _scale(d, torch.float32)
    valid = (torch.arange(smax, device=q.device)[None]
             < cache_len[:, None])  # (B, Smax)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache)
    return out.reshape(b, 1, hq, dv)
