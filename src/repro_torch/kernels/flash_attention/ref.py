"""Dense-softmax oracle for flash attention (BH, S, D layout).

A copy of ``repro/kernels/flash_attention/ref.py::attention_ref``."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, causal: bool = True):
    """q,k,v: (BH, S, D). fp32 softmax. Returns (BH, Sq, D)."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q, k).float() / math.sqrt(d)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", p, v)
