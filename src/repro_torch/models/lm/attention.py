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

Over a mesh (q a DTensor: ``launch.cell`` with a ``DeviceMesh``) each
path runs on every device's own batch rows and heads through
``local_map`` (:func:`over_heads`): q's heads on the rules' ``heads``
axes, k's and v's on ``kv_heads`` or replicated, and a device passes its
kernel only the KV heads its q heads read (TinyLlama at 16 model
devices: 2 q heads, one KV head). The wrappers see plain local tensors,
so the CUDA forward and backward launch on the local heads.
:func:`cached_attention` attends over a cache sharded on ``cache_seq``
by each device's partial softmax over its slice and a max and sum
combine across the ``cache_seq`` mesh dims, never gathering the cache.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.distributed import sharding as shlib
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
    if shlib.is_dtensor(q):
        return over_heads(dense_attention, q, k, v, causal, q_offset)
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
    if shlib.is_dtensor(q):
        return over_heads(blockwise_attention, q, k, v, causal, block_k)
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


# ------------------------------------------------------------- over a mesh
def _head_axes(q, k) -> tuple:
    """The logical axes of q's and of k's (and v's) dims: ``kv_heads``
    for GQA's KV heads, ``heads`` where k has q's heads (MLA)."""
    q_axes = ("batch", "seq", "heads", "head_dim")
    kv = "heads" if k.shape[2] == q.shape[2] else "kv_heads"
    return q_axes, ("batch", "seq", kv, "head_dim")


def over_heads(fn, q, k, v, *args):
    """``fn(q, k, v, *args)`` on DTensors q (B, Sq, Hq, D), k (B, Sk,
    Hkv, D), v (B, Sk, Hkv, Dv), run on each device's local tensors by
    ``local_map``: q at the rules' ``heads`` placements, k and v at
    ``kv_heads``' (replicated where the rules leave KV heads unsharded),
    the output at q's. Where q's heads are sharded and the KV heads are
    not, a device hands ``fn`` only the KV heads of its q heads' groups,
    and the KV heads' gradient is a partial sum over those mesh dims."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    dmesh = q.device_mesh
    rules = shlib.current_rules()
    q_axes, kv_axes = _head_axes(q, k)
    q_pl = shlib.placements_for(shlib.spec_for(q_axes, rules, dmesh), dmesh)
    kv_pl = shlib.placements_for(shlib.spec_for(kv_axes, rules, dmesh),
                                 dmesh)
    hq, hkv = q.shape[2], k.shape[2]
    q_local, q_off = shlib.local_slices(q.shape, q_pl, dmesh)
    kv_local, kv_off = shlib.local_slices(k.shape, kv_pl, dmesh)
    g = hq // hkv
    heads = range(q_off[2], q_off[2] + q_local[2])
    lo = q_off[2] // g - kv_off[2]
    hi = -(-heads.stop // g) - kv_off[2]
    n_kv = hi - lo
    if (lo < 0 or hi > kv_local[2] or q_local[2] % n_kv
            or any(h // g - kv_off[2] - lo != i // (q_local[2] // n_kv)
                   for i, h in enumerate(heads))):
        raise ValueError(f"over_heads: local q heads {heads} do not map "
                         f"onto whole local KV heads ({hq} q, {hkv} KV)")
    sliced = (lo, hi) != (0, kv_local[2])
    # a KV dim that q shards and k does not: each device reads its own
    # slice, so the gradient is a partial sum there
    kv_grad = tuple(Partial() if sliced and p != kp else kp
                    for p, kp in zip(q_pl, kv_pl))

    def body(q, k, v):
        if sliced:
            k, v = k[:, :, lo:hi], v[:, :, lo:hi]
        return fn(q, k, v, *args)

    return local_map(body, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=dmesh, redistribute_inputs=True)(q, k, v)


def reduce_over(t, op: str, dmesh, dims: tuple):
    """``t`` reduced (``"sum"`` or ``"max"``) over the mesh dims ``dims``,
    one after another."""
    import torch.distributed._functional_collectives as funcol

    for d in dims:
        t = funcol.all_reduce(t, op, (dmesh, d))
    return t


def combined_softmax(s, dmesh, dims: tuple):
    """``softmax(s, dim=-1)`` of scores whose last dim is split over the
    mesh dims ``dims``, from this device's slice: the max and the sum of
    exponentials combined across ``dims``. Float32 in, float32 out."""
    if not dims:
        return torch.softmax(s, dim=-1)
    m = reduce_over(s.amax(dim=-1, keepdim=True), "max", dmesh, dims)
    e = torch.exp(s - m)
    return e / reduce_over(e.sum(dim=-1, keepdim=True), "sum", dmesh, dims)


@torch.no_grad()
def cached_attention(q, k_new, v_new, k_cache, v_cache, cache_len: int):
    """A decode step over a mesh: writes k_new, v_new (B, S, Hkv, D) into
    this layer's cache (B, Smax, Hkv, D) at ``cache_len`` and attends q
    (B, S, Hq, D) over it, with DTensors at the rules' placements (the
    cache's ``cache_seq`` dim split over its mesh dims or not). Each
    device attends over its cache slice; the softmax's max and sum and
    the output's sum are combined across the ``cache_seq`` mesh dims
    (:func:`combined_softmax`), as :func:`decode_attention` computes
    them on one device. The cache's slices stay where they are. Returns
    (B, S, Hq, Dv) at q's batch placements, heads as k's."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dmesh = q.device_mesh
    rules = shlib.current_rules()
    c_axes = ("batch", "cache_seq", "kv_heads", "head_dim")
    c_pl = shlib.placements_for(shlib.spec_for(c_axes, rules, dmesh), dmesh)
    seq_dims = shlib.mesh_dims_of("cache_seq", rules, dmesh)
    # q, the new keys and the output follow the cache's batch and KV
    # heads and are whole along the cache's sequence dims
    q_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                 for p in c_pl)
    off = shlib.local_slices(k_cache.shape, c_pl, dmesh)[1][1]

    def body(q, kn, vn, kc, vc):
        b, s, hq_l, d = q.shape
        smax_l, hkv_l, dv = kc.shape[1], kc.shape[2], vc.shape[-1]
        if off <= cache_len and cache_len + s <= off + smax_l:
            kc[:, cache_len - off:cache_len - off + s] = kn.to(kc.dtype)
            vc[:, cache_len - off:cache_len - off + s] = vn.to(vc.dtype)
        qg = q.reshape(b, s, hkv_l, hq_l // hkv_l, d)
        sc = torch.einsum("bshgd,bkhd->bhgsk", qg, kc).float()
        sc = sc / _scale(d, torch.float32)
        pos = torch.arange(off, off + smax_l, device=q.device)
        sc = torch.where(pos < cache_len + s, sc, NEG_INF)
        p = combined_softmax(sc, dmesh, seq_dims).to(vc.dtype)
        out = torch.einsum("bhgsk,bkhd->bshgd", p.float(), vc.float())
        out = reduce_over(out, "sum", dmesh, seq_dims)
        return out.reshape(b, s, hq_l, dv).to(vc.dtype)

    return local_map(body, out_placements=list(q_pl),
                     in_placements=(q_pl, q_pl, q_pl, c_pl, c_pl),
                     device_mesh=dmesh, redistribute_inputs=True)(
        q, k_new, v_new, k_cache, v_cache)
