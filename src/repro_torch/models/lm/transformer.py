"""Decoder-only transformer: the GQA and MLA archs with dense SwiGLU or
DeepSeekMoE layers, for training and serving.

Port of ``repro/models/lm/transformer.py``: ``LMConfig`` (same fields and
defaults), ``init`` (with the leaves' logical axes, ``param_axes``, and
on the ``meta`` device shapes only), ``forward`` (with its ``mode``),
``logits_of``, ``lm_loss``, ``init_cache``, ``cache_specs``, ``prefill``
and ``decode_step``. Sequences of
``S >= blockwise_threshold`` run attention through the flash-attention
kernel (``attention.blockwise_attention``), whose gradient is the
backward kernel; shorter ones through the plain dense path; decode steps
attend over the KV cache. MLA (``attn_type="mla"``, minicpm3) expands its
compressed latent to per-head K and V for prefill and training (q/k head
dim ``d_nope + d_rope``, v head dim ``d_v``: the flash kernels' (96, 64)
instance at minicpm3's widths) and decodes by the absorbed-matrix path
against a latent cache ``{"c": (L, B, Smax, kv_lora), "r": (L, B, Smax,
d_rope)}`` (DeepSeek-V2 Sec. 2.1); deepseek-v2's widths take the (192, 128)
instance. MoE (``cfg.moe``: moonshot, deepseek-v2) replaces the dense FFN
of every stacked layer with ``moe.moe_ffn`` (top-k routed experts) plus
``cfg.n_shared`` shared experts, after ``cfg.first_k_dense`` dense layers
(``params["dense_layer_{i}"]``, unstacked, as the reference keeps them);
a step with a cache routes with no capacity drop (``no_drop``), prefill
and training at ``cfg.capacity_factor``. With ``cfg.remat`` and ``mode="train"`` each
layer is rematerialised (``torch.utils.checkpoint``, non-reentrant: only
the layer's input is kept, its activations are recomputed in the
backward, as ``jax.checkpoint`` with ``nothing_saveable``), and
``lm_loss`` recomputes each chunk's float32 logits in the backward.

What differs from the reference:

- the ``lax.scan`` over layers is a Python loop over the stacked
  ``params["layers"]`` (leading ``(L, ...)`` axis, as ``vmap_init``
  stacks them);
- ``shard_activation`` is the identity on one card; over a mesh (the
  parameters and tokens DTensors, ``launch.cell`` with a ``DeviceMesh``)
  it redistributes at the reference's five sites, each layer gathers its
  weights' FSDP rows first (``sharding.gather_rows``), attention runs on
  the local heads (``attention.over_heads``, ``cached_attention``, the
  MLA cache's :func:`_mla_cached`), and ``lm_loss`` takes its
  log-sum-exp over logits sharded on ``vocab`` from each device's slice;
- the cache keeps the reference's dicts (GQA ``{"k", "v"}: (L, B, Smax,
  Hkv, D)``, MLA ``{"c", "r"}``), but ``decode_step`` writes it in place;
- the stacked layer parameters are split once with ``unbind``, so their
  gradient is one stack of the layers' gradients.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.sharding import shard_activation
from repro_torch.models import param as P
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import moe as moe_lib
from repro_torch.models.lm.layers import apply_rope, rms_norm, swiglu

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
EMBED = ("batch", "seq", "embed")   # the residual stream's logical axes


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    attn_type: str = "gqa"          # "gqa" | "mla"
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    # MLA
    q_lora: int = 0
    kv_lora: int = 0
    d_nope: int = 0
    d_rope: int = 0
    d_v: int = 0
    # numerics / execution
    dtype: str = "float32"
    remat: bool = True
    grad_accum: int = 1               # microbatches per train step
    blockwise_threshold: int = 2048   # use blockwise attention for S >= this
    attn_block_k: int = 1024
    loss_chunk: int = 0               # 0 = unchunked CE
    vocab_pad_to: int = 0             # pad vocab for divisibility (0 = none)

    @property
    def padded_vocab(self) -> int:
        return max(self.vocab, self.vocab_pad_to)

    @property
    def n_scan_layers(self) -> int:
        return self.n_layers - self.first_k_dense

    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def _check_supported(cfg: LMConfig) -> None:
    if cfg.attn_type not in ("gqa", "mla"):
        raise ValueError(cfg.attn_type)


# --------------------------------------------------------------------- init
def _attention_shapes(cfg: LMConfig) -> dict:
    """name -> (per-layer shape, init, logical axes) of the attention's
    parameters, in the reference's ``_init_attention`` order and with its
    axes."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if cfg.attn_type == "gqa":
        shapes = {
            "wq": ((d, h, dh), "normal", ("embed_rows", "heads", "head_dim")),
            "wk": ((d, hkv, dh), "normal",
                   ("embed_rows", "kv_heads", "head_dim")),
            "wv": ((d, hkv, dh), "normal",
                   ("embed_rows", "kv_heads", "head_dim")),
            "wo": ((h, dh, d), "normal", ("heads", "head_dim", "embed_rows")),
        }
        if cfg.qk_norm:
            shapes["q_norm"] = ((dh,), "ones", ("head_dim",))
            shapes["k_norm"] = ((dh,), "ones", ("head_dim",))
        return shapes
    d_qk = cfg.d_nope + cfg.d_rope
    if cfg.q_lora > 0:
        shapes = {
            "w_dq": ((d, cfg.q_lora), "normal", ("embed_rows", "q_lora")),
            "q_norm": ((cfg.q_lora,), "ones", ("q_lora",)),
            "w_uq": ((cfg.q_lora, h, d_qk), "normal",
                     ("q_lora", "heads", "head_dim")),
        }
    else:
        shapes = {"w_q": ((d, h, d_qk), "normal",
                          ("embed_rows", "heads", "head_dim"))}
    shapes.update({
        "w_dkv": ((d, cfg.kv_lora), "normal", ("embed_rows", "kv_lora")),
        "kv_norm": ((cfg.kv_lora,), "ones", ("kv_lora",)),
        "w_uk": ((cfg.kv_lora, h, cfg.d_nope), "normal",
                 ("kv_lora", "heads", "head_dim")),
        "w_uv": ((cfg.kv_lora, h, cfg.d_v), "normal",
                 ("kv_lora", "heads", "head_dim")),
        "w_kr": ((d, cfg.d_rope), "normal", ("embed_rows", "head_dim")),
        "wo": ((h, cfg.d_v, d), "normal", ("heads", "head_dim", "embed_rows")),
    })
    return shapes


def _layer_shapes(cfg: LMConfig, use_moe: bool) -> dict:
    """name -> (per-layer shape, init, logical axes), in
    ``_init_layer``'s order: a dense SwiGLU layer at ``d_ff``, or
    (``use_moe``) the router, the expert stacks and the shared experts.
    The expert stacks' fan-in is their first dim, E, as the reference's
    ``ParamBuilder`` takes it."""
    d = cfg.d_model
    shapes = {
        "ln_attn": ((d,), "ones", ("embed",)),
        "ln_ffn": ((d,), "ones", ("embed",)),
        **_attention_shapes(cfg),
    }
    if use_moe:
        e, f = cfg.n_experts, cfg.d_ff_expert
        shapes["router"] = ((d, e), "normal", ("embed", "experts"))
        shapes["w_gate"] = ((e, d, f), "normal",
                            ("experts", "embed_rows", "mlp"))
        shapes["w_up"] = ((e, d, f), "normal",
                          ("experts", "embed_rows", "mlp"))
        shapes["w_down"] = ((e, f, d), "normal",
                            ("experts", "mlp", "embed_rows"))
        if cfg.n_shared > 0:
            d_sh = cfg.n_shared * f
            shapes["ws_gate"] = ((d, d_sh), "normal", ("embed_rows", "mlp"))
            shapes["ws_up"] = ((d, d_sh), "normal", ("embed_rows", "mlp"))
            shapes["ws_down"] = ((d_sh, d), "normal", ("mlp", "embed_rows"))
        return shapes
    shapes["w_gate"] = ((d, cfg.d_ff), "normal", ("embed_rows", "mlp"))
    shapes["w_up"] = ((d, cfg.d_ff), "normal", ("embed_rows", "mlp"))
    shapes["w_down"] = ((cfg.d_ff, d), "normal", ("mlp", "embed_rows"))
    return shapes


def param_axes(cfg: LMConfig) -> dict:
    """The logical axes of every leaf, as the reference's ``init(key,
    cfg, abstract=True)`` returns them: the stacked layers' leaves carry
    ``vmap_init``'s leading ``"layers"`` axis."""
    _check_supported(cfg)
    axes = {"embed": ("vocab", "embed_rows"),
            "lm_head": ("embed_rows", "vocab"),
            "final_norm": ("embed",)}
    for i in range(cfg.first_k_dense):
        axes[f"dense_layer_{i}"] = {
            name: a for name, (_, _, a) in _layer_shapes(cfg, False).items()}
    if cfg.n_scan_layers > 0:
        axes["layers"] = {
            name: ("layers",) + a
            for name, (_, _, a) in _layer_shapes(cfg, cfg.moe).items()}
    return axes


def param_inits(cfg: LMConfig) -> dict:
    """Each leaf's initialiser (``"normal"``, ``"embedding"``, ``"ones"``)
    and fan-in, in :func:`param_axes`' tree: what drawing a shard of the
    leaf needs (``launch.cell`` over a mesh draws each device's own)."""
    _check_supported(cfg)
    v, d = cfg.padded_vocab, cfg.d_model
    out = {"embed": ("embedding", v), "lm_head": ("normal", d),
           "final_norm": ("ones", d)}
    for i in range(cfg.first_k_dense):
        out[f"dense_layer_{i}"] = {
            name: (how, shape[0])
            for name, (shape, how, _) in _layer_shapes(cfg, False).items()}
    if cfg.n_scan_layers > 0:
        out["layers"] = {
            name: (how, shape[0])
            for name, (shape, how, _) in _layer_shapes(cfg, cfg.moe).items()}
    return out


def init(cfg: LMConfig, seed: int = 0, device="cuda",
         with_axes: bool = False):
    """Parameters in the reference's layout, drawn on ``device`` from a
    generator seeded with ``seed`` (the reference's values cannot be drawn
    in torch; carry them across with ``convert.lm_params_from_jax``). On
    ``"meta"`` nothing is drawn or allocated: the leaves carry their
    shapes and dtypes only. With ``with_axes``, returns ``(params,
    param_axes(cfg))``, as the reference's ``init`` returns its pair."""
    _check_supported(cfg)
    meta = torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve(device)
    gen = None if meta else torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.torch_dtype()

    def leaf(shape, how, layers=0):
        if meta:
            full = ((layers,) if layers else ()) + tuple(shape)
            return torch.empty(full, dtype=dt, device=dev)
        return P.param(shape, gen, how, dev, dt, layers=layers)

    v, d = cfg.padded_vocab, cfg.d_model
    params = {
        "embed": leaf((v, d), "embedding"),
        "lm_head": leaf((d, v), "normal"),
        "final_norm": leaf((d,), "ones"),
    }
    for i in range(cfg.first_k_dense):
        params[f"dense_layer_{i}"] = {
            name: leaf(shape, how)
            for name, (shape, how, _) in _layer_shapes(cfg, False).items()
        }
    if cfg.n_scan_layers > 0:
        params["layers"] = {
            name: leaf(shape, how, layers=cfg.n_scan_layers)
            for name, (shape, how, _) in _layer_shapes(cfg, cfg.moe).items()
        }
    return (params, param_axes(cfg)) if with_axes else params


# ----------------------------------------------------------------- attention
def _gqa_attention(p, cfg: LMConfig, x, positions, cache_kv, cache_len):
    b, s, _ = x.shape
    q = shlib.einsum("bsd,dhk->bshk", x, p["wq"])
    k = shlib.einsum("bsd,dhk->bshk", x, p["wk"])
    v = shlib.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = shard_activation(q, ("batch", "seq", "heads", "head_dim"))

    if cache_kv is None:
        if s >= cfg.blockwise_threshold:
            out = attn.blockwise_attention(q, k, v, causal=True,
                                           block_k=cfg.attn_block_k)
        else:
            out = attn.dense_attention(q, k, v, causal=True)
    elif shlib.is_dtensor(q):
        out = attn.cached_attention(q, k, v, *cache_kv, cache_len)
    else:
        ck, cv = cache_kv          # this layer's (B, Smax, Hkv, D) views
        ck[:, cache_len:cache_len + s] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + s] = v.to(cv.dtype)
        lens = torch.full((b,), cache_len + s, dtype=torch.int32,
                          device=x.device)
        out = attn.decode_attention(q, ck, cv, lens)
    return shlib.einsum("bshk,hkd->bsd", out, p["wo"])


def _mla_attention(p, cfg: LMConfig, x, positions, cache_kv, cache_len):
    """MLA: compressed-latent KV. Prefill and training expand the latent
    to per-head K/V; decode takes the absorbed-matrix path against the
    latent cache (DeepSeek-V2 Sec. 2.1), writing it in place."""
    b, s, _ = x.shape
    if cfg.q_lora > 0:
        cq = rms_norm(shlib.matmul(x, p["w_dq"]), p["q_norm"])
        q = shlib.einsum("bsq,qhk->bshk", cq, p["w_uq"])
    else:
        q = shlib.einsum("bsd,dhk->bshk", x, p["w_q"])
    q_nope, q_rope = q[..., :cfg.d_nope], q[..., cfg.d_nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv = rms_norm(shlib.matmul(x, p["w_dkv"]), p["kv_norm"])  # (B,S,kv_lora)
    k_rope = apply_rope(shlib.matmul(x, p["w_kr"])[:, :, None, :],
                        positions, cfg.rope_theta)[:, :, 0, :]  # (B,S,d_rope)

    if cache_kv is None:
        # prefill/train: expand the latent to per-head K/V
        k_nope = shlib.einsum("bsc,chk->bshk", c_kv, p["w_uk"])
        v = shlib.einsum("bsc,chk->bshk", c_kv, p["w_uv"])
        # over a mesh, a latent split on kv_lora sums into the heads
        k_nope = shard_activation(k_nope, ("batch", "seq", "heads", "head_dim"))
        v = shard_activation(v, ("batch", "seq", "heads", "head_dim"))
        k_rope_h = shard_activation(k_rope[:, :, None, :].expand(
            *k_nope.shape[:3], cfg.d_rope), ("batch", "seq", "heads",
                                             "head_dim"))
        k = torch.cat([k_nope, k_rope_h], dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        qfull = shard_activation(qfull, ("batch", "seq", "heads", "head_dim"))
        if s >= cfg.blockwise_threshold:
            out = attn.blockwise_attention(qfull, k, v, causal=True,
                                           block_k=cfg.attn_block_k)
        else:
            out = attn.dense_attention(qfull, k, v, causal=True)
    elif shlib.is_dtensor(x):
        out = _mla_cached(p, cfg, q_nope, q_rope, c_kv, k_rope, *cache_kv,
                          cache_len)
    else:
        cc, ckr = cache_kv         # this layer's (B, Smax, .) views
        cc[:, cache_len:cache_len + s] = c_kv.to(cc.dtype)
        ckr[:, cache_len:cache_len + s] = k_rope.to(ckr.dtype)
        # absorbed path: scores = (q_nope W_uk) . c + q_rope . k_rope
        q_abs = torch.einsum("bshk,chk->bshc", q_nope, p["w_uk"])
        s_lat = torch.einsum("bshc,btc->bhst", q_abs, cc)
        s_rope = torch.einsum("bshk,btk->bhst", q_rope, ckr)
        scores = (s_lat + s_rope).float() * _inv_sqrt(cfg.d_nope + cfg.d_rope)
        valid = torch.arange(cc.shape[1], device=x.device) < cache_len + s
        scores = torch.where(valid, scores, attn.NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(cc.dtype)
        o_lat = torch.einsum("bhst,btc->bshc", probs, cc)
        out = torch.einsum("bshc,chk->bshk", o_lat, p["w_uv"])
    return shlib.einsum("bshk,hkd->bsd", out, p["wo"])


@torch.no_grad()
def _mla_cached(p, cfg: LMConfig, q_nope, q_rope, c_kv, k_rope, cc, ckr,
                cache_len: int):
    """MLA's absorbed decode over a mesh: writes the step's latent and
    rotary key into this layer's cache (B, Smax, kv_lora) and (B, Smax,
    d_rope) at ``cache_len`` and attends every head over it, the latent
    dim split over the rules' ``kv_lora`` mesh dims (the latent scores
    and the output summed across them) and the cache's sequence over its
    ``cache_seq`` mesh dims (the softmax combined across them,
    ``attention.combined_softmax``), as the one-device branch of
    :func:`_mla_attention` computes it. The cache's slices stay where
    they are. Returns (B, S, H, d_v), every head on every device."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dmesh = q_nope.device_mesh
    rules = shlib.current_rules()

    def pl(axes):
        return shlib.placements_for(shlib.spec_for(axes, rules, dmesh), dmesh)

    c_pl = pl(("batch", "cache_seq", "kv_lora"))
    r_pl = pl(("batch", "cache_seq", "head_dim"))
    lora = shlib.mesh_dims_of("kv_lora", rules, dmesh)
    seq = shlib.mesh_dims_of("cache_seq", rules, dmesh)

    def unseq(pls):
        return tuple(Replicate() if isinstance(x, Shard) and x.dim == 1
                     else x for x in pls)

    q_pl = tuple(x if isinstance(x, Shard) and x.dim == 0 else Replicate()
                 for x in c_pl)
    w_pl = tuple(Shard(0) if i in lora else Replicate()
                 for i in range(len(c_pl)))
    off = shlib.local_slices(cc.shape, c_pl, dmesh)[1][1]
    scale = _inv_sqrt(cfg.d_nope + cfg.d_rope)

    def reduce(t, dims):
        if not dims:
            return t
        return attn.reduce_over(t.float(), "sum", dmesh, dims).to(t.dtype)

    def body(qn, qr, ckv, kr, w_uk, w_uv, cc, ckr):
        s = qn.shape[1]
        if off <= cache_len and cache_len + s <= off + cc.shape[1]:
            cc[:, cache_len - off:cache_len - off + s] = ckv.to(cc.dtype)
            ckr[:, cache_len - off:cache_len - off + s] = kr.to(ckr.dtype)
        q_abs = torch.einsum("bshk,chk->bshc", qn, w_uk)
        s_lat = reduce(torch.einsum("bshc,btc->bhst", q_abs, cc), lora)
        s_rope = torch.einsum("bshk,btk->bhst", qr, ckr)
        scores = (s_lat + s_rope).float() * scale
        pos = torch.arange(off, off + cc.shape[1], device=qn.device)
        scores = torch.where(pos < cache_len + s, scores, attn.NEG_INF)
        probs = attn.combined_softmax(scores, dmesh, seq).to(cc.dtype)
        o_lat = reduce(torch.einsum("bhst,btc->bshc", probs, cc), seq)
        return reduce(torch.einsum("bshc,chk->bshk", o_lat, w_uv), lora)

    return local_map(
        body, out_placements=list(q_pl),
        in_placements=(q_pl, q_pl, unseq(c_pl), unseq(r_pl), w_pl, w_pl,
                       c_pl, r_pl),
        device_mesh=dmesh, redistribute_inputs=True)(
        q_nope, q_rope, c_kv, k_rope, p["w_uk"], p["w_uv"], cc, ckr)


@functools.lru_cache(maxsize=None)
def _inv_sqrt(d: int) -> torch.Tensor:
    """``1.0 / jnp.sqrt(d).astype(float32)``, the reference's MLA decode
    scale: a float32 square root, then a float32 division. A 0-dim CPU
    tensor, which a CUDA op reads as a scalar; made once per d and only
    ever read."""
    root = torch.tensor(float(d), dtype=torch.float32).sqrt()
    return torch.tensor(1.0, dtype=torch.float32) / root


# -------------------------------------------------------------------- layers
def _layer_apply(p, cfg: LMConfig, use_moe: bool, h, positions, cache_kv,
                 cache_len):
    p = shlib.gather_rows(p)
    attn_fn = _mla_attention if cfg.attn_type == "mla" else _gqa_attention
    # over a mesh, the products' partial sums are reduced before the adds
    h = h + shard_activation(
        attn_fn(p, cfg, rms_norm(h, p["ln_attn"]), positions, cache_kv,
                cache_len), EMBED)
    x = rms_norm(h, p["ln_ffn"])
    if not use_moe:
        h = h + shard_activation(swiglu(x, p["w_gate"], p["w_up"],
                                        p["w_down"]), EMBED)
        return shard_activation(h, EMBED)
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    y = moe_lib.moe_ffn(flat, p["router"], p["w_gate"], p["w_up"],
                        p["w_down"], cfg.top_k, cfg.capacity_factor,
                        no_drop=cache_kv is not None)
    if cfg.n_shared > 0:
        y = y + shard_activation(moe_lib.shared_expert_ffn(
            flat, p["ws_gate"], p["ws_up"], p["ws_down"]), ("batch", "embed"))
    return shard_activation(h + y.reshape(b, s, d), EMBED)


# ------------------------------------------------------------------- forward
def forward(params, cfg: LMConfig, tokens, positions=None, cache=None,
            cache_len: int = 0, mode: str = "train"):
    """tokens: (B, S). cache: the ``init_cache`` dict or None; with a cache
    the step's K/V (MLA: latent and rotary key) are written into it in
    place at ``cache_len``; a layer reads the dict's entries in the order
    of their sorted keys, as the reference does. The ``first_k_dense``
    dense layers run first (cache rows ``0 .. first_k_dense - 1``), then
    the stacked layers (MoE where ``cfg.moe``; the rows after them).
    ``mode``: ``"train"`` rematerialises each layer when ``cfg.remat``;
    ``"prefill"`` and ``"decode"`` never do. Returns hidden (B, S, D)."""
    _check_supported(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    if shlib.is_dtensor(tokens):
        if not shlib.is_dtensor(positions):
            positions = shlib.like(positions, tokens)
        h = _embed_over_mesh(tokens, shlib.gather_rows(params["embed"]))
        h = h.to(cfg.torch_dtype())
    else:
        h = params["embed"][tokens].to(cfg.torch_dtype())
    h = shard_activation(h, EMBED)
    remat = cfg.remat and mode == "train"
    keys = sorted(cache) if cache is not None else ()
    # a recomputed layer runs on autograd's thread: under the rules of now
    apply = shlib.bind_rules(_layer_apply)

    def layer(lp, use_moe, h, row):
        lc = None if cache is None else tuple(cache[k][row] for k in keys)
        if remat:
            return checkpoint(apply, lp, cfg, use_moe, h, positions,
                              lc, cache_len, use_reentrant=False)
        return apply(lp, cfg, use_moe, h, positions, lc, cache_len)

    for i in range(cfg.first_k_dense):
        h = layer(params[f"dense_layer_{i}"], False, h, i)
    if cfg.n_scan_layers > 0:
        layers = {name: t.unbind(0) for name, t in params["layers"].items()}
        for j in range(cfg.n_scan_layers):
            lp = {name: t[j] for name, t in layers.items()}
            h = layer(lp, cfg.moe, h, cfg.first_k_dense + j)
    return rms_norm(h, params["final_norm"])


def _embed_over_mesh(tokens, table):
    """``table[tokens]`` for DTensors, the table's rows split over its
    ``vocab`` mesh dims: each device looks up the tokens its rows hold
    (zeros elsewhere), so the result is a partial sum over those dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    t_pl, e_pl = tuple(tokens.placements), tuple(table.placements)
    v0 = shlib.local_slices(table.shape, e_pl, table.device_mesh)[1][0]
    out_pl = [Partial() if isinstance(ep, Shard)
              else tp if isinstance(tp, Shard) else Replicate()
              for tp, ep in zip(t_pl, e_pl)]
    e_grad = tuple(Partial() if isinstance(tp, Shard) else ep
                   for tp, ep in zip(t_pl, e_pl))

    def body(tok, emb):
        ids = tok - v0
        ok = (ids >= 0) & (ids < emb.shape[0])
        rows = torch.nn.functional.embedding(torch.where(ok, ids, 0), emb)
        return torch.where(ok[..., None], rows, 0.0)

    return local_map(body, out_placements=out_pl, in_placements=(t_pl, e_pl),
                     in_grad_placements=(t_pl, e_grad),
                     device_mesh=table.device_mesh)(tokens, table)


def logits_of(params, cfg: LMConfig, hidden):
    out = shlib.matmul(hidden, shlib.gather_rows(params["lm_head"]))
    return shard_activation(out, ("batch", "seq", "vocab"))


def lm_loss(params, cfg: LMConfig, tokens, targets):
    """Causal LM cross-entropy, the mean over the (B, S) targets;
    optionally chunked over the sequence (``cfg.loss_chunk``) to bound the
    (B, chunk, V) float32 logits working set. With ``cfg.remat`` each
    chunk's logits are recomputed in the backward, so they never persist
    across chunks."""
    hidden = forward(params, cfg, tokens, mode="train")
    b, s, d = hidden.shape
    chunk = cfg.loss_chunk or s
    n_chunks = s // chunk

    sharded = shlib.is_dtensor(hidden)

    def chunk_loss(h_c, t_c):
        logits = logits_of(params, cfg, h_c).float()
        if sharded:
            return _sharded_chunk_loss(logits, t_c)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, t_c[..., None])[..., 0]
        return torch.sum(logz - gold)

    loss_fn = shlib.bind_rules(chunk_loss)

    def run(h_c, t_c):
        if cfg.remat:
            return checkpoint(loss_fn, h_c, t_c, use_reentrant=False)
        return loss_fn(h_c, t_c)

    if n_chunks <= 1:
        total = run(hidden, targets)
    elif sharded:
        hs = hidden.reshape(b, n_chunks, chunk, d)
        ts = targets.reshape(b, n_chunks, chunk)
        total = sum(run(hs[:, c], ts[:, c]) for c in range(n_chunks))
    else:
        hs = hidden.reshape(b, n_chunks, chunk, d)
        ts = targets.reshape(b, n_chunks, chunk)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c in range(n_chunks):
            total = total + run(hs[:, c], ts[:, c])
    if sharded:
        total = shlib.replicated(total)
    return total / (b * s)


def _sharded_chunk_loss(logits, targets):
    """``sum(logsumexp(logits) - logits[targets])`` over float32 logits
    (B, c, V) split on ``vocab``, from each device's vocabulary slice
    (``local_map``): the row max, the sum of exponentials and the gold
    logit (picked where a device's slice holds the target) leave each
    device as partial results and are reduced across the ``vocab`` mesh
    dims, (B, c) values a row. The logits are never gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dmesh = logits.device_mesh
    lg_pl = tuple(logits.placements)
    vocab = tuple(isinstance(p, Shard) and p.dim == 2 for p in lg_pl)
    row_pl = tuple(Replicate() if v else p for v, p in zip(vocab, lg_pl))
    t_pl = tuple(targets.placements)
    v0 = shlib.local_slices(logits.shape, lg_pl, dmesh)[1][2]

    def local_max(lg):
        return lg.amax(dim=-1, keepdim=True)

    m = local_map(local_max, out_placements=[
        Partial("max") if v else p for v, p in zip(vocab, row_pl)],
        in_placements=(lg_pl,), device_mesh=dmesh)(logits.detach())
    m = m.redistribute(dmesh, row_pl)

    def sums(lg, m, t):
        z = torch.exp(lg - m).sum(dim=-1)
        ids = torch.arange(v0, v0 + lg.shape[-1], device=lg.device)
        gold = torch.where(ids == t[..., None], lg, 0.0).sum(dim=-1)
        return z, gold

    part = [Partial() if v else p for v, p in zip(vocab, row_pl)]
    z, gold = local_map(sums, out_placements=(part, part),
                        in_placements=(lg_pl, row_pl, t_pl),
                        device_mesh=dmesh)(logits, m, targets)
    z, gold = z.redistribute(dmesh, row_pl), gold.redistribute(dmesh, row_pl)
    return torch.sum(torch.log(z) + m[..., 0] - gold)


# ------------------------------------------------------------------- serving
def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    """The KV cache, zeros (on ``"meta"``: shapes only, nothing
    allocated)."""
    _check_supported(cfg)
    dtype = dtype or cfg.torch_dtype()
    dev = (torch.device("meta") if torch.device(device).type == "meta"
           else resolve(device))
    lead = (cfg.n_layers, batch, max_len)
    if cfg.attn_type == "mla":
        return {"c": torch.zeros(lead + (cfg.kv_lora,), dtype=dtype,
                                 device=dev),
                "r": torch.zeros(lead + (cfg.d_rope,), dtype=dtype,
                                 device=dev)}
    shape = lead + (cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def cache_specs(cfg: LMConfig) -> dict:
    """Logical axes of the cache's leaves (for sharding specs). The
    sequence axis has its own logical name, ``"cache_seq"``: an arch whose
    KV-head count does not divide the model axis shards the cache along
    it instead (the reference's ``cache_specs``)."""
    _check_supported(cfg)
    if cfg.attn_type == "mla":
        return {"c": ("layers", "batch", "cache_seq", "kv_lora"),
                "r": ("layers", "batch", "cache_seq", "head_dim")}
    return {"k": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
            "v": ("layers", "batch", "cache_seq", "kv_heads", "head_dim")}


@torch.no_grad()
def prefill(params, cfg: LMConfig, tokens):
    """Run the prompt; returns last-position logits (B, V)."""
    hidden = forward(params, cfg, tokens, mode="prefill")
    return logits_of(params, cfg, hidden[:, -1:, :])[:, 0]


@torch.no_grad()
def decode_step(params, cfg: LMConfig, token, cache, cache_len: int):
    """One serving step: token (B, 1) given a cache filled to
    ``cache_len``. Writes the step's K/V (MLA: latent and rotary key) into
    ``cache`` in place and returns (logits (B, V), cache)."""
    cache_len = int(cache_len)
    positions = torch.full(token.shape, cache_len, dtype=torch.int32,
                           device=token.device)
    hidden = forward(params, cfg, token, positions=positions, cache=cache,
                     cache_len=cache_len, mode="decode")
    return logits_of(params, cfg, hidden)[:, 0], cache
