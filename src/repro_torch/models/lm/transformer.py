"""Decoder-only transformer: the GQA + dense SwiGLU archs, for training and
serving.

Port of ``repro/models/lm/transformer.py``: ``LMConfig`` (same fields and
defaults), ``init``, ``forward`` (with its ``mode``), ``logits_of``,
``lm_loss``, ``init_cache``, ``prefill`` and ``decode_step``. Sequences of
``S >= blockwise_threshold`` run attention through the flash-attention
kernel (``attention.blockwise_attention``), whose gradient is the
backward kernel; shorter ones through the plain dense path; decode steps
attend over the KV cache. With ``cfg.remat`` and ``mode="train"`` each
layer is rematerialised (``torch.utils.checkpoint``, non-reentrant: only
the layer's input is kept, its activations are recomputed in the
backward, as ``jax.checkpoint`` with ``nothing_saveable``), and
``lm_loss`` recomputes each chunk's float32 logits in the backward.

What differs from the reference:

- the ``lax.scan`` over layers is a Python loop over the stacked
  ``params["layers"]`` (leading ``(L, ...)`` axis, as ``vmap_init``
  stacks them);
- ``shard_activation`` is the identity on one card and is dropped;
- the KV cache keeps the reference's ``{"k", "v"}: (L, B, Smax, Hkv, D)``
  dict, but ``decode_step`` writes it in place;
- the stacked layer parameters are split once with ``unbind``, so their
  gradient is one stack of the layers' gradients;
- ``attn_type="mla"``, ``moe=True`` and the MoE archs' ``first_k_dense``
  layers raise ``NotImplementedError`` (ROADMAP.md queue 1 item 8).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.models import param as P
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm.layers import apply_rope, rms_norm, swiglu

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    if cfg.attn_type == "mla":
        raise NotImplementedError(
            "attn_type='mla' is not ported yet (ROADMAP.md queue 1 item 8)")
    if cfg.attn_type != "gqa":
        raise ValueError(cfg.attn_type)
    if cfg.moe or cfg.first_k_dense:
        raise NotImplementedError(
            "MoE layers are not ported yet (ROADMAP.md queue 1 item 8)")


# --------------------------------------------------------------------- init
def _layer_shapes(cfg: LMConfig) -> dict:
    """name -> (per-layer shape, init), in ``_init_layer``'s order."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    shapes = {
        "ln_attn": ((d,), "ones"),
        "ln_ffn": ((d,), "ones"),
        "wq": ((d, h, dh), "normal"),
        "wk": ((d, hkv, dh), "normal"),
        "wv": ((d, hkv, dh), "normal"),
        "wo": ((h, dh, d), "normal"),
    }
    if cfg.qk_norm:
        shapes["q_norm"] = ((dh,), "ones")
        shapes["k_norm"] = ((dh,), "ones")
    shapes["w_gate"] = ((d, cfg.d_ff), "normal")
    shapes["w_up"] = ((d, cfg.d_ff), "normal")
    shapes["w_down"] = ((cfg.d_ff, d), "normal")
    return shapes


def init(cfg: LMConfig, seed: int = 0, device="cuda") -> dict:
    """Parameters in the reference's layout, drawn on ``device`` from a
    generator seeded with ``seed`` (the reference's values cannot be drawn
    in torch; carry them across with ``convert.lm_params_from_jax``)."""
    _check_supported(cfg)
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.torch_dtype()
    v, d = cfg.padded_vocab, cfg.d_model
    params = {
        "embed": P.param((v, d), gen, "embedding", dev, dt),
        "lm_head": P.param((d, v), gen, "normal", dev, dt),
        "final_norm": P.param((d,), gen, "ones", dev, dt),
        "layers": {
            name: P.param(shape, gen, how, dev, dt, layers=cfg.n_layers)
            for name, (shape, how) in _layer_shapes(cfg).items()
        },
    }
    return params


# ----------------------------------------------------------------- attention
def _gqa_attention(p, cfg: LMConfig, x, positions, cache_kv, cache_len):
    b, s, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache_kv is None:
        if s >= cfg.blockwise_threshold:
            out = attn.blockwise_attention(q, k, v, causal=True,
                                           block_k=cfg.attn_block_k)
        else:
            out = attn.dense_attention(q, k, v, causal=True)
    else:
        ck, cv = cache_kv          # this layer's (B, Smax, Hkv, D) views
        ck[:, cache_len:cache_len + s] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + s] = v.to(cv.dtype)
        lens = torch.full((b,), cache_len + s, dtype=torch.int32,
                          device=x.device)
        out = attn.decode_attention(q, ck, cv, lens)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


# -------------------------------------------------------------------- layers
def _layer_apply(p, cfg: LMConfig, h, positions, cache_kv, cache_len):
    h = h + _gqa_attention(p, cfg, rms_norm(h, p["ln_attn"]), positions,
                           cache_kv, cache_len)
    x = rms_norm(h, p["ln_ffn"])
    return h + swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


# ------------------------------------------------------------------- forward
def forward(params, cfg: LMConfig, tokens, positions=None, cache=None,
            cache_len: int = 0, mode: str = "train"):
    """tokens: (B, S). cache: the ``init_cache`` dict or None; with a cache
    the step's K/V are written into it in place at ``cache_len``.
    ``mode``: ``"train"`` rematerialises each layer when ``cfg.remat``;
    ``"prefill"`` and ``"decode"`` never do. Returns hidden (B, S, D)."""
    _check_supported(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    h = params["embed"][tokens].to(cfg.torch_dtype())
    layers = {name: t.unbind(0) for name, t in params["layers"].items()}
    remat = cfg.remat and mode == "train"
    for i in range(cfg.n_layers):
        lp = {name: t[i] for name, t in layers.items()}
        lc = None if cache is None else (cache["k"][i], cache["v"][i])
        if remat:
            h = checkpoint(_layer_apply, lp, cfg, h, positions, lc,
                           cache_len, use_reentrant=False)
        else:
            h = _layer_apply(lp, cfg, h, positions, lc, cache_len)
    return rms_norm(h, params["final_norm"])


def logits_of(params, cfg: LMConfig, hidden):
    return hidden @ params["lm_head"]


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

    def chunk_loss(h_c, t_c):
        logits = logits_of(params, cfg, h_c).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, t_c[..., None])[..., 0]
        return torch.sum(logz - gold)

    def run(h_c, t_c):
        if cfg.remat:
            return checkpoint(chunk_loss, h_c, t_c, use_reentrant=False)
        return chunk_loss(h_c, t_c)

    if n_chunks <= 1:
        total = run(hidden, targets)
    else:
        hs = hidden.reshape(b, n_chunks, chunk, d)
        ts = targets.reshape(b, n_chunks, chunk)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c in range(n_chunks):
            total = total + run(hs[:, c], ts[:, c])
    return total / (b * s)


# ------------------------------------------------------------------- serving
def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    _check_supported(cfg)
    dtype = dtype or cfg.torch_dtype()
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dev = resolve(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


@torch.no_grad()
def prefill(params, cfg: LMConfig, tokens):
    """Run the prompt; returns last-position logits (B, V)."""
    hidden = forward(params, cfg, tokens, mode="prefill")
    return logits_of(params, cfg, hidden[:, -1:, :])[:, 0]


@torch.no_grad()
def decode_step(params, cfg: LMConfig, token, cache, cache_len: int):
    """One serving step: token (B, 1) given a cache filled to
    ``cache_len``. Writes the step's K/V into ``cache`` in place and
    returns (logits (B, V), cache)."""
    cache_len = int(cache_len)
    positions = torch.full(token.shape, cache_len, dtype=torch.int32,
                           device=token.device)
    hidden = forward(params, cfg, token, positions=positions, cache=cache,
                     cache_len=cache_len, mode="decode")
    return logits_of(params, cfg, hidden)[:, 0], cache
