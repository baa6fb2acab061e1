"""FlashAttention-2 forward and backward: the kernel wrappers, their plain
versions and the autograd Function that joins them.

Port of ``repro/kernels/flash_attention/{kernel,ops}.py``. The wrappers
launch the hand-written CUDA kernel ``csrc/flash_attention.cu`` (which
replaces ``repro/kernels/flash_attention/kernel.py::flash_attention_kernel``,
body ``_flash_kernel``) for CUDA tensors, and take
:func:`flash_attention_plain` only for CPU tensors:

- on the ``meta`` device the wrappers return their outputs' shapes and
  charge the counter (``launch.count``) the launch's FLOPs and bytes
  (:func:`fwd_work`, :func:`bwd_work`); they never run the plain version
  there, which materialises the scores and would count them;
- :func:`flash_attention_kernel` on ``(BH, S, D)``, as the TPU kernel;
- :func:`flash_attention` on ``(B, S, H, D)`` with GQA (``Hq = g * Hkv``,
  q head ``h`` reads KV head ``h // g``), as the reference wrapper, but
  without its transposes and KV-head repeats: the kernel takes the
  ``(B, S, H, D)`` strides and maps the heads itself. v may have a head
  dim ``D_v`` other than q's and k's ``D`` (MLA: ``D = d_nope + d_rope``
  = 96, ``D_v`` = 64 at minicpm3's widths, 192 and 128 at deepseek-v2's),
  as the reference's XLA ``blockwise_attention``
  takes it; the output then has ``D_v`` columns. The CUDA kernels are
  compiled for the ``(D, D_v)`` pairs in ``HEAD_DIMS``.

Both compute what ``_flash_kernel`` computes: scores ``(q . k) * scale`` in
float32 with ``scale = 1/sqrt(D)`` (q's and k's dim, as the reference
divides by ``sqrt(q.shape[-1])``), a causal mask from positions (query
``i`` sees keys ``j <= i``), an online softmax with float32 running max,
sum and accumulator, ``p`` rounded to v's dtype before ``p . V``, the
``NEG_INF = -1e30`` guards that keep fully masked rows at zero, and the
output ``acc / max(l, 1e-30)`` cast once to q's dtype. ``block_q`` and
``block_k`` keep the reference's divisibility checks and set the plain
version's tiles; the CUDA kernel runs its compiled tiles and masks a
ragged tail itself. Both skip KV tiles wholly above the causal diagonal,
which is exact: every query row sees key 0 in the first tile, so its
running max is finite and a fully masked tile adds exactly zero.

The C entry chooses its kernel by dtype, explicitly and not as a
fallback: bf16 runs the tensor-core kernel (``TILE_Q`` x ``TILE_K`` =
128 x 64 tiles, two warpgroups of 64 q rows, ``wgmma`` for both
products, p kept in registers, K/V tiles by ``cp.async`` into a
two-stage ring); float32 runs the SIMT kernel (``F32_TILE`` = 64-row
and 64-key tiles, FMA on the CUDA cores), because the tensor cores take
float32 only as TF32, which cannot meet the float32 tolerance. Both
count in ``flash_attention.launches``. Since bf16 ``p`` is rounded after
subtracting the running max, which depends on the tiling, the plain
version agrees with the bf16 kernel to one bf16 ulp only at the
kernel's own tiles.

Bound at TinyLlama's prefill shape (B=2, S=4096, Hq=32, Hkv=4, D=64,
bf16, causal): operations, 1.37e11 for the causal half of the two
products against 75 MB of q, k, v and o: 0.139 ms at the bf16
tensor-core peak. Design: the note at the top of
``csrc/flash_attention.cu``.

The gradient: :class:`FlashAttention` is a ``torch.autograd.Function``
whose forward is :func:`flash_attention`'s, run with its row log-sum-exp
``L`` (``(B, Hq, Sq)`` float32, written by the same kernel launch, see
:func:`flash_attention_lse`), and whose backward is
:func:`flash_attention_bwd` given that ``L``: the hand-written CUDA
kernels of ``csrc/flash_attention_bwd.cu`` for CUDA tensors (counted in
``flash_attention_bwd.launches``), :func:`flash_attention_bwd_plain` only
for CPU tensors. The reference has no Pallas backward; it differentiates
its XLA ``blockwise_attention`` scan, and the kernels replace what XLA's
autodiff makes of it. Both compute the gradient of the forward with the
bf16 rounding of ``p`` taken as the identity (as autodiff of ``astype``
takes it), from ``L`` and ``delta = rowsum(dO * O)`` in float32, and
round ``P`` and ``dS`` to the inputs' dtype before the products that take
them (bf16 on the tensor cores; a no-op at float32). The bf16 backward
runs on ``wgmma`` (one warpgroup a CTA, 64-row tiles: dK/dV by key tile,
dQ by q tile, no atomics; at (192, 128) dK/dV on two warpgroups, one for
each sum); float32 on the CUDA cores, chosen by dtype.
:func:`flash_attention` returns through the Function whenever grad is
enabled and an input requires it; otherwise (prefill, decode) it runs the
forward alone, without ``L``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

TILE_Q, TILE_K = 128, 64       # the bf16 (tensor-core) kernel's tiles
F32_TILE = 64                   # the float32 (SIMT) kernel's tiles
BWD_TILE = 64                   # the backward kernels' q and key tiles
DKDV_CTAS_PER_SM = 2            # see dkdv_split
# the CUDA kernels' template instances: (D of q and k, D_v of v)
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (96, 64), (192, 128))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the C entry's dtype codes
NEG_INF = -1e30


def flash_attention_plain(q, k, v, causal: bool = True, block_q: int = 128,
                          block_k: int = 128, return_lse: bool = False):
    """Plain PyTorch version on ``(B, S, H, D)`` with GQA (v's head dim
    may differ from q's; the output takes v's): the same online softmax
    over ``block_q`` x ``block_k`` tiles with the same float32 state and
    the same rounding of ``p``. With ``return_lse``, returns ``(out,
    lse)``: each row's log-sum-exp ``m + log(l)`` of its scaled, masked
    scores from the final running max and sum, float32 ``(B, Hq, Sq)``
    (``NEG_INF`` for a row that sees no key), as the kernels write it."""
    b, sq, hq, d = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, sq, hkv, hq // hkv, d).float()
    kf, vf = k.float(), v.float()
    out = torch.empty((b, hkv, hq // hkv, sq, dv), dtype=torch.float32,
                      device=q.device)
    lse = torch.empty((b, hkv, hq // hkv, sq), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, sq, block_q):
        q1 = min(q0 + block_q, sq)
        stat = (b, hkv, hq // hkv, q1 - q0)
        m = torch.full(stat, NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros(stat, dtype=torch.float32, device=q.device)
        acc = torch.zeros(stat + (dv,), dtype=torch.float32, device=q.device)
        # a tile wholly above the diagonal adds exactly zero: skip it
        k_end = min(sk, q1) if causal else sk
        for k0 in range(0, k_end, block_k):
            k1 = min(k0 + block_k, sk)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg[:, q0:q1],
                             kf[:, k0:k1]) * scale
            if causal:
                qpos = torch.arange(q0, q1, device=q.device)
                kpos = torch.arange(k0, k1, device=q.device)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            # rows still fully masked keep m = NEG_INF; zero their share
            p = torch.where(m_new[..., None] > NEG_INF / 2, p, 0.0)
            alpha = torch.where(m > NEG_INF / 2, torch.exp(m - m_new), 0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), vf[:, k0:k1])
            m = m_new
        out[..., q0:q1, :] = acc / l.clamp_min(1e-30)[..., None]
        lse[..., q0:q1] = torch.where(l > 0, m + torch.log(l), NEG_INF)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv).to(q.dtype)
    return (out, lse.reshape(b, hq, sq)) if return_lse else out


def _check(q, k, v, block_q: int, block_k: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, S, H, D)")
    b, sq, hq, d = q.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d
            or v.shape[3] == 0):
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} "
            f"must be (B, Sk, Hkv, D) and (B, Sk, Hkv, D_v) with q's B and "
            f"D {tuple(q.shape)}")
    hkv = k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of "
                         f"Hkv={hkv}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v must be on one device")
    if block_q <= 0 or block_k <= 0 or sq % block_q or k.shape[1] % block_k:
        raise ValueError(f"flash_attention: Sq={sq}, Sk={k.shape[1]} must be "
                         f"multiples of block_q={block_q}, "
                         f"block_k={block_k}")


def _check_head_dims(who: str, q, v) -> None:
    pair = (q.shape[-1], v.shape[-1])
    if pair not in HEAD_DIMS:
        raise ValueError(f"{who}: the CUDA kernel is compiled for D (q, k) "
                         f"and D_v (v) in {HEAD_DIMS}, not D={pair[0]}, "
                         f"D_v={pair[1]}")


def bsh_strides(t) -> tuple:
    """``t``'s (b, s, h) strides as the kernels take them: 0 along a dim
    of size 1, which a kernel never steps along and whose stride PyTorch
    leaves arbitrary, also in a tensor it calls contiguous."""
    return tuple(st if n > 1 else 0
                 for st, n in zip(t.stride()[:3], t.shape[:3]))


def check_kernel_operands(q, k, v) -> None:
    """What the CUDA kernels take beyond :func:`_check`: a compiled pair
    of head dims (q's and k's D, v's D_v), unit stride along D, at most
    65535 q tiles, and for bf16 (16-byte ``cp.async`` copies) 16-byte
    aligned ``data_ptr`` and (b, s, h) strides. Plain checks on the
    operands' metadata: the wrapper calls them for CUDA tensors only."""
    _check_head_dims("flash_attention", q, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must have unit "
                             "stride along D")
    tile_q = TILE_Q if q.dtype == torch.bfloat16 else F32_TILE
    if -(-q.shape[1] // tile_q) > 65535:
        raise ValueError("flash_attention: Sq too long for the kernel grid")
    if q.dtype != torch.bfloat16:
        return
    per_16 = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: bf16 {name} must start on a "
                             "16-byte boundary")
        if any(st % per_16 for st in bsh_strides(t)):
            raise ValueError(f"flash_attention: bf16 {name}'s (b, s, h) "
                             f"strides {t.stride()[:3]} must be multiples "
                             f"of {per_16} elements (16 bytes)")


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """(B, Sq, Hq, D_v) attention of q (B, Sq, Hq, D) over k (B, Sk, Hkv,
    D) and v (B, Sk, Hkv, D_v), GQA.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    that the dtype selects (bf16: the ``wgmma`` kernel at ``TILE_Q`` x
    ``TILE_K``; float32: the SIMT kernel) or raise. The choice is by
    dtype, never a fallback. Where an input requires grad, the result
    carries :class:`FlashAttention`'s backward."""
    _check(q, k, v, block_q, block_k)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, block_q, block_k)
    return _forward(q, k, v, causal, block_q, block_k)


def flash_attention_lse(q, k, v, causal: bool = True, block_q: int = 128,
                        block_k: int = 128):
    """``(o, lse)``: :func:`flash_attention`'s output (no autograd) and
    each row's log-sum-exp, float32 ``(B, Hq, Sq)``, from one launch of
    the same kernel (CPU tensors: :func:`flash_attention_plain`). ``o``
    is bit-equal to :func:`flash_attention`'s."""
    _check(q, k, v, block_q, block_k)
    return _forward(q, k, v, causal, block_q, block_k, with_lse=True)


def _forward(q, k, v, causal: bool, block_q: int, block_k: int,
             with_lse: bool = False):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, block_q, block_k,
                                     return_lse=with_lse)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    check_kernel_operands(q, k, v)
    o = torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype,
                    device=q.device)
    if not with_lse:
        launch(q, k, v, o, causal)
        return o
    b, sq, hq, _ = q.shape
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    launch(q, k, v, o, causal, lse)
    return o, lse


class FlashAttention(torch.autograd.Function):
    """The flash forward, keeping its row log-sum-exp, with the backward
    kernels as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        o, lse = _forward(q, k, v, causal, block_q, block_k, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(),
                                         ctx.causal, lse)
        return dq, dk, dv, None, None, None


def flash_attention_bwd_plain(q, k, v, o, do, causal: bool = True,
                              block_q: int = 512, lse=None):
    """Plain PyTorch gradient (dq, dk, dv) of the forward at ``(q, k, v)``
    with output ``o`` and output gradient ``do``, all ``(B, S, H, D)``
    with GQA (v, o, do and dv at v's head dim ``D_v``, which may differ
    from D): dense float32 scores over ``block_q`` query rows at a time,
    ``P = exp(S - L)``, ``dS = P * (dO . V^T - rowsum(dO * O))``, with
    ``P`` and ``dS`` rounded to the inputs' dtype before the products
    that take them, as the kernels' bf16 operands are (a no-op at
    float32). ``lse`` is the forward's ``L``, float32 ``(B, Hq, Sq)``;
    ``None`` computes it here with ``torch.logsumexp``. Returns the
    gradients in the inputs' dtypes."""
    b, sq, hq, d = q.shape
    sk, hkv, d_v = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    kf, vf = k.float(), v.float()
    if lse is not None:
        lse = lse.reshape(b, hkv, g, sq).float()

    def rnd(x):  # the dtype of the kernel's tensor-core operands
        return x.to(q.dtype).float()

    dq = torch.empty((b, sq, hkv, g, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, block_q):
        q1 = min(q0 + block_q, sq)
        qg = q[:, q0:q1].reshape(b, q1 - q0, hkv, g, d).float()
        dog = do[:, q0:q1].reshape(b, q1 - q0, hkv, g, d_v).float()
        og = o[:, q0:q1].reshape(b, q1 - q0, hkv, g, d_v).float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
        if causal:
            qpos = torch.arange(q0, q1, device=q.device)
            kpos = torch.arange(sk, device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
        row_lse = (torch.logsumexp(s, dim=-1) if lse is None
                   else lse[..., q0:q1])
        p = torch.exp(s - row_lse[..., None])
        delta = (dog * og).sum(dim=-1).permute(0, 2, 3, 1)  # (b, h, g, q)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
        ds = rnd(p * (dp - delta[..., None]))
        dq[:, q0:q1] = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
        dk += torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
        dv += torch.einsum("bhgqk,bqhgd->bkhd", rnd(p), dog)
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd(q, k, v, o, do, causal: bool = True, lse=None):
    """The gradient (dq, dk, dv) of :func:`flash_attention` at ``(q, k,
    v)``, given its output ``o``, the output's gradient ``do`` and the
    forward's row log-sum-exp ``lse`` (:func:`flash_attention_lse`).

    CPU tensors take :func:`flash_attention_bwd_plain` (where ``lse`` may
    be ``None``); CUDA tensors launch the backward kernels
    (:func:`launch_bwd`), which take ``lse`` as an input, or raise."""
    _check(q, k, v, 1, 1)
    o_shape = q.shape[:3] + v.shape[3:]
    if o.shape != o_shape or do.shape != o_shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must be {tuple(o_shape)}, q's "
                         "(B, Sq, Hq) and v's D_v")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, causal, lse=lse)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    if lse is None:
        raise ValueError("flash_attention_bwd: the kernels take the "
                         "forward's lse (flash_attention_lse)")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if k.shape[1] == 0:  # nothing to attend to: the forward gave zeros
        return dq.zero_(), dk, dv
    launch_bwd(q, k, v, o, do, lse, dq, dk, dv, causal)
    return dq, dk, dv


def flash_attention_kernel(q, k, v, causal: bool = True, block_q: int = 128,
                           block_k: int = 128) -> torch.Tensor:
    """(BH, Sq, D) attention of q over k, v (BH, Sk, D), the TPU kernel's
    layout: each BH row is one head."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention_kernel: q, k, v must be (BH, S, D)")
    out = flash_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                          causal, block_q, block_k)
    return out[:, :, 0]


def causal_pairs(sq: int, sk: int, causal: bool) -> int:
    """The (query, key) pairs attention computes: all Sq x Sk, or, causal,
    those with key j <= query i (the kernels skip the tiles above the
    diagonal and mask within the diagonal's)."""
    if not causal:
        return sq * sk
    if sq <= sk:
        return sq * (sq + 1) // 2
    return sk * (sk + 1) // 2 + (sq - sk) * sk


def fwd_work(q, k, v, causal: bool, with_lse: bool) -> tuple[float, float]:
    """(FLOPs, bytes) of one forward launch, the bound's formula: 2 D for
    q . k and 2 D_v for p . v a (query, key) pair and q head; q, k, v
    read and o (and ``lse``) written once."""
    b, sq, hq, d = q.shape
    dv = v.shape[-1]
    pairs = causal_pairs(sq, k.shape[1], causal)
    n_bytes = (q.numel() + k.numel() + v.numel() + b * sq * hq * dv
               ) * q.element_size() + (4 * b * hq * sq if with_lse else 0)
    return 2.0 * (d + dv) * b * hq * pairs, float(n_bytes)


def bwd_work(q, k, v, causal: bool) -> tuple[float, float]:
    """(FLOPs, bytes) of one backward launch, the bound's formula: 2 (3 D
    + 2 D_v) a (query, key) pair and q head (S recomputed, dP, dQ, dK,
    dV); q, k, v, o, dO and ``lse`` read, dQ, dK and dV written once."""
    b, sq, hq, d = q.shape
    dv = v.shape[-1]
    pairs = causal_pairs(sq, k.shape[1], causal)
    es = q.element_size()
    n_bytes = (2 * (q.numel() + k.numel() + v.numel())
               + 2 * b * sq * hq * dv) * es + 4 * b * hq * sq
    return 2.0 * (3 * d + 2 * dv) * b * hq * pairs, float(n_bytes)


def launch(q, k, v, o, causal: bool, lse=None) -> None:
    """Launch the kernel on checked (B, S, H, D) operands (counts one
    launch); with ``lse``, a float32 (B, Hq, Sq) tensor, the same launch
    also writes each row's log-sum-exp there. Every launch charges
    :func:`fwd_work` to the active counters (``_build.count_launch``); on
    ``meta`` the charge stands in for the launch."""
    b, sq, hq, d = q.shape
    work = (*fwd_work(q, k, v, causal, lse is not None), q.dtype)
    if q.device.type == "meta":
        _build.charge(flash_attention, *work)
        return
    fn = _build.entry("flash_attention_fwd")
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        DTYPES[q.dtype], d, v.shape[-1], b, sq, k.shape[1], hq, k.shape[2],
        *bsh_strides(q), *bsh_strides(k), *bsh_strides(v), *bsh_strides(o),
        int(causal), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.count_launch(flash_attention, *work)
    _build.check("flash_attention_fwd", err)


def check_bwd_operands(q, k, v, o, do, lse, dq, dk, dv) -> None:
    """What the backward kernels take: a compiled pair of head dims (q's,
    k's, dq's and dk's D; v's, o's, do's and dv's D_v); one dtype
    (float32 or bfloat16) and one device for the eight (B, S, H, D)
    tensors, each with unit stride along D; ``lse`` float32, contiguous,
    (B, Hq, Sq), on their device; at most 65535 q or key tiles; and for
    bf16 (16-byte ``cp.async`` copies) 16-byte aligned ``data_ptr`` and
    (b, s, h) strides. Plain checks on the operands' metadata, made
    before the device is asked for, so they hold on any device."""
    tensors = {"q": q, "k": k, "v": v, "o": o, "do": do, "dq": dq,
               "dk": dk, "dv": dv}
    _check_head_dims("flash_attention_bwd", q, v)
    for name, t, like in (("o", o, v), ("do", do, v), ("dq", dq, q),
                          ("dk", dk, k), ("dv", dv, v)):
        if t.shape[-1] != like.shape[-1]:
            raise ValueError(f"flash_attention_bwd: {name}'s head dim "
                             f"{t.shape[-1]} is not {like.shape[-1]}")
    if q.dtype not in DTYPES:
        raise ValueError("flash_attention_bwd: the kernel takes float32 or "
                         "bfloat16 CUDA tensors")
    for name, t in tensors.items():
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} is {t.dtype} on "
                             f"{t.device}, not q's {q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention_bwd: {name} must have unit "
                             "stride along D")
    b, sq, hq, _ = q.shape
    if (lse.shape != (b, hq, sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be contiguous "
                         f"float32 {(b, hq, sq)} on {q.device}, not "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    if -(-sq // BWD_TILE) > 65535 or -(-k.shape[1] // BWD_TILE) > 65535:
        raise ValueError("flash_attention_bwd: S too long for the kernel grid")
    if q.dtype != torch.bfloat16:
        return
    per_16 = 16 // q.element_size()
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: bf16 {name} must start "
                             "on a 16-byte boundary")
        if any(st % per_16 for st in bsh_strides(t)):
            raise ValueError(f"flash_attention_bwd: bf16 {name}'s (b, s, h) "
                             f"strides {t.stride()[:3]} must be multiples "
                             f"of {per_16} elements (16 bytes)")


def dkdv_split(q, k) -> int:
    """The parts the bf16 dK/dV kernel cuts each KV head's ``g = Hq /
    Hkv`` query heads into (a power of two dividing ``g``; 1 for
    float32). One CTA per (batch, KV head, key tile) leaves the causal
    key tile 0, which meets every q tile of all ``g`` heads, as the
    launch's critical path; parts run in CTAs of their own, and
    ``bwd_reduce_kernel`` sums their float32 dK and dV in part order.
    Parts double while the grid holds fewer than ``DKDV_CTAS_PER_SM``
    CTAs an SM. On ``meta`` the SMs are those of the card the active
    counter prices (``_build.counter_sms``); with none, 1 part."""
    if q.dtype != torch.bfloat16:
        return 1
    g = q.shape[2] // k.shape[2]
    n_ctas = q.shape[0] * k.shape[2] * -(-k.shape[1] // BWD_TILE)
    if q.device.type == "meta":
        sms = _build.counter_sms()
        if sms is None:
            return 1
    else:
        sms = torch.cuda.get_device_properties(
            q.device).multi_processor_count
    split = 1
    while (g % (2 * split) == 0
           and n_ctas * split < DKDV_CTAS_PER_SM * sms):
        split *= 2
    return split


def launch_bwd(q, k, v, o, do, lse, dq, dk, dv, causal: bool) -> None:
    """Launch the backward kernels (one C entry: the delta pre-pass,
    dK/dV, the parts' sum where :func:`dkdv_split` cuts the heads, dQ)
    on (B, S, H, D) operands and the forward's ``lse``, counting one
    launch, after :func:`check_bwd_operands` and a check that they lie
    on a CUDA device. Every launch charges :func:`bwd_work` to the active
    counters (``_build.count_launch``); on ``meta`` the charge stands in
    for the launch (and the scratch is allocated as on the card)."""
    check_bwd_operands(q, k, v, o, do, lse, dq, dk, dv)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError("flash_attention_bwd: the kernel takes float32 or "
                         "bfloat16 CUDA tensors")
    b, sq, hq, d = q.shape
    sk, hkv, d_v = k.shape[1], k.shape[2], v.shape[-1]
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    split = dkdv_split(q, k)
    # a part: its dK sums (b, sk, hkv, D), then its dV sums (b, sk, hkv, D_v)
    part = (torch.empty((split, b * sk * hkv * (d + d_v)),
                        dtype=torch.float32, device=q.device)
            if split > 1 else None)
    tensors = (q, k, v, o, do, dq, dk, dv)
    work = (*bwd_work(q, k, v, causal), q.dtype)
    if q.device.type == "meta":
        _build.charge(flash_attention_bwd, *work)
        return
    fn = _build.entry("flash_attention_bwd")
    strides = [st for t in tensors for st in bsh_strides(t)]
    err = fn(
        *(t.data_ptr() for t in tensors), lse.data_ptr(), delta.data_ptr(),
        None if part is None else part.data_ptr(), DTYPES[q.dtype], d,
        d_v, b, sq, sk, hq, hkv, split, *strides, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.count_launch(flash_attention_bwd, *work)
    _build.check("flash_attention_bwd", err)


flash_attention.launches = 0
flash_attention.launches_by_thread = {}
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_thread = {}
