"""Card peaks and roofline terms, keyed by the card's name.

The reference's ``repro/launch/roofline.py`` prices work at one TPU v5e
chip's constants. The port prices it at the peaks of the CUDA card it runs
on, read from :data:`PEAKS` by ``torch.cuda.get_device_name``: the
published dense rates of NVIDIA's data sheet at the card's full power
limit. A CUDA card missing from the table raises rather than borrowing
another card's peaks; the CPU has none.

:func:`roofline_terms` gives the reference's terms (compute, memory and
collective seconds, the dominant one, the compute share of the bound)
from the counted FLOPs by dtype, bytes and collective bytes
(``launch.count``) at a :class:`CardPeaks`. :func:`loop_factor` and
:func:`model_flops` are the reference's, copied. The port counts every
loop iteration, so the factor it applies is 1; the reference's factor is
recorded beside it. The collective bytes come from the counter's view of
the functional collectives a program over a mesh calls
(``launch.count``), so the reference's HLO-text parser
``collective_bytes`` has no input in the port and is not copied (a
stated divergence, ROADMAP queue 3).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.configs.shapes import GNN_SHAPES, LM_SHAPES

# a counted dtype -> the peak it runs at (the H100's fp16 and bf16 dense
# tensor-core rates are the same)
_PEAK_OF = {"fp32": "fp32", "float32": "fp32", "bf16": "bf16",
            "bfloat16": "bf16", "float16": "bf16"}


@dataclasses.dataclass(frozen=True)
class CardPeaks:
    """One card's peak rates: HBM bytes/s and FLOP/s by operand type; and
    its SM count, which sizes a kernel's grid where a count on ``meta``
    stands for this card (``launch.count.Counter(sms=...)``)."""

    name: str
    hbm_bytes_per_s: float
    fp32_flop_per_s: float     # outside the tensor cores
    bf16_flop_per_s: float     # dense, tensor cores
    link_bytes_per_s: float | None = None   # collectives; None: unknown
    sms: int | None = None

    def flop_per_s(self, dtype: str = "fp32") -> float:
        """The peak for ``dtype``: ``"fp32"``/``"bf16"``, or a counted
        dtype's name (``"float32"``, ``"bfloat16"``, ``"float16"``)."""
        peak = _PEAK_OF.get(dtype)
        if peak == "fp32":
            return self.fp32_flop_per_s
        if peak == "bf16":
            return self.bf16_flop_per_s
        raise ValueError(f"no peak for dtype {dtype!r} (fp32 or bf16)")

    def terms(self, flops: float, n_bytes: float,
              dtype: str = "fp32") -> tuple[float, float]:
        """(compute_s, memory_s): ``flops`` at the type's peak, ``n_bytes``
        at the HBM rate."""
        return flops / self.flop_per_s(dtype), n_bytes / self.hbm_bytes_per_s


PEAKS = {
    p.name: p for p in (
        # H100 SXM5: 3.35 TB/s HBM3, 67 TFLOP/s fp32, 989 TFLOP/s bf16,
        # 132 SMs
        CardPeaks("NVIDIA H100 80GB HBM3", 3.35e12, 67e12, 989e12, sms=132),
    )
}
# A card's link rate for the collectives of a program over a mesh. The
# H100's NVLink 4: 900 GB/s in all, 450 GB/s a direction (NVIDIA's H100
# SXM data sheet; not a measurement). Collective bytes are priced at one
# direction's rate, as the reference prices its own at one link rate. A
# 16 x 16 mesh spans 32 eight-card nodes, so on the ``data`` axis this
# one rate flatters the network between nodes. A card's one-device
# peaks (:data:`PEAKS`) carry no link rate: a one-device count moves no
# collective bytes, and one that claims some raises.
LINK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 450e9}


def peaks_of(name: str) -> CardPeaks:
    """The table's entry for the card called ``name``; raises for a card
    the table does not hold."""
    try:
        return PEAKS[name]
    except KeyError:
        raise KeyError(
            f"no peaks for CUDA card {name!r}; known: {sorted(PEAKS)}"
        ) from None


def mesh_peaks_of(name: str) -> CardPeaks:
    """:func:`peaks_of` with the card's link rate
    (:data:`LINK_BYTES_PER_S`): the peaks that price one device of a
    mesh, collectives included."""
    peaks = peaks_of(name)
    return dataclasses.replace(peaks,
                               link_bytes_per_s=LINK_BYTES_PER_S[name])


def device_peaks(device) -> CardPeaks | None:
    """Peaks of the card behind ``device``; None on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return None
    return peaks_of(torch.cuda.get_device_name(device))


def loop_factor(arch_id: str, shape_name: str) -> float:
    """The reference's factor: XLA's cost analysis counts while-loop
    bodies ONCE, so it scales by the dominant loop's static trip count
    (layer scan x grad-accum scan for LM, edge-chunk scan for huge-graph
    equivariant cells). The port runs, and counts, every iteration."""
    arch = get_arch(arch_id)
    if arch.family == "lm":
        cfg = arch.make_config()
        layers = max(cfg.n_scan_layers, 1)
        if LM_SHAPES[shape_name].kind == "train":
            return layers * max(cfg.grad_accum, 1)
        return layers
    if arch.family == "gnn" and arch.arch_id in ("nequip", "mace"):
        shape = GNN_SHAPES[shape_name]
        if shape.kind == "full_graph" and shape.n_edges > 4_000_000:
            chunk = 524_288
            return -(-shape.n_edges // chunk)
    return 1.0


def roofline_terms(flops_by_dtype: dict, n_bytes: float,
                   collective: dict | None = None,
                   peaks: CardPeaks | None = None,
                   reference_factor: float | None = None) -> dict:
    """The reference's roofline terms for one device: compute (each
    dtype's FLOPs at its peak), memory (bytes at the HBM rate) and
    collective (bytes by kind over the link rate) seconds, the dominant
    term and ``roofline_fraction`` (compute over the bound). The port's
    counts cover every loop iteration: ``loop_factor`` is 1, and
    ``reference_factor`` (the reference's :func:`loop_factor`) is
    recorded beside it."""
    if peaks is None:
        raise ValueError("roofline_terms: no card peaks")
    coll = {k: float(v) for k, v in (collective or {}).items()}
    coll_total = sum(coll.values())
    flops = float(sum(flops_by_dtype.values()))
    compute_s = sum(float(f) / peaks.flop_per_s(d)
                    for d, f in flops_by_dtype.items() if f)
    memory_s = float(n_bytes) / peaks.hbm_bytes_per_s
    if coll_total and peaks.link_bytes_per_s is None:
        raise ValueError(f"roofline_terms: {peaks.name} has no link rate "
                         "for collective bytes")
    collective_s = coll_total / peaks.link_bytes_per_s if coll_total else 0.0
    terms = {
        "loop_factor": 1.0,
        "flops_per_device": flops,
        "bytes_per_device": float(n_bytes),
        "collective_bytes_per_device": coll_total,
        "collective_breakdown": coll,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    terms["dominant"] = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1],
    )[0]
    bound = max(compute_s, memory_s, collective_s)
    terms["roofline_fraction"] = compute_s / bound if bound > 0 else 0.0
    terms["bound_s"] = bound
    terms["flops_by_dtype"] = {d: float(f) for d, f in flops_by_dtype.items()}
    terms["card"] = peaks.name
    if reference_factor is not None:
        terms["reference_loop_factor"] = float(reference_factor)
    return terms


def model_flops(arch_id: str, shape_name: str) -> float | None:
    """MODEL_FLOPS = 6 N D (dense) or 6 N_active D (MoE), D = tokens.

    Returns the *global* useful flops for LM train cells (3x fwd for the
    backward pass included via the factor 6); serve cells use 2 N D.
    None for non-LM families (no standard closed form). The reference's
    formula, copied."""
    arch = get_arch(arch_id)
    if arch.family != "lm":
        return None
    cfg = arch.make_config()
    shape = LM_SHAPES[shape_name]
    d, L, v = cfg.d_model, cfg.n_layers, cfg.padded_vocab

    attn = 2 * d * (cfg.n_heads * cfg.d_head) * 2  # qo
    if cfg.attn_type == "gqa":
        attn += 2 * d * (cfg.n_kv_heads * cfg.d_head) * 2  # kv
    else:
        dqk = cfg.d_nope + cfg.d_rope
        attn = (2 * d * (cfg.q_lora or d)
                + 2 * (cfg.q_lora or d) * cfg.n_heads * dqk)
        attn += 2 * d * (cfg.kv_lora + cfg.d_rope)
        attn += 2 * cfg.kv_lora * cfg.n_heads * (cfg.d_nope + cfg.d_v)
        attn += 2 * cfg.n_heads * cfg.d_v * d
    if cfg.moe:
        ffn_active = 2 * d * cfg.d_ff_expert * 3 * (cfg.top_k + cfg.n_shared)
        dense_ffn = 2 * d * cfg.d_ff * 3
        per_tok = (
            cfg.first_k_dense * (attn + dense_ffn)
            + cfg.n_scan_layers * (attn + ffn_active)
        )
    else:
        per_tok = L * (attn + 2 * d * cfg.d_ff * 3)
    per_tok += 2 * d * v  # lm head
    n_active = per_tok / 2  # params touched per token ~ flops/2

    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence + attention over the cache
    tokens = shape.global_batch
    cache_read = (
        2 * shape.global_batch * shape.seq_len
        * cfg.n_heads * cfg.d_head * 2 * L
    )
    return 2.0 * n_active * tokens + cache_read
