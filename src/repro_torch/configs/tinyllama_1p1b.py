"""tinyllama-1.1b [arXiv:2401.02385].

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000 (llama2-arch small).
Field for field as ``repro/configs/tinyllama_1p1b.py``.
"""
from repro_torch.configs.registry import ArchDef
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.lm.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="tinyllama-1.1b", n_layers=22, d_model=2048, n_heads=32,
        n_kv_heads=4, d_head=64, d_ff=5_632, vocab=32_000,
        attn_type="gqa", rope_theta=10_000.0, grad_accum=2, dtype="bfloat16",
        loss_chunk=1_024,
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="tinyllama-smoke", n_layers=3, d_model=64, n_heads=8,
        n_kv_heads=2, d_head=8, d_ff=160, vocab=256, attn_type="gqa",
        dtype="float32", remat=False,
    )


ARCH = ArchDef(
    arch_id="tinyllama-1.1b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=tuple(LM_SHAPES),
    rule_overrides={"heads": "model", "kv_heads": None, "cache_seq": "model"},
    model_module="repro_torch.models.lm.transformer",
)
