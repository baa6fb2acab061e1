"""qwen3-1.7b [hf:Qwen/Qwen3-1.7B family].

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, qk-norm.
Field for field as ``repro/configs/qwen3_1p7b.py``.
"""
from repro_torch.configs.registry import ArchDef
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.lm.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="qwen3-1.7b", n_layers=28, d_model=2048, n_heads=16,
        n_kv_heads=8, d_head=128, d_ff=6_144, vocab=151_936,
        attn_type="gqa", qk_norm=True, rope_theta=1_000_000.0,
        grad_accum=2, dtype="bfloat16", loss_chunk=512,
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen3-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=160, vocab=256, attn_type="gqa", qk_norm=True,
        dtype="float32", remat=False,
    )


ARCH = ArchDef(
    arch_id="qwen3-1.7b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=tuple(LM_SHAPES),
    rule_overrides={"heads": "model", "kv_heads": None, "cache_seq": "model"},
    model_module="repro_torch.models.lm.transformer",
)
