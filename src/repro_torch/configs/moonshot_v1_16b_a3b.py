"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) [hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (GQA kv=16) d_ff_expert=1408 vocab=163840,
MoE 64 routed top-6 + 2 shared, first layer dense (DeepSeek-V3-style arch).
Field for field as ``repro/configs/moonshot_v1_16b_a3b.py``.
"""
from repro_torch.configs.registry import ArchDef
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.lm.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048,
        n_heads=16, n_kv_heads=16, d_head=128, d_ff=11_264, vocab=163_840,
        attn_type="gqa", rope_theta=50_000.0,
        moe=True, n_experts=64, top_k=6, n_shared=2, d_ff_expert=1_408,
        first_k_dense=1, grad_accum=4, dtype="bfloat16", loss_chunk=512,
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="moonshot-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=160, vocab=256, attn_type="gqa",
        moe=True, n_experts=8, top_k=2, n_shared=2, d_ff_expert=32,
        first_k_dense=1, dtype="float32", remat=False,
    )


ARCH = ArchDef(
    arch_id="moonshot-v1-16b-a3b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=tuple(LM_SHAPES),
    rule_overrides={"heads": "model", "kv_heads": "model",
                    "cache_seq": None},
    model_module="repro_torch.models.lm.transformer",
)
