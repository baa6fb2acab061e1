"""deepseek-v2-236b [arXiv:2405.04434].

60L d_model=5120 128H, MLA (kv_lora=512, q_lora=1536, d_nope=128, d_rope=64,
d_v=128), vocab=102400, MoE 160 routed top-6 + 2 shared (d_ff_expert=1536),
first layer dense d_ff=12288. Attention's q/k head dim is d_nope + d_rope
= 192 and its v dim 128: the flash kernels' (192, 128) instance. Field for
field as ``repro/configs/deepseek_v2_236b.py``.
"""
from repro_torch.configs.registry import ArchDef
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.lm.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-236b", n_layers=60, d_model=5120,
        n_heads=128, n_kv_heads=128, d_head=128, d_ff=12_288, vocab=102_400,
        attn_type="mla", q_lora=1_536, kv_lora=512, d_nope=128, d_rope=64,
        d_v=128, rope_theta=10_000.0,
        moe=True, n_experts=160, top_k=6, n_shared=2, d_ff_expert=1_536,
        first_k_dense=1, grad_accum=8, dtype="bfloat16", loss_chunk=512,
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="deepseek-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=160, vocab=256, attn_type="mla",
        q_lora=32, kv_lora=24, d_nope=16, d_rope=8, d_v=16,
        moe=True, n_experts=8, top_k=2, n_shared=2, d_ff_expert=32,
        first_k_dense=1, dtype="float32", remat=False,
    )


ARCH = ArchDef(
    arch_id="deepseek-v2-236b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=tuple(LM_SHAPES),
    rule_overrides={"heads": "model", "kv_lora": "model",
                    "q_lora": None, "cache_seq": None},
    model_module="repro_torch.models.lm.transformer",
)
