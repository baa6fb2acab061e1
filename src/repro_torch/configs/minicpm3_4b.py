"""minicpm3-4b [hf:openbmb/MiniCPM3-4B].

62L d_model=2560 40H d_ff=6400 vocab=73448, MLA (kv_lora=256, q_lora=768,
d_nope=64, d_rope=32, d_v=64): attention's q/k head dim is d_nope + d_rope
= 96, its v dim 64. The vocab is padded 73448 -> 73472, as the reference
pads it for its 16-way shard. Field for field as
``repro/configs/minicpm3_4b.py``.
"""
from repro_torch.configs.registry import ArchDef
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.lm.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="minicpm3-4b", n_layers=62, d_model=2560, n_heads=40,
        n_kv_heads=40, d_head=64, d_ff=6_400, vocab=73_448,
        vocab_pad_to=73_472,
        attn_type="mla", q_lora=768, kv_lora=256, d_nope=64, d_rope=32,
        d_v=64, rope_theta=10_000.0, grad_accum=4, dtype="bfloat16",
        loss_chunk=512,
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="minicpm3-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=160, vocab=250, vocab_pad_to=256,
        attn_type="mla", q_lora=32, kv_lora=24, d_nope=16, d_rope=8, d_v=16,
        dtype="float32", remat=False,
    )


ARCH = ArchDef(
    arch_id="minicpm3-4b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=tuple(LM_SHAPES),
    rule_overrides={"heads": None, "kv_lora": "model", "q_lora": None,
                    "cache_seq": None},
    model_module="repro_torch.models.lm.transformer",
    notes="40 heads % 16 != 0: attention TP replicated; TP on mlp + latents",
)
