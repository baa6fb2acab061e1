from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_kernel,
    flash_attention_lse,
    flash_attention_plain,
)
