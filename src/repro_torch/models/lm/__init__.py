"""LM transformer family: GQA attention with a dense SwiGLU FFN (MLA and
MoE are not ported yet)."""
