"""LM transformer family: GQA or MLA attention, a dense SwiGLU FFN or MoE."""
