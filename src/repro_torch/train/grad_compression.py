"""Gradient compression for data-parallel sync: wire bytes and error
feedback.

Port of ``repro/train/grad_compression.py`` for the uncompressed
``"none"`` scheme. The int8 and top-k schemes with error feedback are not
ported yet (ROADMAP queue 1: compression and the modeled-lane model)
and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.optimizers import tree_leaves, tree_map

SCHEMES = ("none", "int8", "topk")


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def check_scheme(scheme: str) -> None:
    """ValueError for an unknown scheme, NotImplementedError for the
    compressed ones."""
    if scheme not in SCHEMES:
        raise ValueError(
            f"grad_compression must be one of {SCHEMES}, got {scheme!r}"
        )
    if scheme != "none":
        raise NotImplementedError(
            f"grad_compression={scheme!r} is not ported yet "
            "(ROADMAP queue 1: compression)"
        )


def wire_bytes(grads: Any, scheme: str) -> int:
    """Bytes on the wire per sync for roofline/energy accounting."""
    check_scheme(scheme)
    return sum(g.numel() * 4 for g in tree_leaves(grads))
