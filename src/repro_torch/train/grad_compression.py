"""Gradient compression for data-parallel sync (scale-out optimization).

Port of ``repro/train/grad_compression.py``. Two schemes with error
feedback (the residual of what compression dropped is carried to the next
step, preserving convergence — Karimireddy et al. 2019):

  * int8 quantization: per-leaf max-abs scale, ~4x wire reduction;
  * top-k sparsification: keep the k largest-|g| entries per leaf.

``compress -> (all-reduce on the compressed payload) -> decompress`` is
modeled functionally: these pure functions return what a peer would
receive and the new error. Trees are nested dicts, lists and tuples of
tensors, walked with ``optim``'s tree helpers.

The int8 path repeats the reference's float32 operations one for one, so
it is bit-equal to the reference on the CPU and to the CPU on the card:
the scale is ``max|g| / 127 + 1e-12`` and ``g / scale`` is an IEEE
division by a tensor on ``g``'s device (on the card, dividing by a
Python number or a CPU scalar becomes a multiplication by its
reciprocal); ``torch.round`` rounds half to even, as ``jnp.round`` does.
The top-k path keeps ``torch.topk``'s k entries, where the reference
keeps ``lax.top_k``'s: the two may order ties differently, and only the
kept set matters.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.optimizers import tree_leaves, tree_map, tree_unflatten

SCHEMES = ("none", "int8", "topk")


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def check_scheme(scheme: str) -> None:
    """ValueError for an unknown scheme."""
    if scheme not in SCHEMES:
        raise ValueError(
            f"grad_compression must be one of {SCHEMES}, got {scheme!r}"
        )


def _unzip_map(fn, grads: Any, error: Any) -> tuple[Any, Any]:
    """Apply ``fn(g, e) -> (a, b)`` leaf-wise and unzip into two trees.

    An explicit flatten and unflatten, as the reference's: a tuple-
    returning map followed by a re-map that stops at tuples would mangle
    trees that hold tuples (e.g. ``(w, b)`` layer parameters)."""
    pairs = [fn(g, e) for g, e in zip(tree_leaves(grads),
                                      tree_leaves(error))]
    return (
        tree_unflatten(grads, [a for a, _ in pairs]),
        tree_unflatten(grads, [b for _, b in pairs]),
    )


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    """A float32 0-dim tensor on ``like``'s device (an operand the card
    divides by, not a reciprocal it multiplies with)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


# ------------------------------------------------------------------ int8
def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / _full(g, 127.0) + _full(g, 1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_int8(grads: Any, error: Any) -> tuple[Any, Any]:
    """Returns (decompressed grads as would be received, new error)."""

    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, s = quantize_int8(g32)
        deq = dequantize_int8(q, s)
        return deq, g32 - deq

    return _unzip_map(one, grads, error)


# ------------------------------------------------------------------ top-k
def compress_topk(grads: Any, error: Any, frac: float = 0.05
                  ) -> tuple[Any, Any]:
    """Keep each leaf's ``max(int(frac * n), 1)`` largest-|g| entries;
    returns (the kept entries, zeros elsewhere; new error)."""

    def one(g, e):
        g32 = g.to(torch.float32) + e
        flat = g32.reshape(-1)
        k = max(int(frac * flat.shape[0]), 1)
        idx = torch.topk(torch.abs(flat), k).indices
        kept = torch.zeros_like(flat)
        kept[idx] = flat[idx]
        kept = kept.reshape(g32.shape)
        return kept, g32 - kept

    return _unzip_map(one, grads, error)


def wire_bytes(grads: Any, scheme: str, frac: float = 0.05) -> int:
    """Bytes on the wire per sync for roofline/energy accounting."""
    total = 0
    for g in tree_leaves(grads):
        n = g.numel()
        if scheme == "none":
            total += n * 4
        elif scheme == "int8":
            total += n * 1 + 4
        elif scheme == "topk":
            k = max(int(frac * n), 1)
            total += k * 8  # value + index
        else:
            raise ValueError(scheme)
    return total
