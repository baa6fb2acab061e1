"""Tensors on a device type the port's kernel wrappers do not serve.

The wrappers take CPU tensors (their plain versions), CUDA tensors (their
kernels) and ``meta`` tensors (shapes and the counter's charges,
``repro_torch.launch.count``), and raise for any other device. A test of
that refusal needs a tensor on another device type, which a CPU-only
build cannot allocate: :func:`elsewhere` gives a tensor subclass that
carries only metadata (shape, strides, dtype) on ``device`` and refuses
every operation on its data.
"""
from __future__ import annotations

import torch


class Elsewhere(torch.Tensor):
    """Metadata on another device; no operation runs on it."""

    @staticmethod
    def __new__(cls, like: torch.Tensor, device: str):
        return torch.Tensor._make_wrapper_subclass(
            cls, like.shape, strides=like.stride(), dtype=like.dtype,
            device=device)

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise NotImplementedError(f"{func} on a tensor elsewhere")


def elsewhere(t: torch.Tensor, device: str = "xpu") -> torch.Tensor:
    """``t``'s shape, strides and dtype on ``device`` (no data)."""
    return Elsewhere(t, device)
