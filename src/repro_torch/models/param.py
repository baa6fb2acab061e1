"""Parameter initialisation for the port's models.

Port of the initialisers ``repro/models/param.py::ParamBuilder`` uses for
the SAGE model: normal(0, 1/sqrt(fan_in)) weights (biases start at zero). Draws
come from an explicit CPU ``torch.Generator`` (so they do not depend on
the device) and are then moved to ``device``. JAX's PRNG streams cannot be
reproduced in torch; parity tests carry the reference's parameters across
with ``repro_torch.convert`` instead.
"""
from __future__ import annotations

import math

import torch


def normal(shape: tuple[int, ...], generator: torch.Generator,
           device: torch.device | str = "cpu",
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """normal(0, 1/sqrt(fan_in)) with fan_in = shape[0]."""
    scale = 1.0 / math.sqrt(max(shape[0], 1))
    return (torch.randn(shape, generator=generator) * scale).to(
        device=device, dtype=dtype
    )
