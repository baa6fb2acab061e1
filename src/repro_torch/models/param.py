"""Parameter initialisation for the port's models.

Port of the initialisers ``repro/models/param.py::ParamBuilder`` uses:
``"normal"`` (normal(0, 1/sqrt(fan_in)) with fan_in = shape[0]),
``"zeros"``, ``"ones"`` and ``"embedding"`` (normal(0, 0.02)), and
``vmap_init``'s stacked ``"layers"`` layout: ``layers=L`` draws L
parameters of ``shape`` along a leading axis, each scaled by its own
(unstacked) fan_in. Abstract mode is dry-run tooling and is not ported.

Draws come from an explicit ``torch.Generator`` on the generator's own
device, in float32, and are then scaled, cast and moved to ``device``; a
stacked leaf is drawn a layer at a time into its destination, so its
float32 temporary is one layer's (moonshot's stacked experts are 8.7e9
values: 35 GB as one float32 draw). The SAGE
model draws from a CPU generator (so its numbers do not depend on the
card); the LM draws from a generator on the card, since drawing 1.1B
values on the CPU takes seconds. JAX's PRNG streams cannot be reproduced
in torch; parity tests carry the reference's parameters across with
``repro_torch.convert`` instead.
"""
from __future__ import annotations

import math

import torch


def normal(shape: tuple[int, ...], generator: torch.Generator,
           device: torch.device | str = "cpu",
           dtype: torch.dtype = torch.float32,
           scale: float | None = None, layers: int = 0) -> torch.Tensor:
    """normal(0, scale), scale = 1/sqrt(fan_in) with fan_in = shape[0]
    unless given; ``layers`` > 0 stacks that many along a leading axis,
    drawn one after another."""
    if scale is None:
        scale = 1.0 / math.sqrt(max(shape[0], 1))

    def draw():
        return (torch.randn(tuple(shape), generator=generator,
                            device=generator.device) * scale)

    if not layers:
        return draw().to(device=device, dtype=dtype)
    out = torch.empty((layers,) + tuple(shape), device=device, dtype=dtype)
    for i in range(layers):
        out[i] = draw()
    return out


def param(shape: tuple[int, ...], generator: torch.Generator,
          init: str = "normal", device: torch.device | str = "cpu",
          dtype: torch.dtype = torch.float32,
          layers: int = 0) -> torch.Tensor:
    """One parameter as ``ParamBuilder.param`` initialises it (or, with
    ``layers`` > 0, that many stacked as ``vmap_init`` stacks them)."""
    full = ((layers,) if layers else ()) + tuple(shape)
    if init == "normal":
        return normal(shape, generator, device, dtype, layers=layers)
    if init == "embedding":
        return normal(shape, generator, device, dtype, scale=0.02,
                      layers=layers)
    if init == "zeros":
        return torch.zeros(full, device=device, dtype=dtype)
    if init == "ones":
        return torch.ones(full, device=device, dtype=dtype)
    raise ValueError(init)
