"""Parameter initialisation for the port's models.

Port of the initialisers ``repro/models/param.py::ParamBuilder`` uses:
``"normal"`` (normal(0, 1/sqrt(fan_in)) with fan_in = shape[0]),
``"zeros"``, ``"ones"`` and ``"embedding"`` (normal(0, 0.02)), and
``vmap_init``'s stacked ``"layers"`` layout: ``layers=L`` draws L
parameters of ``shape`` along a leading axis, each scaled by its own
(unstacked) fan_in. The reference's abstract mode (``ShapeDtypeStruct``
leaves for its dry-run) is the ``meta`` device here (below).

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

:class:`ParamBuilder` is the reference's builder for the models whose
``init`` returns ``(params, axes)`` (the GNN zoo and FM): ``scope`` and
``param`` build the nested parameter dict and, beside it, the logical
axes of each leaf. On the ``meta`` device (:func:`builder` with
``device="meta"``) it draws nothing and allocates nothing: the leaves
carry only their shapes and dtypes, so a full config's shapes (FM's
33,775,616-row table) can be read without a byte of memory.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve


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
          layers: int = 0, scale: float | None = None) -> torch.Tensor:
    """One parameter as ``ParamBuilder.param`` initialises it (or, with
    ``layers`` > 0, that many stacked as ``vmap_init`` stacks them);
    ``scale`` overrides a normal or embedding init's standard deviation."""
    full = ((layers,) if layers else ()) + tuple(shape)
    if init == "normal":
        return normal(shape, generator, device, dtype, scale=scale,
                      layers=layers)
    if init == "embedding":
        return normal(shape, generator, device, dtype,
                      scale=0.02 if scale is None else scale, layers=layers)
    if init == "zeros":
        return torch.zeros(full, device=device, dtype=dtype)
    if init == "ones":
        return torch.ones(full, device=device, dtype=dtype)
    raise ValueError(init)


class ParamBuilder:
    """Nested parameters and their logical axes, as the reference's
    ``ParamBuilder`` records them. Every leaf is drawn from the one
    ``generator`` in the order ``param`` is called; on the ``meta``
    device (``generator`` None) nothing is drawn."""

    def __init__(self, generator: torch.Generator | None,
                 device: torch.device, dtype: torch.dtype = torch.float32):
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype
        self.params: dict = {}
        self.axes: dict = {}

    def scope(self, name: str) -> "ParamBuilder":
        child = ParamBuilder(self.generator, self.device, self.dtype)
        self.params[name] = child.params
        self.axes[name] = child.axes
        return child

    def param(self, name: str, shape: tuple[int, ...],
              logical_axes: tuple[str | None, ...], init: str = "normal",
              scale: float | None = None) -> torch.Tensor:
        assert len(shape) == len(logical_axes), (name, shape, logical_axes)
        if self.device.type == "meta":
            value = torch.empty(tuple(shape), dtype=self.dtype,
                                device="meta")
        else:
            value = param(shape, self.generator, init, self.device,
                          self.dtype, scale=scale)
        self.params[name] = value
        self.axes[name] = tuple(logical_axes)
        return value


def builder(seed: int, device) -> ParamBuilder:
    """A :class:`ParamBuilder` drawing from a generator seeded with
    ``seed`` on ``device`` itself (``resolve``'s rules: ``"cuda"`` raises
    without a card), or, on ``"meta"``, one that records shapes only."""
    if torch.device(device).type == "meta":
        return ParamBuilder(None, torch.device("meta"))
    dev = resolve(device)
    return ParamBuilder(torch.Generator(device=dev).manual_seed(seed), dev)
