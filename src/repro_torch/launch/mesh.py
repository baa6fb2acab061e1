"""Production mesh descriptions, holding no device.

Port of ``repro/launch/mesh.py``. The reference makes a JAX device mesh
(16 x 16 = 256 chips a pod; two pods, 512) for its dry-run. The port runs
on one card and makes no mesh of devices: :class:`Mesh` only names the
axes and their sizes, which is all ``distributed.sharding`` reads
(``axis_names`` and ``shape``) to turn a leaf's logical axes into a spec
and a per-device size (``launch.dryrun``).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes of a device mesh; no devices."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"mesh: {self.axis_names} against {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; multi_pod adds the 2-pod axis (512)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_mesh_from_shape(shape: tuple, axes: tuple) -> Mesh:
    """Any mesh (elastic restarts: e.g. (1, 16, 16) after a pod's loss)."""
    return Mesh(tuple(axes), tuple(int(n) for n in shape))
