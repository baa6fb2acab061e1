"""Production mesh descriptions, holding no device.

Port of ``repro/launch/mesh.py``. The reference makes a JAX device mesh
(16 x 16 = 256 chips a pod; two pods, 512) for its dry-run. The port runs
on one card and makes no mesh of devices: :class:`Mesh` only names the
axes and their sizes, which is all ``distributed.sharding`` reads
(``axis_names`` and ``shape``) to turn a leaf's logical axes into a spec
and a per-device size (``launch.dryrun``).
"""
from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def fake_world(n_devices: int, rank: int = 0):
    """The default process group on torch's ``fake`` backend, as rank
    ``rank`` of ``n_devices``, inside the block; destroyed on exit.

    Its collectives return at once and leave their outputs as allocated
    (undefined values): a program run under it is one device's program,
    good for shapes, counts, memory and time, never for values. The
    backend is torch's own test backend
    (``torch.testing._internal.distributed.fake_pg``); without it this
    raises rather than fall back to one device."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("fake_world: this torch has no fake process "
                           "group backend") from e
    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group exists")
    dist.init_process_group("fake", rank=rank, world_size=n_devices,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def device_mesh(mesh: Mesh, device_type: str):
    """``mesh``'s axes as a ``torch.distributed`` ``DeviceMesh`` over the
    default process group's ranks (same dim names and sizes, ranks in
    row-major order, as ``jax.make_mesh`` lays devices out).
    ``device_type``: ``"cuda"``, or ``"cpu"`` for a program on the CPU or
    on ``meta``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, mesh.sizes,
                            mesh_dim_names=mesh.axis_names)
