"""Logical-axis sharding rules for parameters and activations, as specs.

Port of ``repro/distributed/sharding.py`` without JAX: a spec is a plain
tuple (one entry a dim: a mesh axis name, a tuple of names, or None for
replicated) where the reference builds a ``PartitionSpec``, and a mesh is
``launch.mesh.Mesh`` (its ``axis_names`` and ``shape``). Models annotate
parameters with logical axis names (``init``'s axes trees); a rule table
maps logical names to mesh axes. On one card nothing is sharded: the
specs serve the dry-run's per-device sizes (``launch.dryrun``), and
:func:`shard_activation` is the identity.

Over a ``torch.distributed`` ``DeviceMesh`` (``launch.mesh.device_mesh``)
a spec becomes DTensor placements (:func:`placements_for`: a dim named
to one mesh axis or several is ``Shard(dim)`` on each, every other mesh
dim ``Replicate()``), :func:`distribute_tree` makes a tree of DTensors
(this rank's shards), and, with rules and a ``DeviceMesh`` installed
(:func:`use_rules`), :func:`shard_activation` redistributes a DTensor to
its rule's placements: the reference's ``with_sharding_constraint``.
DTensor cuts a dim over several mesh dims in mesh order, outermost
first, which is the major-to-minor order of a JAX spec that lists the
axes in mesh order; a spec that lists them in another order raises. An
uneven dim splits as ``torch.chunk`` does, so rank 0's shard is the
ceiling (:func:`per_device_shape`).

Rule design (the reference's):
  * batch-like axes -> ("pod", "data"), so the same rules serve single-
    and multi-pod meshes,
  * weight row/col axes -> "model" (TP) and "data" (FSDP/ZeRO),
  * GNN edge/node axes -> all axes flattened (graph parallelism),
  * recsys table rows -> "model".
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Sequence

import torch

_state = threading.local()


def default_rules(multi_pod: bool) -> dict[str, Any]:
    """Logical axis -> mesh axis (str, tuple of str, or None)."""
    data = ("pod", "data") if multi_pod else "data"
    every = ("pod", "data", "model") if multi_pod else ("data", "model")
    return {
        # ---- LM ----
        "batch": data,
        "seq": None,
        "embed": None,           # activations keep embed unsharded
        "embed_rows": data,      # FSDP shard of embedding/weight rows
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "experts": "model",
        "expert_capacity": data,   # dispatch tensors (E, C, d) shard C
        "layers": None,
        "kv_lora": None,
        "q_lora": None,
        # ---- GNN ----
        "edges": every,          # graph parallelism: edges over all devices
        "nodes": every,
        "gnn_in": None,
        "gnn_hidden": None,
        "classes": None,
        "graph_batch": data,
        # ---- recsys ----
        "table_rows": "model",
        "fields": None,
        "candidates": every,
    }


@contextlib.contextmanager
def use_rules(rules: Optional[dict], mesh=None):
    """Install ``rules`` (and ``mesh``) for this thread inside the block."""
    prev = getattr(_state, "rules", None), getattr(_state, "mesh", None)
    _state.rules, _state.mesh = rules, mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = prev


def current_rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


def axis_names_of(mesh) -> tuple:
    """A mesh's axis names: ``axis_names`` (``launch.mesh.Mesh``, a JAX
    mesh) or ``mesh_dim_names`` (a ``DeviceMesh``)."""
    names = getattr(mesh, "axis_names", None)
    return tuple(mesh.mesh_dim_names if names is None else names)


def spec_for(logical_axes: Sequence[Optional[str]],
             rules: Optional[dict] = None, mesh=None) -> tuple:
    """The spec of a leaf with ``logical_axes`` under ``rules`` (default:
    the installed ones): one entry a dim, None where it is replicated. A
    mesh axis serves one dim at most (the first that asks for it); with a
    mesh, axes it does not have are dropped. Without rules, ``()``."""
    rules = rules if rules is not None else current_rules()
    mesh = mesh if mesh is not None else current_mesh()
    if rules is None:
        return ()
    parts, used = [], set()
    for ax in logical_axes:
        assignment = rules.get(ax) if ax is not None else None
        if assignment is None:
            parts.append(None)
            continue
        axes = ((assignment,) if isinstance(assignment, str)
                else tuple(assignment))
        if mesh is not None:
            axes = tuple(a for a in axes if a in axis_names_of(mesh))
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        if not axes:
            parts.append(None)
        elif len(axes) == 1:
            parts.append(axes[0])
        else:
            parts.append(axes)
    return tuple(parts)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor sharded over a mesh)."""
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def device_mesh_of(mesh):
    """``mesh`` if it is a ``DeviceMesh`` (what DTensors live on), else
    None (no mesh, or a mesh of names only)."""
    if mesh is None or getattr(mesh, "mesh_dim_names", None) is None:
        return None
    return mesh


def placements_for(spec: tuple, device_mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``device_mesh``, one a mesh
    dim: ``Shard(d)`` on each mesh dim that dim ``d``'s entry names,
    ``Replicate()`` elsewhere. The names of one entry must come in mesh
    order (JAX's major-to-minor order is then DTensor's)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names_of(device_mesh)
    out = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"placements_for: {axes} is not in the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def mesh_dims_of(logical: str, rules: dict, device_mesh) -> tuple:
    """The mesh dims (indices) that ``rules`` assign the logical axis
    ``logical`` to on ``device_mesh``."""
    names = axis_names_of(device_mesh)
    assignment = rules.get(logical)
    if assignment is None:
        return ()
    axes = (assignment,) if isinstance(assignment, str) else assignment
    return tuple(names.index(a) for a in axes if a in names)


def shard_activation(x, logical_axes: Sequence[Optional[str]]):
    """``x`` redistributed to the placements of ``logical_axes`` under the
    installed rules, when ``x`` is a DTensor and a ``DeviceMesh`` is
    installed; otherwise the identity (one card shards no activation,
    and the reference's ``with_sharding_constraint`` is a no-op without
    rules, too)."""
    rules, dmesh = current_rules(), device_mesh_of(current_mesh())
    if rules is None or dmesh is None or not is_dtensor(x):
        return x
    target = placements_for(spec_for(logical_axes, rules, dmesh), dmesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(dmesh, target)


def gather_rows(tree):
    """``tree`` with every DTensor leaf gathered along the mesh dims of
    the installed rules' ``"embed_rows"`` (the FSDP shard of weight rows):
    a layer's weights as its products take them. The identity without a
    ``DeviceMesh`` installed, and on a leaf that is not a DTensor."""
    rules, dmesh = current_rules(), device_mesh_of(current_mesh())
    if rules is None or dmesh is None:
        return tree
    from torch.distributed.tensor import Replicate

    dims = mesh_dims_of("embed_rows", rules, dmesh)

    def one(x):
        if not is_dtensor(x):
            return x
        pl = tuple(Replicate() if i in dims else p
                   for i, p in enumerate(x.placements))
        return x if pl == tuple(x.placements) else x.redistribute(dmesh, pl)

    if isinstance(tree, dict):
        return {k: one(v) for k, v in tree.items()}
    return one(tree)


def einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)``; for DTensors, on each device's local
    shards (``local_map``), Megatron's way: on each mesh dim where an
    operand is split along a letter, the other is split along that
    letter too (a replicated operand is cut locally, no communication;
    one without the letter stays whole), and the output is split along
    it, or, where the letter is summed, a partial sum. An operand whole
    on a mesh dim where the letter it lacks is split gets a partial sum
    for its gradient. Operands split along two different letters on one
    mesh dim, or partial sums, raise: redistribute them first."""
    if not is_dtensor(a):
        return torch.einsum(eq, a, b)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    pl_a, pl_b, pl_o, g_a, g_b = [], [], [], [], []
    for i, (pa, pb) in enumerate(zip(a.placements, b.placements)):
        if isinstance(pa, Partial) or isinstance(pb, Partial):
            raise ValueError(f"einsum {eq}: a partial sum on mesh dim {i}")
        ca = la[pa.dim] if isinstance(pa, Shard) else None
        cb = lb[pb.dim] if isinstance(pb, Shard) else None
        if ca and cb and ca != cb:
            raise ValueError(f"einsum {eq}: mesh dim {i} splits {ca!r} of "
                             f"one operand and {cb!r} of the other")
        c = ca or cb
        if c is None:
            for lst in (pl_a, pl_b, pl_o, g_a, g_b):
                lst.append(Replicate())
            continue
        pl_a.append(Shard(la.index(c)) if c in la else Replicate())
        pl_b.append(Shard(lb.index(c)) if c in lb else Replicate())
        pl_o.append(Shard(out.index(c)) if c in out else Partial())
        g_a.append(pl_a[-1] if c in la else Partial())
        g_b.append(pl_b[-1] if c in lb else Partial())

    def body(x, y):
        return torch.einsum(eq, x, y)

    return local_map(body, out_placements=pl_o,
                     in_placements=(tuple(pl_a), tuple(pl_b)),
                     in_grad_placements=(tuple(g_a), tuple(g_b)),
                     device_mesh=a.device_mesh,
                     redistribute_inputs=True)(a, b)


def matmul(a, b):
    """``a @ b`` (``b`` a matrix); for DTensors, :func:`einsum`'s."""
    if not is_dtensor(a):
        return a @ b
    lead = "abcdefgh"[:a.ndim - 1]
    return einsum(f"{lead}k,kn->{lead}n", a, b)


def bind_rules(fn):
    """``fn`` run under the rules and ``DeviceMesh`` installed now,
    wherever it is called later: autograd recomputes a checkpointed
    layer on its own thread (the card's), where this thread's rules are
    not installed. ``fn`` itself without a ``DeviceMesh`` installed."""
    rules, mesh = current_rules(), current_mesh()
    if device_mesh_of(mesh) is None:
        return fn

    def bound(*args, **kwargs):
        with use_rules(rules, mesh):
            return fn(*args, **kwargs)

    return bound


def like(t: torch.Tensor, template):
    """``t``, a plain tensor of the DTensor ``template``'s global shape
    (on this rank's device), as a DTensor at ``template``'s placements:
    this rank's slice of it, cut without communication."""
    from torch.distributed.tensor import DTensor

    dmesh, placements = template.device_mesh, tuple(template.placements)
    shape, offset = local_slices(t.shape, placements, dmesh)
    local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    return DTensor.from_local(local, dmesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def replicate_on(t: torch.Tensor, template):
    """The plain tensor ``t`` (the same on every rank) as a DTensor
    replicated over the DTensor ``template``'s mesh."""
    from torch.distributed.tensor import DTensor, Replicate

    dmesh = template.device_mesh
    return DTensor.from_local(t, dmesh, (Replicate(),) * dmesh.ndim,
                              run_check=False)


def reduced(t):
    """The DTensor ``t`` with its partial sums (or means) reduced: each
    ``Partial`` placement made ``Replicate``, the rest kept."""
    from torch.distributed.tensor import Replicate

    placements = tuple(Replicate() if p.is_partial() else p
                       for p in t.placements)
    if placements == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def replicated(t):
    """The DTensor ``t`` replicated over its whole mesh (partial sums
    reduced, shards gathered)."""
    from torch.distributed.tensor import Replicate

    return t.redistribute(t.device_mesh, (Replicate(),) * t.device_mesh.ndim)


def split_local_rows(t, parts: int) -> list:
    """The DTensor ``t`` (rows split over the mesh) cut into ``parts``
    DTensors, each taking the same share of every device's local rows:
    a microbatch split that needs no collective."""
    from torch.distributed.tensor import DTensor

    local = t.to_local()
    if local.shape[0] % parts:
        raise ValueError(f"split_local_rows: {local.shape[0]} local rows "
                         f"are not a multiple of {parts}")
    n = local.shape[0] // parts
    shape = (t.shape[0] // parts,) + tuple(t.shape[1:])
    return [DTensor.from_local(local[i * n:(i + 1) * n], t.device_mesh,
                               t.placements, run_check=False, shape=shape,
                               stride=torch.empty(shape, device="meta"
                                                  ).stride())
            for i in range(parts)]


def local_slices(shape: tuple, placements, device_mesh) -> tuple:
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` under ``placements``."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    local, offset = compute_local_shape_and_global_offset(
        tuple(shape), device_mesh, tuple(placements))
    return tuple(local), tuple(offset)


def distribute_leaf(t: torch.Tensor, spec: tuple, device_mesh,
                    local_fn=None):
    """``t`` (the global tensor, or a ``meta`` tensor of its shape) as a
    DTensor with ``spec``'s placements: this rank's shard cut out of
    ``t`` (no communication), or on ``meta`` an empty shard of its
    shape; ``local_fn(t, local_shape, offset)``, when given, makes the
    shard instead (a card drawing rank 0's shards from a seed)."""
    from torch.distributed.tensor import DTensor

    placements = placements_for(spec, device_mesh)
    shape, offset = local_slices(t.shape, placements, device_mesh)
    if local_fn is not None:
        local = local_fn(t, shape, offset)
    elif t.device.type == "meta":
        local = torch.empty(shape, dtype=t.dtype, device="meta")
    else:
        local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
        local = local.contiguous()
    out = DTensor.from_local(local, device_mesh, placements, run_check=False,
                             shape=t.shape, stride=t.stride())
    return out.requires_grad_(t.requires_grad)


def distribute_tree(tree: Any, axes_tree: Any, rules: dict, device_mesh,
                    local_fn=None) -> Any:
    """``tree`` (nested dicts, lists, tuples and dataclass instances of
    tensors and other values, as a cell's arguments) with every tensor
    leaf distributed by :func:`distribute_leaf` under the spec of its
    logical axes in ``axes_tree`` (a tree of tuples beside ``tree``; a
    leaf without axes, None, is replicated). Other values pass through."""
    import dataclasses

    if isinstance(tree, torch.Tensor):
        spec = (() if axes_tree is None
                else spec_for(axes_tree, rules, device_mesh))
        return distribute_leaf(tree, spec, device_mesh, local_fn)
    if isinstance(tree, dict):
        return {k: distribute_tree(v, None if axes_tree is None
                                   else axes_tree[k], rules, device_mesh,
                                   local_fn)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            distribute_tree(v, None if axes_tree is None else axes_tree[i],
                            rules, device_mesh, local_fn)
            for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: distribute_tree(
                getattr(tree, f.name),
                None if axes_tree is None else getattr(axes_tree, f.name),
                rules, device_mesh, local_fn)
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _is_axes(x) -> bool:
    return isinstance(x, tuple)


def tree_specs(axes_tree: Any, rules: dict, mesh) -> Any:
    """An axes tree (nested dicts and lists with tuple leaves) mapped to
    the same tree of specs."""
    if _is_axes(axes_tree):
        return spec_for(axes_tree, rules, mesh)
    if isinstance(axes_tree, dict):
        return {k: tree_specs(v, rules, mesh) for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [tree_specs(v, rules, mesh) for v in axes_tree]
    raise TypeError(f"tree_specs: unexpected node {type(axes_tree)}")


def _dim_devices(part, mesh) -> int:
    if part is None:
        return 1
    total = 1
    for a in ((part,) if isinstance(part, str) else part):
        total *= mesh.shape[a]
    return total


def check_divisibility(shape: tuple[int, ...], spec: tuple, mesh) -> bool:
    """Every sharded dim divides evenly over its mesh axes."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return all(dim % _dim_devices(part, mesh) == 0
               for dim, part in zip(shape, spec))


def per_device_shape(shape: tuple[int, ...], spec: tuple,
                     mesh) -> tuple[int, ...]:
    """The shard one device holds: each sharded dim cut over its mesh
    axes, rounded up (an uneven dim pads its last shard)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-dim // _dim_devices(part, mesh))
                 for dim, part in zip(shape, spec))
