"""Logical-axis sharding rules for parameters and activations, as specs.

Port of ``repro/distributed/sharding.py`` without JAX: a spec is a plain
tuple (one entry a dim: a mesh axis name, a tuple of names, or None for
replicated) where the reference builds a ``PartitionSpec``, and a mesh is
``launch.mesh.Mesh`` (its ``axis_names`` and ``shape``). Models annotate
parameters with logical axis names (``init``'s axes trees); a rule table
maps logical names to mesh axes. The port runs on one card, so nothing is
sharded: the specs serve the dry-run's per-device sizes
(``launch.dryrun``), and :func:`shard_activation` is the identity.

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
            axes = tuple(a for a in axes if a in mesh.axis_names)
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        if not axes:
            parts.append(None)
        elif len(axes) == 1:
            parts.append(axes[0])
        else:
            parts.append(axes)
    return tuple(parts)


def shard_activation(x, logical_axes: Sequence[Optional[str]]):
    """The identity: one card shards no activation (the reference's
    ``with_sharding_constraint`` is a no-op without rules, too)."""
    return x


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
