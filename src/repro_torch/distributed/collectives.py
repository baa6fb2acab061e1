"""Collective helpers over the P ranks' trees, and the host-side cost
model of the per-step gradient sync (cluster runtime).

Port of ``repro/distributed/collectives.py``. The reference writes its
helpers (``psum_tree``, ``pmean_tree``, ``reduce_scatter_tree``,
``all_gather_rows``, ``deferred_grad_sync``) against ``jax.lax``
collectives for shard_map bodies. The port's cluster runs its P ranks on
threads of one process (``train/cluster.py``), so each helper here is a
host-side function over the list of the P ranks' trees (nested dicts or
lists of tensors), in rank order, returning the list of what each rank
receives: what the ``jax.lax`` collective computes over an axis of size
P. None of them calls ``torch.distributed``; sums run in rank order.
Ranks that receive the same value receive the same tree object.

Each also has a form over one dim of a ``torch.distributed``
``DeviceMesh`` (``psum_over``, ``pmean_over``, ``reduce_scatter_over``,
``all_gather_rows_over``, ``deferred_grad_sync_over``): called on every
rank with that rank's tree, it returns what the rank receives, by the
functional collectives (``torch.distributed._functional_collectives``)
over the ranks that share the rank's other mesh coordinates: the
reference's helpers as they run in a ``shard_map`` body.

``ring_collective_cost``: the cluster runs its P trainers on one
virtual clock, so it charges each step the ring algorithm's cost instead
of running a collective: a ring all-reduce moves 2*(P-1) chunks of |g|/P
bytes per worker (a reduce-scatter phase and an all-gather phase); a
reduce-scatter (ZeRO) stops after the first phase and halves the wire
bytes.
"""
from __future__ import annotations

import functools
import operator

import torch
from torch.utils._pytree import tree_map


def _check_ranks(trees: list) -> int:
    if not trees:
        raise ValueError("collectives: no ranks")
    return len(trees)


def psum_tree(trees: list) -> list:
    """Every rank receives the sum of the P ranks' trees."""
    p = _check_ranks(trees)
    total = tree_map(lambda *xs: functools.reduce(operator.add, xs), *trees)
    return [total] * p


def pmean_tree(trees: list) -> list:
    """Every rank receives the mean of the P ranks' trees."""
    p = _check_ranks(trees)
    mean = tree_map(lambda x: x / p, psum_tree(trees)[0])
    return [mean] * p


def _rows_of(x: torch.Tensor, r: int, p: int) -> torch.Tensor:
    if x.shape[0] % p:
        raise ValueError(f"reduce_scatter: dim 0 ({x.shape[0]}) is not a "
                         f"multiple of the {p} ranks")
    n = x.shape[0] // p
    return x[r * n:(r + 1) * n]


def reduce_scatter_tree(trees: list) -> list:
    """Rank r receives rows ``[r n / P, (r + 1) n / P)`` of the sum of
    every leaf (dim 0 of n rows): half the wire bytes of a full all-reduce
    (ZeRO gradient sync); ``jax.lax.psum_scatter(..., tiled=True)``."""
    p = _check_ranks(trees)
    total = psum_tree(trees)[0]
    return [tree_map(lambda x, r=r: _rows_of(x, r, p), total)
            for r in range(p)]


def all_gather_rows(xs: list) -> list:
    """Every rank receives the ranks' row blocks joined along dim 0, in
    rank order (the cache-rebuild fetch);
    ``jax.lax.all_gather(..., axis=0, tiled=True)``."""
    p = _check_ranks(xs)
    return [torch.cat(list(xs), dim=0)] * p


def deferred_grad_sync(unreduced: list, scatter: bool = True) -> list:
    """The ranks' gradients, accumulated without per-microbatch syncs,
    reduced once a step: a reduce-scatter when the optimizer state is
    sharded across the ranks (ZeRO), else an all-reduce."""
    if scatter:
        return reduce_scatter_tree(unreduced)
    return psum_tree(unreduced)


# ------------------------------------------------ over a DeviceMesh dim
def _group(device_mesh, mesh_dim):
    """The functional collectives' group of ``device_mesh``'s dim
    ``mesh_dim`` (its index or its name)."""
    if isinstance(mesh_dim, str):
        mesh_dim = device_mesh.mesh_dim_names.index(mesh_dim)
    return device_mesh, mesh_dim


def psum_over(tree, device_mesh, mesh_dim):
    """Each leaf summed over the ranks along ``mesh_dim``
    (``jax.lax.psum``)."""
    import torch.distributed._functional_collectives as funcol

    group = _group(device_mesh, mesh_dim)
    return tree_map(lambda x: funcol.all_reduce(x, "sum", group), tree)


def pmean_over(tree, device_mesh, mesh_dim):
    """Each leaf's mean over the ranks along ``mesh_dim``
    (``jax.lax.pmean``)."""
    n = device_mesh.size(_group(device_mesh, mesh_dim)[1])
    return tree_map(lambda x: x / n, psum_over(tree, device_mesh, mesh_dim))


def reduce_scatter_over(tree, device_mesh, mesh_dim):
    """Each leaf summed over the ranks along ``mesh_dim``, this rank
    keeping its block of dim 0 (``jax.lax.psum_scatter(...,
    scatter_dimension=0, tiled=True)``)."""
    import torch.distributed._functional_collectives as funcol

    group = _group(device_mesh, mesh_dim)
    n = device_mesh.size(group[1])

    def one(x):
        if x.shape[0] % n:
            raise ValueError(f"reduce_scatter: dim 0 ({x.shape[0]}) is not "
                             f"a multiple of the {n} ranks")
        return funcol.reduce_scatter_tensor(x, "sum", 0, group)

    return tree_map(one, tree)


def all_gather_rows_over(x: torch.Tensor, device_mesh, mesh_dim):
    """The ranks' row blocks along ``mesh_dim`` joined along dim 0, in
    rank order (``jax.lax.all_gather(..., axis=0, tiled=True)``)."""
    import torch.distributed._functional_collectives as funcol

    return funcol.all_gather_tensor(x, 0, _group(device_mesh, mesh_dim))


def deferred_grad_sync_over(unreduced, device_mesh, mesh_dim,
                            scatter: bool = True):
    """:func:`deferred_grad_sync` over ``mesh_dim``: a reduce-scatter
    when the optimizer state is sharded across the ranks, else an
    all-reduce."""
    if scatter:
        return reduce_scatter_over(unreduced, device_mesh, mesh_dim)
    return psum_over(unreduced, device_mesh, mesh_dim)


def ring_collective_cost(
    n_workers: int,
    grad_bytes: float,
    params,
    scatter: bool = False,
) -> tuple[float, float, float, int]:
    """(wall_s, cpu_s, wire_bytes, n_msgs) of one per-step gradient sync.

    Each of the ``(P-1) * (1 if scatter else 2)`` ring phases sends one
    ``grad_bytes / P`` chunk over a link modeled with the calibrated Eq. 4
    constants (initiation ``alpha_rpc`` + serialization ``beta``); phases
    are serialized (ring dependency), chunks within a phase are concurrent
    across workers. CPU time additionally covers the reduction arithmetic,
    folded into the same per-byte constant.
    """
    if n_workers <= 1 or grad_bytes <= 0:
        return 0.0, 0.0, 0.0, 0
    phases = (n_workers - 1) * (1 if scatter else 2)
    chunk = float(grad_bytes) / n_workers
    per_phase = float(params.alpha_rpc) + float(params.beta) * chunk
    wall = phases * per_phase
    # per-worker CPU: the send (per_phase) plus the elementwise combine of
    # the received chunk, folded into the same per-byte constant
    cpu = phases * (per_phase + float(params.beta) * chunk)
    return wall, cpu, phases * chunk, phases
