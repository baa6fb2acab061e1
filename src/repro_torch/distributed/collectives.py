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
