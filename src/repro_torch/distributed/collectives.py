"""Host-side cost model of the per-step gradient sync (cluster runtime).

Port of ``repro/distributed/collectives.py::ring_collective_cost``. The
cluster driver (``train/cluster.py``) runs its P trainers on one virtual
clock, so it charges each step the ring algorithm's cost instead of running
a collective: a ring all-reduce moves 2*(P-1) chunks of |g|/P bytes per
worker (a reduce-scatter phase and an all-gather phase); a reduce-scatter
(ZeRO) stops after the first phase and halves the wire bytes.

The reference's ``jax.lax`` shard_map helpers (``psum_tree``,
``pmean_tree``, ``reduce_scatter_tree``, ``all_gather_rows``,
``deferred_grad_sync``) have no caller outside their own file; they belong
to the mesh tooling, whose port is a single-GPU FLOP and byte counter
(ROADMAP queue 1 item 7), and are not ported as ``torch.distributed``
calls: the reference runs no collective on this path either.
"""
from __future__ import annotations


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
