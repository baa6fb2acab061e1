"""The cluster env's window scan: the kernel wrapper.

The kernel, ``csrc/cluster_window.cu``, has no Pallas counterpart: it is
the device loop XLA makes of the reference's ``lax.scan`` over
``substep`` (``repro/envs/cluster_sim.py:383-545``), one decision's 128
masked training steps of the P-requester twin for every env of a batch,
in one launch. It runs the queue env's window code
(``csrc/fluid_window.cuh``, which ``csrc/queue_window.cu`` runs too) with
the cluster's terms switched on, so with no live peer and clean factors
its outputs are the ``queue_window`` kernel's bit for bit.

:func:`cluster_window` takes what ``queue_window`` takes (the ego's
parameters, its compute-scaled ``t_base`` in place, and the injected
overlay's scenario) plus the window's :class:`Peers` and the carried
:class:`PeerState`, and returns the accumulators, the new fabric state and
the new peer state. CPU tensors take the plain version
(``ref.cluster_window_plain``); CUDA tensors are packed (the queue
window's four tensors and two of the peers') and launch the kernel, or
raise. The kernel takes at most ``MAX_OWNERS`` owners and
:func:`smem_bytes` of shared memory a block, checked for CUDA tensors
only. Launches count in ``cluster_window.launches``.

Design: the queue window's block per env (the operands staged once, the
chains, the backlog-free terms step-parallel, the backlog recurrence
alone on one warp), plus the peers: their w_target a step in the
prologue, their window walked by one thread (a select chain), their
volumes, arrivals and backlog-free wall a thread a step; the scan adds
the peer wall (one more division item a lane), the barrier and the
collective. It replaces a one-thread-an-env loop and gives its outputs
bit for bit.

Bound: bytes. The least the function moves is its packed inputs, the
window's 3 x 128 x P uniforms an env and its outputs, each once: about
165 KB at 32 envs and P = 3, 0.05 us at 3.35 TB/s. Its operations, a few
hundred a step an env, take less. The recurrence sets the floor that
matters: the queue window's chain with the peer wall's maximum, the
barrier and the peer drain in it, 30 dependent operations and a shuffle
a step at P = 3, ~9.4 us for 128 steps at 1.98 GHz; the envs' chains run
side by side, a block each.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cluster_window.ref import (  # noqa: F401
    PEER_OWNERS, PEER_SCALARS, PEER_STATE, Peers, PeerState,
    cluster_window_plain,
)
from repro_torch.kernels.queue_window import ops as qw
from repro_torch.kernels.queue_window.ref import (
    ACC, ACC_OWNERS, FabricState,
)

MAX_OWNERS = qw.MAX_OWNERS


def _check(sc, vol, fabric, peers: Peers, peer_state: PeerState, uniforms,
           window, eff_window, step_pos) -> None:
    qw._check(sc, vol, fabric, uniforms, window, eff_window, step_pos)
    n, p = fabric.backlog.shape
    per_owner = [getattr(peers, k) for k in PEER_OWNERS[:-1]] + [
        peer_state.peer_backlog]
    per_env = [peers.n_live, peers.own_scale, peers.reactive,
               peers.coll_wall, peers.coll_cpu, peer_state.peer_left,
               peer_state.peer_window]
    for t in per_owner + per_env:
        if t.dtype != torch.float32:
            raise TypeError(f"cluster_window: operands must be float32, got "
                            f"{t.dtype}")
        if t.device != uniforms.device:
            raise ValueError("cluster_window: operands must be on one "
                             "device")
    for t in per_owner:
        if t.shape != (n, p):
            raise ValueError(f"cluster_window: a per-owner operand is "
                             f"{tuple(t.shape)}, not ({n}, {p})")
    for t in per_env:
        if t.shape != (n,):
            raise ValueError(f"cluster_window: a per-env operand is "
                             f"{tuple(t.shape)}, not ({n},)")


def smem_bytes(p: int) -> int:
    """The kernel's dynamic shared memory a block (an env) at ``p`` owners:
    fluid_window.cuh's ``smem_bytes<true>``, the queue window's and the
    env's peer rows."""
    return qw.smem_bytes(p) + 4 * (len(PEER_SCALARS) + len(PEER_OWNERS) * p)


def check_kernel_operands(uniforms: torch.Tensor) -> None:
    """What the CUDA kernel takes beyond :func:`_check`: 1 to
    ``MAX_OWNERS`` owners and :func:`smem_bytes` within
    ``qw.MAX_SMEM``. A check of the operands' metadata, called for CUDA
    tensors only."""
    qw.check_kernel_operands(uniforms, smem_bytes, "cluster_window")


def pack_peers(params, peers: Peers, peer_state: PeerState):
    """The kernel's peer operands (pscal, pown), contiguous, in the
    layouts of ``ref.PEER_SCALARS`` and ``PEER_OWNERS``."""
    cols = {**{k: getattr(peers, k) for k in PEER_SCALARS[:5]},
            **{k: getattr(params, k) for k in PEER_SCALARS[5:13]},
            "peer_left": peer_state.peer_left,
            "peer_window": peer_state.peer_window}
    own = {**{k: getattr(peers, k) for k in PEER_OWNERS[:-1]},
           "peer_backlog": peer_state.peer_backlog}
    return (torch.stack([cols[k] for k in PEER_SCALARS], dim=1),
            torch.stack([own[k] for k in PEER_OWNERS], dim=1))


def cluster_window(cfg, params, sc, vol, fabric: FabricState, peers: Peers,
                   peer_state: PeerState, uniforms: torch.Tensor,
                   window: torch.Tensor, eff_window: torch.Tensor,
                   step_pos: torch.Tensor):
    """One window of every env: (the accumulators {t, e, e_ref, stall,
    rb_wait, n} (n,) and {per_row, active} (n, P), the new
    :class:`FabricState`, the new :class:`PeerState`). CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    _check(sc, vol, fabric, peers, peer_state, uniforms, window, eff_window,
           step_pos)
    if uniforms.device.type == "cpu":
        return cluster_window_plain(cfg, params, sc, vol, fabric, peers,
                                    peer_state, uniforms, window, eff_window,
                                    step_pos)
    if uniforms.device.type not in ("cuda", "meta"):
        raise ValueError(f"cluster_window: unsupported device "
                         f"{uniforms.device}")
    check_kernel_operands(uniforms)
    scal, ints, own, state = qw.pack(cfg, params, sc, vol, fabric, window,
                                     eff_window, step_pos)
    pscal, pown = pack_peers(params, peers, peer_state)
    out = outputs(state)
    launch(scal, ints, own, state, uniforms, pscal, pown, *out,
           cfg.n_epochs, cfg.steps_per_epoch)
    return unpack(*out)


def outputs(state: torch.Tensor):
    """Empty output tensors for packed ``state`` (n, len(STATE), P): acc,
    acc_own, state_out, pstate_out and the peer backlog out."""
    n, _, p = state.shape
    dev = state.device
    return (torch.empty((n, len(ACC)), device=dev),
            torch.empty((n, len(ACC_OWNERS), p), device=dev),
            torch.empty_like(state),
            torch.empty((n, len(PEER_STATE)), device=dev),
            torch.empty((n, p), device=dev))


def unpack(acc, acc_own, state_out, pstate_out, pback_out):
    """The kernel's outputs as :func:`cluster_window` returns them
    (views)."""
    out, fabric = qw.unpack(acc, acc_own, state_out)
    return out, fabric, PeerState(
        pback_out, *(pstate_out[:, j] for j in range(len(PEER_STATE))))


def launch(scal, ints, own, state, uniforms, pscal, pown, acc, acc_own,
           state_out, pstate_out, pback_out, n_epochs: int,
           steps_per_epoch: int) -> None:
    """Launch the kernel on packed, checked operands (counts one
    launch). Every launch charges the bytes of its operands and outputs
    to the active counters (``_build.count_launch``; no matrix-class
    FLOPs: the window's steps are scalar recurrences); on ``meta`` the
    charge stands in for the launch."""
    work = (0.0, _build.tensor_bytes(
        scal, ints, own, state, uniforms, pscal, pown, acc, acc_own,
        state_out, pstate_out, pback_out))
    if uniforms.device.type == "meta":
        _build.charge(cluster_window, *work)
        return
    fn = _build.entry("cluster_window_f32")
    n, p = state.shape[0], state.shape[2]
    err = fn(scal.data_ptr(), ints.data_ptr(), own.data_ptr(),
             state.data_ptr(), uniforms.data_ptr(), pscal.data_ptr(),
             pown.data_ptr(), acc.data_ptr(), acc_own.data_ptr(),
             state_out.data_ptr(), pstate_out.data_ptr(),
             pback_out.data_ptr(), n, p, n_epochs, steps_per_epoch,
             torch.cuda.current_stream(uniforms.device).cuda_stream)
    _build.count_launch(cluster_window, *work)
    _build.check("cluster_window_f32", err)


def as_dict(acc, fabric: FabricState, peer_state: PeerState) -> dict:
    """Every output of a window by name (a comparison's view)."""
    out = dict(acc)
    for x in (fabric, peer_state):
        out.update({f.name: getattr(x, f.name)
                    for f in dataclasses.fields(x)})
    return out


cluster_window.launches = 0
cluster_window.launches_by_thread = {}
