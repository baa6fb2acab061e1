"""The queue env's window scan: the kernel wrapper.

The kernel, ``csrc/queue_window.cu``, has no Pallas counterpart: it is the
device loop XLA makes of the reference's ``lax.scan`` over ``substep``
(``repro/core/queue_sim.py:563-654``), one decision's 128 masked training
steps through the fluid fabric for every env of a batch, in one launch.
Eager PyTorch would take ~150 launches a step, ~19,000 a window.

:func:`queue_window` takes the window's inputs as the env holds them (its
config, the per-env parameters and scenario, the decision's
:class:`Volumes`, the :class:`FabricState` and the window's unit
uniforms) and returns the accumulators and the new fabric state. CPU
tensors take the plain version (``ref.queue_window_plain``); CUDA tensors
are packed (:func:`pack`: a few stacks, read nothing back) and launch the
kernel, or raise. The kernel takes at most ``MAX_OWNERS`` owners and
:func:`smem_bytes` of shared memory a block, checked for CUDA tensors
only. Launches count in ``queue_window.launches``.

Design: a block per env. Most of a step does not depend on the carried
backlogs, so the block stages the env's operands in shared memory once,
walks the chains a thread an owner, prices every backlog-free term (u, d,
phi and its reciprocal, the walls' free terms, the CPU term, the
reference action's cost) a thread a live step, scans the backlog
recurrence alone on one warp (each step's queue-reading divisions one a
lane, by nvcc's fast division path where it is exact, with a second pass
by ``/`` if an operand leaves its range), and sums per_row and the
rebuild wait in step order after it. It replaces a one-thread-an-env
loop (a 32-env batch was one warp on one SM) and gives its outputs bit
for bit. Instances: 1 to 4 owners exact, bounds of 8 and 16.

Bound: bytes. The least the function moves is its packed inputs, the
window's 3 x 128 x P uniforms an env and its outputs, each once: about
160 KB at 32 envs and P = 3, 0.05 us at 3.35 TB/s. Its operations, a few
hundred a step an env, take less. The recurrence sets the floor that
matters: 128 steps of a dependent chain of 23 operations and a shuffle
(P = 3), ~7.6 us at 1.98 GHz; the block per env runs the envs' chains
side by side, so a launch costs about one env's scan and its prologue.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.queue_window.ref import (  # noqa: F401
    ACC, ACC_OWNERS, INTS, MAX_WINDOW, OWNERS, SCALARS, STATE, FabricState,
    Volumes, queue_window_plain,
)

MAX_OWNERS = 16      # the kernel's largest owner bound
# the largest dynamic shared memory a block may take on the H100
MAX_SMEM = 227 * 1024
# the block's shared-memory slots (fluid_window.cuh's StepOwner and
# StepTerm): a step and owner's terms, then a step's
STEP_OWNER_TERMS = ("um", "uf", "uv", "util", "delta", "phi", "rcp",
                    "wall_free", "rtt_d", "arrive", "peer_free", "wall",
                    "rb_left")
STEP_TERMS = ("ar", "e_cpu", "e_ref", "t_step_r", "w_target", "w_vol",
              "vol_set", "boundary", "own_a", "own_phi", "wall_own",
              "peer_am", "stall", "rb_leak", "rb_wait")


def _check(sc, vol: Volumes, fabric: FabricState, uniforms, window,
           eff_window, step_pos) -> None:
    if uniforms.dim() != 4:
        raise ValueError("queue_window: uniforms must be (n, MAX_WINDOW, 3, "
                         f"P), got {tuple(uniforms.shape)}")
    n, _, _, p = uniforms.shape
    if uniforms.shape != (n, MAX_WINDOW, 3, p):
        raise ValueError(f"queue_window: uniforms {tuple(uniforms.shape)} "
                         f"must be (n, {MAX_WINDOW}, 3, P)")
    if not uniforms.is_contiguous():
        raise ValueError("queue_window: uniforms must be contiguous")
    per_owner = [uniforms, sc.phase] + [
        getattr(vol, k) for k in OWNERS[1:]
    ] + [getattr(fabric, k) for k in STATE]
    per_env = [window, eff_window, step_pos, vol.rb_cpu, vol.rb_cpu_ref,
               fabric.shared_backlog]
    for t in per_owner + per_env:
        if t.dtype != torch.float32:
            raise TypeError(f"queue_window: operands must be float32, got "
                            f"{t.dtype}")
        if t.device != uniforms.device:
            raise ValueError("queue_window: operands must be on one device")
    for t in per_owner[1:]:
        if t.shape != (n, p):
            raise ValueError(f"queue_window: a per-owner operand is "
                             f"{tuple(t.shape)}, not ({n}, {p})")
    for t in per_env:
        if t.shape != (n,):
            raise ValueError(f"queue_window: a per-env operand is "
                             f"{tuple(t.shape)}, not ({n},)")


def smem_bytes(p: int) -> int:
    """The kernel's dynamic shared memory a block (an env) at ``p`` owners:
    fluid_window.cuh's ``smem_bytes<false>``, the step and step-owner slots
    and the env's packed rows."""
    return 4 * (MAX_WINDOW * (len(STEP_OWNER_TERMS) * p + len(STEP_TERMS))
                + len(SCALARS) + (len(OWNERS) + len(STATE)) * p + len(INTS))


def check_kernel_operands(uniforms: torch.Tensor, smem=smem_bytes,
                          name: str = "queue_window") -> None:
    """What the CUDA kernel takes beyond :func:`_check`: 1 to
    ``MAX_OWNERS`` owners, and a block's shared memory (``smem(p)``)
    within ``MAX_SMEM``. A check of the operands' metadata, called for
    CUDA tensors only."""
    p = uniforms.shape[-1]
    if not 1 <= p <= MAX_OWNERS:
        raise ValueError(f"{name}: the CUDA kernel takes 1 to {MAX_OWNERS} "
                         f"owners, not {p}")
    if smem(p) > MAX_SMEM:
        raise ValueError(f"{name}: the CUDA kernel needs {smem(p)} bytes of "
                         f"shared memory a block at {p} owners, more than "
                         f"{MAX_SMEM}")


def pack(cfg, params, sc, vol: Volumes, fabric: FabricState, window,
         eff_window, step_pos):
    """The kernel's packed operands (scal, ints, own, state), contiguous,
    in the layouts of ``ref.SCALARS``, ``INTS``, ``OWNERS`` and ``STATE``."""
    prof = sc.profile
    cols = {
        "window": window, "eff_window": eff_window, "step_pos": step_pos,
        "util_on": sc.util_on, "p_on": sc.p_on, "p_off": sc.p_off,
        "period": sc.period, "burst_frac": sc.burst_frac,
        "offset": sc.offset, "fixed_ms": sc.fixed_ms,
        "p_switch": sc.p_switch, "level_max": sc.level_max,
        "shared_factor": sc.shared_factor,
        "prof_severity": prof.severity_ms, "prof_onset": prof.onset,
        "prof_duration": prof.duration, "prof_period": prof.period,
        "prof_phase": prof.phase,
        "slope": params.gamma_c / params.beta, "t_base": params.t_base,
        "slack": cfg.slack_steps * params.t_base,
        "alpha_rpc": params.alpha_rpc, "alpha_crit": params.alpha_crit,
        "kappa_ar": params.kappa_ar, "p_gpu_active": params.p_gpu_active,
        "p_gpu_idle": params.p_gpu_idle, "p_cpu_base": params.p_cpu_base,
        "p_cpu_rpc": params.p_cpu_rpc, "rb_cpu": vol.rb_cpu,
        "rb_cpu_ref": vol.rb_cpu_ref,
        "shared_backlog": fabric.shared_backlog,
    }
    ints = {"util_kind": sc.util_kind, "delta_kind": sc.delta_kind,
            "victim": sc.victim, "archetype": prof.archetype,
            "link_a": prof.link_a, "link_b": prof.link_b}
    own = {"phase": sc.phase, **{k: getattr(vol, k) for k in OWNERS[1:]}}
    return (torch.stack([cols[k] for k in SCALARS], dim=1),
            torch.stack([ints[k] for k in INTS], dim=1).to(torch.int32),
            torch.stack([own[k] for k in OWNERS], dim=1),
            torch.stack([getattr(fabric, k) for k in STATE], dim=1))


def queue_window(cfg, params, sc, vol: Volumes, fabric: FabricState,
                 uniforms: torch.Tensor, window: torch.Tensor,
                 eff_window: torch.Tensor, step_pos: torch.Tensor):
    """One window of every env: (the accumulators {t, e, e_ref, stall,
    rb_wait, n} (n,) and {per_row, active} (n, P), the new
    :class:`FabricState`). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    _check(sc, vol, fabric, uniforms, window, eff_window, step_pos)
    if uniforms.device.type == "cpu":
        return queue_window_plain(cfg, params, sc, vol, fabric, uniforms,
                                  window, eff_window, step_pos)
    if uniforms.device.type not in ("cuda", "meta"):
        raise ValueError(f"queue_window: unsupported device "
                         f"{uniforms.device}")
    check_kernel_operands(uniforms)
    scal, ints, own, state = pack(cfg, params, sc, vol, fabric, window,
                                  eff_window, step_pos)
    n, p = fabric.backlog.shape
    acc = torch.empty((n, len(ACC)), device=uniforms.device)
    acc_own = torch.empty((n, len(ACC_OWNERS), p), device=uniforms.device)
    state_out = torch.empty_like(state)
    launch(scal, ints, own, state, uniforms, acc, acc_own, state_out,
           cfg.n_epochs, cfg.steps_per_epoch)
    return unpack(acc, acc_own, state_out)


def unpack(acc, acc_own, state_out):
    """The kernel's outputs as :func:`queue_window` returns them (views)."""
    out = {k: acc[:, j] for j, k in enumerate(ACC) if k != "shared_backlog"}
    out.update({k: acc_own[:, j] for j, k in enumerate(ACC_OWNERS)})
    fabric = FabricState(
        *(state_out[:, j] for j in range(len(STATE))),
        shared_backlog=acc[:, ACC.index("shared_backlog")])
    return out, fabric


def launch(scal, ints, own, state, uniforms, acc, acc_own, state_out,
           n_epochs: int, steps_per_epoch: int) -> None:
    """Launch the kernel on packed, checked operands (counts one
    launch). Every launch charges the bytes of its operands and outputs
    to the active counters (``_build.count_launch``; no matrix-class
    FLOPs: the window's steps are scalar recurrences); on ``meta`` the
    charge stands in for the launch."""
    work = (0.0, _build.tensor_bytes(
        scal, ints, own, state, uniforms, acc, acc_own, state_out))
    if uniforms.device.type == "meta":
        _build.charge(queue_window, *work)
        return
    fn = _build.entry("queue_window_f32")
    n, p = state.shape[0], state.shape[2]
    err = fn(scal.data_ptr(), ints.data_ptr(), own.data_ptr(),
             state.data_ptr(), uniforms.data_ptr(), acc.data_ptr(),
             acc_own.data_ptr(), state_out.data_ptr(), n, p, n_epochs,
             steps_per_epoch,
             torch.cuda.current_stream(uniforms.device).cuda_stream)
    _build.count_launch(queue_window, *work)
    _build.check("queue_window_f32", err)


queue_window.launches = 0
queue_window.launches_by_thread = {}
