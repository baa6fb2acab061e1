"""The queue env's window scan, plain: the eager masked loop.

The reference's ``substep`` loop (``repro/core/queue_sim.py:563-654``),
written out step by step with the port's tensor laws over a leading env
axis: ``MAX_WINDOW`` = 128 steps, each masked past the env's
``eff_window`` (a masked step draws, but changes nothing). The CPU runs
this; on the card ``chip_smoke.py`` holds the CUDA kernel against it.

Also the kernel's operand layout: the columns of the packed tensors, in
the order of the enums in ``kernels/csrc/queue_window.cu``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.cost_model import WINDOW_CHOICES

MAX_WINDOW = max(WINDOW_CHOICES)

# scal (n, len(SCALARS)) float32
SCALARS = (
    "window", "eff_window", "step_pos", "util_on", "p_on", "p_off", "period",
    "burst_frac", "offset", "fixed_ms", "p_switch", "level_max",
    "shared_factor", "prof_severity", "prof_onset", "prof_duration",
    "prof_period", "prof_phase", "slope", "t_base", "slack", "alpha_rpc",
    "alpha_crit", "kappa_ar", "p_gpu_active", "p_gpu_idle", "p_cpu_base",
    "p_cpu_rpc", "rb_cpu", "rb_cpu_ref", "shared_backlog",
)
# ints (n, len(INTS)) int32
INTS = ("util_kind", "delta_kind", "victim", "archetype", "link_a", "link_b")
# own (n, len(OWNERS), P) float32
OWNERS = ("phase", "miss_work", "active", "miss_rows", "miss_work_ref",
          "active_ref", "rb_work_ref")
# the fabric state in and out, (n, len(STATE), P) float32
STATE = ("util_state", "delta_level", "backlog", "rb_backlog")
# out: acc (n, len(ACC)) and acc_own (n, len(ACC_OWNERS), P) float32
ACC = ("t", "e", "e_ref", "stall", "rb_wait", "n", "shared_backlog")
ACC_OWNERS = ("per_row", "active")


@dataclasses.dataclass(frozen=True)
class Volumes:
    """A decision's per-step volumes (``queue_sim.action_volumes`` and
    ``reference_volumes``, the memory spill applied): (n, P), the two
    ``rb_cpu`` (n,)."""

    miss_work: torch.Tensor
    active: torch.Tensor
    miss_rows: torch.Tensor
    miss_work_ref: torch.Tensor
    active_ref: torch.Tensor
    rb_work_ref: torch.Tensor
    rb_cpu: torch.Tensor
    rb_cpu_ref: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FabricState:
    """The fluid fabric's state: (n, P), ``shared_backlog`` (n,). Going in,
    ``rb_backlog`` holds the boundary's rebuild work already."""

    util_state: torch.Tensor
    delta_level: torch.Tensor
    backlog: torch.Tensor
    rb_backlog: torch.Tensor
    shared_backlog: torch.Tensor


def queue_window_plain(cfg, params, sc, vol: Volumes, fabric: FabricState,
                       uniforms: torch.Tensor, window: torch.Tensor,
                       eff_window: torch.Tensor, step_pos: torch.Tensor):
    """One window of every env: (the accumulators {t, e, e_ref, stall,
    rb_wait, n} (n,) and {per_row, active} (n, P), the new
    :class:`FabricState`). ``uniforms`` (n, MAX_WINDOW, 3, P) holds each
    step's Markov, step-trace resample and level draws."""
    # the env's laws live in queue_sim, which imports this package
    from repro_torch.core import domain_rand as dr
    from repro_torch.core import queue_sim as qs

    n, n_owners = fabric.backlog.shape
    slope = params.gamma_c / params.beta
    t_base = params.t_base
    slack = cfg.slack_steps * t_base
    step_cost = qs.make_step_cost(params, slope, t_base, slack,
                                  sc.shared_factor)
    util_state, delta_level = fabric.util_state, fabric.delta_level
    backlog, rb_backlog = fabric.backlog, fabric.rb_backlog
    shared_backlog = fabric.shared_backlog
    zeros = torch.zeros_like(backlog)
    acc = {k: torch.zeros_like(window) for k in
           ("t", "e", "e_ref", "stall", "rb_wait", "n")}
    acc["per_row"] = torch.zeros_like(backlog)
    acc["active"] = torch.zeros_like(backlog)
    active, miss_work = vol.active, vol.miss_work

    # past every env's eff_window a step changes nothing (the kernel's
    # threads stop there): one read of the longest, and the loop ends
    for i in range(min(MAX_WINDOW, int(torch.ceil(eff_window.max())))
                   if eff_window.numel() else 0):
        live = (i < eff_window).float()
        on = live[:, None] > 0
        step = step_pos + i
        u = uniforms[:, i]

        new_util_state = dr.markov_onoff_update(u[:, 0], util_state,
                                                sc.p_on, sc.p_off)
        new_delta_level = dr.step_trace_update(u[:, 1], u[:, 2], delta_level,
                                               sc.p_switch, sc.level_max)
        util_state = torch.where(on, new_util_state, util_state)
        delta_level = torch.where(on, new_delta_level, delta_level)

        util = qs._utilization(sc, util_state, step, n_owners)
        d = qs._delta(cfg, sc, delta_level, step)
        phi = (1.0 - util) / (1.0 + slope[:, None] * d)
        sigma_eff = 1.0 / phi
        ar = params.kappa_ar * torch.clamp(sigma_eff.amax(-1) - 1.0, min=0.0)

        # this step's cost: the miss fetch queues behind the link backlogs
        # (rebuild work FIFO ahead of earlier misses)
        t_step, stall, rb_leak, e_step, wall_o = step_cost(
            d, phi, ar, active, miss_work, backlog + rb_backlog,
            rb_backlog + backlog, torch.sign(rb_backlog.sum(-1)),
            shared_backlog, vol.rb_cpu, window)
        # the reference action's cost under the same (u, d): no carried
        # backlog, its rebuild work enters as the overlap leak only
        _, _, _, e_ref, _ = step_cost(
            d, phi, ar, vol.active_ref, vol.miss_work_ref, zeros,
            vol.rb_work_ref, 1.0, 0.0, vol.rb_cpu_ref, qs.REFERENCE_WINDOW)

        # the drain: during t_step each link serves phi * t_step of
        # clean-rate work, rebuild work first; what does not drain persists
        cap = phi * t_step[:, None]
        rb_served = torch.minimum(rb_backlog, cap)
        new_rb = rb_backlog - rb_served
        new_backlog = torch.clamp(
            backlog + active * miss_work - (cap - rb_served), min=0.0)
        new_shared = torch.where(
            sc.shared_factor > 0.0,
            torch.clamp(shared_backlog + (active * miss_work).sum(-1)
                        - torch.clamp(sc.shared_factor, min=1e-6) * t_step,
                        min=0.0),
            0.0)
        backlog = torch.where(on, new_backlog, backlog)
        rb_backlog = torch.where(on, new_rb, rb_backlog)
        shared_backlog = torch.where(live > 0, new_shared, shared_backlog)

        # per-owner per-row fetch latency, for the deployed estimator
        per_row = wall_o / torch.clamp(vol.miss_rows, min=1e-6)
        rb_wait = torch.minimum((rb_backlog / phi).amax(-1), stall)

        acc["t"] = acc["t"] + live * t_step
        acc["e"] = acc["e"] + live * e_step
        acc["e_ref"] = acc["e_ref"] + live * e_ref
        acc["stall"] = acc["stall"] + live * stall
        acc["rb_wait"] = acc["rb_wait"] + live * (rb_wait + rb_leak)
        acc["per_row"] = acc["per_row"] + live[:, None] * active * per_row
        acc["active"] = acc["active"] + live[:, None] * active
        acc["n"] = acc["n"] + live

    return acc, FabricState(util_state, delta_level, backlog, rb_backlog,
                            shared_backlog)
