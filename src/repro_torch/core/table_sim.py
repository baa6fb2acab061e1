"""Trace-calibrated tabular simulator (Algorithm 1, taken to its logical
end), batched.

Port of ``repro/core/table_sim.py``. Phase 2 is calibrated *tabularly*:
:func:`measure_table` replays the real access trace through the real
cache once per (window, allocation-template) pair and records the
congestion-independent cache properties

    miss_rows[W_idx, alloc_idx, owner]     mean per-step rows missed per owner
    miss_active[...]                       P(any miss to owner) per step
    rebuild_rows[...]                      mean rows fetched per rebuild
    rebuild_active[...]                    P(any fetch) per rebuild
    hit[...]                               per-owner hit rates

while the delta-dependence stays analytic through the fitted RPC law (Eq.
4 + RTT), as in the trace-driven trainer. :func:`measure_table` is numpy
over the port's cache, bit-equal to the reference's.

The MDP interface mirrors ``core/simulator.py`` (the same :class:`Draws`
seam, a leading env axis on every tensor), so the same Double-DQN trains
on either. A pool of tables is (n_pool, N_W, N_A, P-1); each env carries
its entry, and a step reads ``[w_idx, a_idx]`` of it by advanced indexing
on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import controller as ctl
from repro_torch.core import cost_model as cm
from repro_torch.core import domain_rand as dr
from repro_torch.core.simulator import Draws, delta_now, remaining_frac

N_W = len(cm.WINDOW_CHOICES)
REF_W_IDX = 4   # W=16
REF_A_IDX = 0   # uniform


@dataclasses.dataclass(frozen=True)
class TableParams:
    """Calibrated tables + RPC law + power model (theta_sim, tabular form).

    From :func:`make_table_params` the tables are float32 CPU tensors and
    the rest numbers; ``train.policy.make_params_pool`` stacks entries
    into float32 tensors with a leading pool axis on a device."""

    miss_rows: torch.Tensor      # (N_W, N_A, P-1) mean rows missed / step
    miss_active: torch.Tensor    # (N_W, N_A, P-1) P(any miss to owner) / step
    rebuild_rows: torch.Tensor   # (N_W, N_A, P-1) mean rows fetched / rebuild
    rebuild_active: torch.Tensor  # (N_W, N_A, P-1) P(any fetch) / rebuild
    hit: torch.Tensor            # (N_W, N_A, P-1)
    t_base: torch.Tensor | float = 0.010
    alpha_rpc: torch.Tensor | float = cm.PAPER_ALPHA_RPC_S
    beta: torch.Tensor | float = cm.PAPER_BETA_S_PER_BYTE
    gamma_c: torch.Tensor | float = cm.PAPER_GAMMA_C
    feature_bytes: torch.Tensor | float = 400.0
    slack: torch.Tensor | float = 0.040          # prefetch depth * t_base
    alpha_crit: torch.Tensor | float = 0.12
    kappa_ar: torch.Tensor | float = 1.5e-3
    p_gpu_idle: torch.Tensor | float = 35.0
    p_gpu_active: torch.Tensor | float = 75.0
    p_cpu_base: torch.Tensor | float = 325.0
    p_cpu_rpc: torch.Tensor | float = 260.0


def measure_table(
    remote_trace: list[np.ndarray],
    owner_idx_of: np.ndarray,
    capacity: int,
    n_owners: int,
) -> dict:
    """Replay the trace through the double-buffered cache for every
    (window, allocation) pair. Returns the five calibration tables."""
    from repro_torch.core.windowed_cache import CacheStats, DoubleBufferedCache

    n_a = n_owners + 1
    miss_rows = np.zeros((N_W, n_a, n_owners))
    miss_active = np.zeros((N_W, n_a, n_owners))
    rebuild_rows = np.zeros((N_W, n_a, n_owners))
    rebuild_active = np.zeros((N_W, n_a, n_owners))
    hit = np.zeros((N_W, n_a, n_owners))
    n_steps = len(remote_trace)
    for wi, w in enumerate(cm.WINDOW_CHOICES):
        for ai in range(n_a):
            weights = ctl.allocation_weights(ai, n_owners)
            cache = DoubleBufferedCache(capacity, owner_idx_of, n_owners)
            stats = CacheStats()
            per_owner_miss = np.zeros(n_owners)
            active_steps = np.zeros(n_owners)
            fetched, rb_active, n_rebuilds = (
                np.zeros(n_owners), np.zeros(n_owners), 0,
            )
            for s in range(0, n_steps, w):
                win = remote_trace[s: s + w]
                plan = cache.plan_window(win, weights)
                fetched += plan.per_owner_fetched
                rb_active += (plan.per_owner_fetched > 0).astype(float)
                n_rebuilds += 1
                cache.swap(plan)
                for batch in win:
                    miss = cache.access(batch, stats)
                    if len(miss):
                        counts = np.bincount(
                            owner_idx_of[miss], minlength=n_owners
                        )
                        per_owner_miss += counts
                        active_steps += (counts > 0).astype(float)
            miss_rows[wi, ai] = per_owner_miss / n_steps
            miss_active[wi, ai] = active_steps / n_steps
            rebuild_rows[wi, ai] = fetched / max(n_rebuilds, 1)
            rebuild_active[wi, ai] = rb_active / max(n_rebuilds, 1)
            hit[wi, ai] = stats.per_owner_hit_rates()
    return {"miss_rows": miss_rows, "miss_active": miss_active,
            "rebuild_rows": rebuild_rows, "rebuild_active": rebuild_active,
            "hit": hit}


def make_table_params(tables: dict, **kw) -> TableParams:
    def f32(name):
        return torch.as_tensor(np.asarray(tables[name], np.float32))

    return TableParams(
        miss_rows=f32("miss_rows"), miss_active=f32("miss_active"),
        rebuild_rows=f32("rebuild_rows"),
        rebuild_active=f32("rebuild_active"), hit=f32("hit"), **kw,
    )


# ------------------------------------------------------------------ dynamics
# Batched: ``params`` fields are (n,) and the tables (n, N_W, N_A, P-1).

def _fetch_terms(params: TableParams, rows, active, delta):
    """Per-owner (wall, cpu) bulk-RPC terms, (n, P-1) each.

    ``active`` is the *measured* fraction of steps with any fetch to that
    owner: the fixed initiation cost and the injected RTT are paid only
    then. wall = what the resolver waits on; cpu = Eq. 4 processing work,
    the trainer's decomposition."""
    payload = rows * params.feature_bytes[:, None]
    payload_t = params.beta[:, None] * payload \
        + params.gamma_c[:, None] * payload * delta
    cpu = active * params.alpha_rpc[:, None] + payload_t
    wall = cpu + active * cm.PROP_RTT_BULK_S_PER_MS * delta
    return wall, cpu


def step_time_energy(params: TableParams, w_idx: torch.Tensor,
                     a_idx: torch.Tensor, delta: torch.Tensor):
    """(t_step (n,), e_step (n,), aux) for one training step per env
    under its tables; ``w_idx``/``a_idx`` (n,) or numbers."""
    n = params.t_base.shape[0]
    rows_n = torch.arange(n, device=params.t_base.device)
    if not isinstance(w_idx, torch.Tensor):
        w_idx = torch.full_like(rows_n, int(w_idx))
        a_idx = torch.full_like(rows_n, int(a_idx))
    window = ctl.window_choices(rows_n.device)[w_idx]

    def entry(table):
        return table[rows_n, w_idx, a_idx]

    wall_o, cpu_o = _fetch_terms(params, entry(params.miss_rows),
                                 entry(params.miss_active), delta)
    stall = torch.clamp(wall_o.amax(-1) - params.slack, min=0.0)
    rb_wall, rb_cpu = _fetch_terms(params, entry(params.rebuild_rows),
                                   entry(params.rebuild_active), delta)
    rebuild_stall = params.alpha_crit * rb_wall.amax(-1) / window
    sigma = cm.sigma_from_delta_t(params, delta)
    ar = cm.allreduce_penalty_t(params, sigma)

    t_stall = stall + rebuild_stall + ar
    t_step = params.t_base + t_stall
    cpu_comm = cpu_o.sum(-1) + rb_cpu.sum(-1) / window
    e_step = (
        params.p_gpu_active * params.t_base
        + params.p_gpu_idle * t_stall
        + params.p_cpu_base * t_step
        + params.p_cpu_rpc * cpu_comm
    )
    aux = {
        "stall": stall,
        "rebuild_frac": rebuild_stall / t_step,
        "miss_frac": stall / t_step,
        "sigma": sigma,
        "hit": entry(params.hit),
    }
    return t_step, e_step, aux


@dataclasses.dataclass(frozen=True)
class EnvState:
    profile: dr.CongestionProfile
    params: TableParams
    step_pos: torch.Tensor
    prev_w_idx: torch.Tensor
    prev_a_idx: torch.Tensor
    obs: torch.Tensor
    done: torch.Tensor
    total_energy: torch.Tensor
    total_time: torch.Tensor


def _observe(cfg, params, noise, delta, w_idx, a_idx, step_pos):
    """(obs, e_step, t_step, e_ref) of one window under ``delta``."""
    noise_sigma, noise_e, noise_h = noise
    t_step, e_step, aux = step_time_energy(params, w_idx, a_idx, delta)
    e_ref = step_time_energy(params, REF_W_IDX, REF_A_IDX, delta)[1]
    noisy_sigma = aux["sigma"] * noise_sigma
    noisy_h = torch.clamp(aux["hit"] * noise_h, 0.0, 1.0)
    noisy_e = e_step * noise_e
    window = ctl.window_choices(w_idx.device)[w_idx]
    weights = ctl.allocation_weights_t(a_idx, cfg.n_owners)
    obs = ctl.build_state_t(
        noisy_sigma, noisy_h, noisy_h.mean(-1), t_step, params.t_base,
        aux["rebuild_frac"], aux["miss_frac"], noisy_e, e_ref,
        remaining_frac(cfg, step_pos), window, weights,
    )
    return obs, e_step, t_step, e_ref


def reset(cfg, draws: Draws, params: TableParams) -> EnvState:
    """Fresh episodes, one per entry of ``params``."""
    n = params.t_base.shape[0]
    dev = params.t_base.device
    profile = draws.profile(cfg, n)
    w_idx = torch.full((n,), REF_W_IDX, device=dev)
    a_idx = torch.full((n,), REF_A_IDX, device=dev)
    zero = torch.zeros(n, device=dev)
    obs, _, _, _ = _observe(cfg, params, draws.noise(cfg, n),
                            delta_now(cfg, profile, zero), w_idx, a_idx,
                            zero)
    return EnvState(
        profile=profile, params=params, step_pos=zero, prev_w_idx=w_idx,
        prev_a_idx=a_idx, obs=obs,
        done=torch.zeros(n, dtype=torch.bool, device=dev),
        total_energy=zero, total_time=zero,
    )


def step(cfg, state: EnvState, action: torch.Tensor, draws: Draws):
    """One MDP decision per env: (state', obs, reward, done)."""
    n_a = cfg.n_owners + 1
    w_idx = action // n_a
    a_idx = action % n_a
    window = ctl.window_choices(action.device)[w_idx]
    mid = state.step_pos + 0.5 * window
    delta = delta_now(cfg, state.profile, mid)

    new_pos = state.step_pos + window
    obs, e_step, t_step, e_ref = _observe(
        cfg, state.params, draws.noise(cfg, action.shape[0]), delta, w_idx,
        a_idx, new_pos,
    )
    prev_w = ctl.allocation_weights_t(state.prev_a_idx, cfg.n_owners)
    cur_w = ctl.allocation_weights_t(a_idx, cfg.n_owners)
    reward = -e_step / e_ref \
        - ctl.LAMBDA_THRASH * torch.abs(cur_w - prev_w).sum(-1)

    done = new_pos >= cfg.total_steps
    new_state = EnvState(
        profile=state.profile, params=state.params, step_pos=new_pos,
        prev_w_idx=w_idx, prev_a_idx=a_idx, obs=obs, done=done,
        total_energy=state.total_energy + e_step * window,
        total_time=state.total_time + t_step * window,
    )
    return new_state, obs, reward, done
