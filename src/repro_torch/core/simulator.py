"""Calibrated analytic episode simulator (paper Section IV-B), batched.

Port of ``repro/core/simulator.py``. One episode = one full training run
(default 30 epochs x 128 steps); the agent acts at cache-rebuild
boundaries, and choosing window W advances the clock by W steps, with
T_step(W, sigma) evaluated from the calibrated cost model.

The reference vmaps one episode's pure functions over a pytree state; here
every tensor of the state carries a leading env axis, and each env has its
own parameter set (``params`` fields of shape (n,), see :func:`take`).
The random draws (the congestion profile at reset, the three observation
noise factors at reset and at every step) come from a :class:`Draws`
source passed to :func:`reset` and :func:`step`, so a test can replay
the reference's draws in place of the generator's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import controller as ctl
from repro_torch.core import cost_model as cm
from repro_torch.core import domain_rand as dr

DEFAULT_EPOCHS = 30
DEFAULT_STEPS_PER_EPOCH = 128
REFERENCE_WINDOW = 16.0  # E_ref policy: fixed W=16, uniform allocation


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    n_owners: int = 3
    n_epochs: int = DEFAULT_EPOCHS
    steps_per_epoch: int = DEFAULT_STEPS_PER_EPOCH
    # 0 = domain-randomized profiles (training), 1 = paper eval schedule,
    # 2 = clean.
    schedule: int = 0

    @property
    def total_steps(self) -> int:
        return self.n_epochs * self.steps_per_epoch


@dataclasses.dataclass(frozen=True)
class EnvState:
    profile: dr.CongestionProfile
    params: cm.CostModelParams      # per-env calibrated parameters, (n,)
    step_pos: torch.Tensor          # (n,) float32 global step index
    prev_window: torch.Tensor       # (n,) float32
    prev_weights: torch.Tensor      # (n, n_owners)
    obs: torch.Tensor               # (n, 23) current observation
    done: torch.Tensor              # (n,) bool
    total_energy: torch.Tensor      # (n,) accumulated J (per node)
    total_time: torch.Tensor        # (n,) accumulated s


class Draws:
    """An env's random draws, from one ``torch.Generator`` (the tensors
    land on its device)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def profile(self, cfg, n: int) -> dr.CongestionProfile:
        return dr.sample_profile(self.generator, cfg.total_steps,
                                 cfg.n_owners, n)

    def noise(self, cfg, n: int):
        """The (sigma (n, P-1), energy (n,), hit-rate (n, P-1)) noise
        factors of one observation, in the reference's order."""
        g = self.generator
        return (dr.observation_noise(g, (n, cfg.n_owners)),
                dr.observation_noise(g, (n,)),
                dr.observation_noise(g, (n, cfg.n_owners)))


def take(tree, idx: torch.Tensor):
    """Entries ``idx`` of every tensor field of a dataclass (nested
    dataclasses included): a parameter pool's entry per env."""
    def pick(v):
        return take(v, idx) if dataclasses.is_dataclass(v) else v[idx]

    return dataclasses.replace(tree, **{
        f.name: pick(getattr(tree, f.name)) for f in dataclasses.fields(tree)
    })


def select(mask: torch.Tensor, new, old):
    """Field by field ``where(mask, new, old)`` over dataclasses of
    tensors with a leading env axis (nested dataclasses included)."""
    if dataclasses.is_dataclass(new):
        return dataclasses.replace(new, **{
            f.name: select(mask, getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(new)
        })
    return torch.where(mask.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


def delta_now(cfg, profile: dr.CongestionProfile, step: torch.Tensor
              ) -> torch.Tensor:
    """Injected per-owner delay [ms] at ``step`` (n,) under the schedule."""
    if cfg.schedule == 0:
        return dr.delta_at(profile, step, cfg.n_owners)
    if cfg.schedule == 1:
        # a divide by a tensor: a number divisor would be a reciprocal
        # product on the card, which can truncate k * spe to k - 1
        epoch = (step / torch.full_like(step, cfg.steps_per_epoch)).to(
            torch.int32)
        return dr.paper_schedule_delta_t(epoch, cfg.n_epochs, cfg.n_owners)
    return torch.zeros((step.shape[0], cfg.n_owners), device=step.device)


def remaining_frac(cfg, step_pos: torch.Tensor) -> torch.Tensor:
    """The share of the epoch still to run at ``step_pos``."""
    in_epoch = torch.remainder(step_pos, cfg.steps_per_epoch)
    return 1.0 - in_epoch / cfg.steps_per_epoch


def _observe(cfg, params, noise, sigma, window, weights, step_pos):
    """Execute one window under ``sigma`` and build the next observation.

    Returns (obs, e_step, t_step, e_ref). Observation noise (+-3%)
    applies to the measured quantities only. The observed rebuild share
    is the deployed pipeline's exposed wait: the build's wall time
    inflated by the slowest owner, less the (1 - alpha_crit) share the
    overlap hides in clean conditions (at sigma = 1 exactly the
    alpha_crit * T_rebuild leak)."""
    noise_sigma, noise_e, noise_h = noise
    h_o = cm.per_owner_hit_rates_t(params, window, weights)
    t_step = cm.step_time_t(params, window, sigma, weights)
    e_step = cm.step_energy_t(params, window, sigma, weights)
    e_ref = cm.step_energy_t(params, REFERENCE_WINDOW, sigma)

    rebuild_clean = cm.rebuild_time_t(params, window)
    rebuild_exposed = torch.clamp(
        rebuild_clean * sigma.amax(-1)
        - (1.0 - params.alpha_crit) * rebuild_clean,
        min=0.0,
    )
    rebuild_frac = (rebuild_exposed / window) / t_step
    miss_frac = (
        params.remote_nodes * params.t_miss0
        * ((1.0 - h_o) * sigma).amax(-1)
    ) / t_step

    noisy_sigma = sigma * noise_sigma
    noisy_e = e_step * noise_e
    noisy_h = torch.clamp(h_o * noise_h, 0.0, 1.0)

    obs = ctl.build_state_t(
        noisy_sigma, noisy_h, noisy_h.mean(-1), t_step, params.t_base,
        rebuild_frac, miss_frac, noisy_e, e_ref,
        remaining_frac(cfg, step_pos), window, weights,
    )
    return obs, e_step, t_step, e_ref


def reset(cfg: EnvConfig, draws: Draws, params: cm.CostModelParams
          ) -> EnvState:
    """Fresh episodes, one per entry of ``params`` (fields of shape (n,))."""
    n = params.t_base.shape[0]
    dev = params.t_base.device
    profile = draws.profile(cfg, n)
    weights = torch.full((n, cfg.n_owners), 1.0 / cfg.n_owners, device=dev)
    window = torch.full((n,), REFERENCE_WINDOW, device=dev)
    zero = torch.zeros(n, device=dev)
    sigma0 = cm.sigma_from_delta_t(params, delta_now(cfg, profile, zero))
    obs, _, _, _ = _observe(cfg, params, draws.noise(cfg, n), sigma0,
                            window, weights, zero)
    return EnvState(
        profile=profile, params=params, step_pos=zero, prev_window=window,
        prev_weights=weights, obs=obs,
        done=torch.zeros(n, dtype=torch.bool, device=dev),
        total_energy=zero, total_time=zero,
    )


def step(cfg: EnvConfig, state: EnvState, action: torch.Tensor,
         draws: Draws):
    """One MDP decision per env: decode the actions (n,), run W steps,
    emit (state', obs, reward, done).

    Reward (Eq. 5): r = -E_step/E_ref - lambda * sum_o |a_o - a_o_prev|.
    """
    window, weights = ctl.decode_action_t(action, cfg.n_owners)
    params = state.params
    # congestion sampled mid-window (time-varying profiles change within W)
    mid = state.step_pos + 0.5 * window
    sigma = cm.sigma_from_delta_t(params, delta_now(cfg, state.profile, mid))

    new_pos = state.step_pos + window
    obs, e_step, t_step, e_ref = _observe(
        cfg, params, draws.noise(cfg, window.shape[0]), sigma, window,
        weights, new_pos,
    )
    thrash = torch.abs(weights - state.prev_weights).sum(-1)
    reward = -e_step / e_ref - ctl.LAMBDA_THRASH * thrash

    done = new_pos >= cfg.total_steps
    new_state = EnvState(
        profile=state.profile, params=params, step_pos=new_pos,
        prev_window=window, prev_weights=weights, obs=obs, done=done,
        total_energy=state.total_energy + e_step * window,
        total_time=state.total_time + t_step * window,
    )
    return new_state, obs, reward, done


def rollout_policy(cfg, draws: Draws, params, policy_fn,
                   max_decisions: int = 1024, env=None) -> dict:
    """Roll one episode per entry of ``params`` with ``policy_fn(obs) ->
    actions`` (batched); returns energy/time totals (n,) and the trace of
    windows, rewards, step positions and activity, (decisions, n) each. A
    finished episode's state is frozen; the loop stops once every episode
    is done (a host read per decision) or after ``max_decisions``.
    ``env`` is the simulator module (``table_sim``); None is this one."""
    env_reset, env_step = (env.reset, env.step) if env else (reset, step)
    state = env_reset(cfg, draws, params)
    trace = {"window": [], "reward": [], "step_pos": [], "active": []}
    with torch.no_grad():
        for _ in range(max_decisions):
            action = policy_fn(state.obs)
            nxt, _, reward, _ = env_step(cfg, state, action, draws)
            trace["window"].append(
                ctl.decode_action_t(action, cfg.n_owners)[0])
            trace["reward"].append(reward)
            trace["step_pos"].append(state.step_pos)
            trace["active"].append(~state.done)
            state = select(state.done, state, nxt)
            if bool(state.done.all()):
                break
    return {
        "total_energy": state.total_energy,
        "total_time": state.total_time,
        "trace": {k: torch.stack(v) for k, v in trace.items()},
    }
