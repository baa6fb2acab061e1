"""Queue-aware, scenario-conditioned training environment, batched.

Port of ``repro/core/queue_sim.py``. The analytic simulator evaluates a
window with the closed-form Eq. 1 law, so the agent never sees the
dynamics the ``net/`` evaluation fabric produces: queueing that inflates
fetch latency, backlog that outlives a burst, the prefetch-slack stall
cliff, and the deployed controller's clamped Eq. 8 estimate. This env is
a fluid twin of that fabric:

  * **per-owner link queues**: each remote owner link carries a backlog
    of wire work (clean-rate seconds). Rebuild bulk fetches are enqueued
    at window boundaries and per-step miss fetches queue behind them; the
    link drains at ``phi = (1 - u) / (1 + (gamma_c/beta) * delta)``, the
    fabric's service law, and what does not drain in a step persists;
  * **scenario-conditioned congestion**: each episode samples one scenario
    of the archetype family the scenario registry evaluates (clean,
    paper_schedule, fixed, bursty_markov, diurnal, incast, straggler,
    trace steps, the legacy archetypes), with domain-randomized severities
    and timescales, through the fabric-process twins of
    ``core/domain_rand.py``;
  * **deployment-faithful observations**: the sigma entries come from the
    deployed Eq. 8 estimator (per-owner fetch-time ratios ->
    ``controller.sigma_from_fetch_ratio_t`` with ``delta_max_ms``), and the
    rebuild and miss fractions are the async pipeline's exposed waits;
  * **trainer-faithful accounting**: stalls are slack-subtracted (``slack
    = Q * t_base``) and energy is ``EnergyMeter``'s four-term sum.

Every tensor carries a leading env axis, as in ``core/simulator.py``, and
each env has its own parameter set and scenario. A decision's window of
``MAX_WINDOW`` = 128 masked steps runs in one launch of the hand-written
CUDA kernel ``kernels/csrc/queue_window.cu`` (``kernels/queue_window``),
whose plain version, the eager masked loop, runs on the CPU. The random
draws come through :class:`Draws` (the scenario's unit uniforms and
integers, the congestion profile, a window's uniforms, the observation
noise), in the order the reference splits its keys, so a test can replay
the reference's draws.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import controller as ctl
from repro_torch.core import cost_model as cm
from repro_torch.core import domain_rand as dr
from repro_torch.core import simulator as sim
from repro_torch.device import constant
from repro_torch.kernels.queue_window import ops as qw

MAX_WINDOW = max(cm.WINDOW_CHOICES)     # inner loop length (masked beyond W)
REFERENCE_WINDOW = 16.0
MAX_UTILIZATION = cm.MAX_UTILIZATION
PROP_RTT_S_PER_MS = cm.PROP_RTT_BULK_S_PER_MS   # bulk fetch pays the RTT

# Fraction of a window's served rows the rebuild must fetch (the rest
# persists across the double-buffer diff).
REBUILD_FETCH_FRAC = 0.5
# Per-owner expected miss rows -> the probability that a step issues any
# fetch to that owner.
ACTIVE_ROWS_SCALE = 0.12
# Tiered-store pressure twin: extra wire work per unit of working-set
# overflow past the normalized host budget.
MEM_SPILL_GAIN = 2.0

# ------------------------------------------------------------- scenarios
# The package's one table of scenario codes: net/scenarios.py maps the
# registry's specs onto it.
SCENARIO_CODES = {
    "clean": 0,
    "paper_schedule": 1,
    "fixed": 2,
    "bursty_markov": 3,
    "diurnal": 4,
    "incast": 5,
    "straggler": 6,
    "trace": 7,
    "arch_none": 8,
    "arch_slow": 9,
    "arch_switch": 10,
    "arch_two_sym": 11,
    "arch_two_asym": 12,
    "arch_osc": 13,
}
N_SCENARIOS = len(SCENARIO_CODES)
_ARCH0 = SCENARIO_CODES["arch_none"]

# util process kinds
_U_NONE, _U_MARKOV, _U_DIURNAL, _U_INCAST, _U_STRAGGLER = 0, 1, 2, 3, 4
# delta process kinds
_D_NONE, _D_PAPER, _D_ARCH, _D_FIXED, _D_STEP = 0, 1, 2, 3, 4
# each code's processes, indexed by code
_UTIL_KIND_OF = (_U_NONE, _U_NONE, _U_NONE, _U_MARKOV, _U_DIURNAL, _U_INCAST,
                 _U_STRAGGLER, _U_NONE) + (_U_NONE,) * dr.N_ARCHETYPES
_DELTA_KIND_OF = (_D_NONE, _D_PAPER, _D_FIXED, _D_NONE, _D_NONE, _D_NONE,
                  _D_NONE, _D_STEP) + (_D_ARCH,) * dr.N_ARCHETYPES


def default_training_pool() -> tuple[int, ...]:
    """The full scenario-conditioned domain-randomization pool (every
    registry archetype but arch_none, uniformly sampled per episode)."""
    return tuple(SCENARIO_CODES[n] for n in (
        "clean", "paper_schedule", "fixed", "bursty_markov", "diurnal",
        "incast", "straggler", "trace",
        "arch_slow", "arch_switch", "arch_two_sym", "arch_two_asym",
        "arch_osc",
    ))


def code_for(spec: str) -> int:
    """A registry spec (``incast``, ``fixed:10``, ``trace:f``,
    ``arch_osc``...) as its training code."""
    name = spec.split(":", 1)[0]
    if name in ("closed_form",):
        name = "clean"
    if name not in SCENARIO_CODES:
        raise KeyError(
            f"no queue-sim twin for scenario {spec!r}; "
            f"known: {', '.join(sorted(SCENARIO_CODES))}"
        )
    return SCENARIO_CODES[name]


@dataclasses.dataclass(frozen=True)
class QueueScenario:
    """One sampled congestion recipe per env; fields (n,), ``phase`` (n,
    P), ``profile`` the legacy archetype parameters."""

    kind: torch.Tensor          # int64, SCENARIO_CODES value
    util_kind: torch.Tensor     # int64 load-process family
    util_on: torch.Tensor       # peak / ON-state utilization
    p_on: torch.Tensor          # markov OFF->ON per-step probability
    p_off: torch.Tensor         # markov ON->OFF per-step probability
    period: torch.Tensor        # diurnal/incast period [steps]
    burst_frac: torch.Tensor    # incast duty cycle
    offset: torch.Tensor        # incast phase offset [steps]
    phase: torch.Tensor         # (n, P) diurnal per-link phase [rad]
    victim: torch.Tensor        # int64 straggler link
    delta_kind: torch.Tensor    # int64 delta-process family
    fixed_ms: torch.Tensor      # fixed injected delay
    p_switch: torch.Tensor      # trace-step level resample probability
    level_max: torch.Tensor     # trace-step max level [ms]
    profile: dr.CongestionProfile
    shared_factor: torch.Tensor  # shared-bottleneck rate / clean link rate
                                 # (0 = no shared hop; incast uses 1.5)


@dataclasses.dataclass(frozen=True)
class ScenarioDraws:
    """The draws of :func:`sample_scenario` and of the pool pick, (n,) each
    (``phase`` (n, P)): unit uniforms, mapped onto their ranges as JAX maps
    its own, and integers."""

    pool_idx: torch.Tensor      # int64 index into cfg.scenario_pool
    jitter: torch.Tensor        # -> [0.5, 2)
    util: torch.Tensor          # -> [0.6, MAX_UTILIZATION)
    severity: torch.Tensor      # -> [5, 25)
    victim: torch.Tensor        # int64 in [0, P)
    phase: torch.Tensor         # -> [0, 2 pi)
    offset: torch.Tensor        # -> [0, 0.08 * total)
    mean_seg: torch.Tensor      # -> [16, 128)
    level_max: torch.Tensor     # -> [10, 40)


def sample_scenario(u: ScenarioDraws, profile: dr.CongestionProfile,
                    code: torch.Tensor, total_steps: int, n_owners: int
                    ) -> QueueScenario:
    """Domain-randomize one scenario per env of the archetype ``code``
    (n,), each field selected by code (the reference's ``lax.switch`` under
    ``vmap`` evaluates every branch and selects, so every draw is made
    whatever the code).

    Timescales are fractions of the run length (so bursts materialize at
    any step budget), jittered x[0.5, 2]; severities span the mild-to-eval
    range like the legacy archetype pool."""
    f32 = np.float32
    total = f32(total_steps)
    dev = code.device
    jitter = dr.uniform_from_unit(u.jitter, 0.5, 2.0)
    util = torch.clamp(dr.uniform_from_unit(u.util, 0.6, MAX_UTILIZATION),
                       0.0, MAX_UTILIZATION)
    severity = dr.uniform_from_unit(u.severity, 5.0, 25.0)
    phase = dr.uniform_from_unit(u.phase, 0.0, 2.0 * math.pi)
    offset = dr.uniform_from_unit(u.offset, 0.0, f32(0.08) * total)
    mean_seg = dr.uniform_from_unit(u.mean_seg, 16.0, 128.0)
    level_max = dr.uniform_from_unit(u.level_max, 10.0, 40.0)

    def on(name):
        return code == SCENARIO_CODES[name]

    zero = torch.zeros_like(jitter)
    markov, diurnal, incast = on("bursty_markov"), on("diurnal"), on("incast")
    straggler, trace = on("straggler"), on("trace")
    # registry: mean_on = 0.03 * run, mean_off = 0.07 * run
    mean_on = float(f32(0.03) * total) * jitter
    mean_off = float(f32(0.07) * total) * jitter
    util_on = torch.where(markov, torch.clamp(util, min=0.75), zero)
    util_on = torch.where(diurnal, util, util_on)
    util_on = torch.where(incast, torch.clamp(util, min=0.85), util_on)
    util_on = torch.where(straggler, torch.clamp(util, max=0.85), util_on)
    period = torch.where(diurnal, float(f32(0.4) * total) * jitter,
                         torch.full_like(jitter, 64.0))
    period = torch.where(incast, float(f32(0.08) * total) * jitter, period)

    arch = code >= _ARCH0
    clean = dr.clean_profile(code.shape[0], dev)
    sampled = dataclasses.replace(profile, archetype=code - _ARCH0)
    return QueueScenario(
        kind=code,
        util_kind=constant(_UTIL_KIND_OF, dev, torch.int64)[code],
        util_on=util_on,
        p_on=torch.where(markov, dr.markov_switch_prob(mean_off), zero),
        p_off=torch.where(markov, dr.markov_switch_prob(mean_on), zero),
        period=period,
        burst_frac=torch.where(incast, float(f32(0.015 / 0.08)), zero),
        offset=torch.where(incast, offset, zero),
        phase=torch.where(diurnal[:, None], phase, 0.0),
        victim=torch.where(straggler, u.victim, 0),
        delta_kind=constant(_DELTA_KIND_OF, dev, torch.int64)[code],
        fixed_ms=torch.where(on("fixed"), severity, zero),
        p_switch=torch.where(trace, 1.0 / mean_seg, zero),
        level_max=torch.where(trace, level_max, zero),
        profile=sim.select(arch, sampled, clean),
        shared_factor=torch.where(incast, 1.5, zero),
    )


# ------------------------------------------------------------- env cfg
@dataclasses.dataclass(frozen=True)
class QueueEnvConfig:
    n_owners: int = 3
    n_epochs: int = 30
    steps_per_epoch: int = 128
    # training pool of SCENARIO_CODES values, sampled uniformly per episode
    scenario_pool: tuple = dataclasses.field(
        default_factory=default_training_pool)
    # Stage-3 prefetch queue depth Q: stalls appear only past Q * t_base of
    # fetch latency (the deployment's slack cliff)
    slack_steps: float = 4.0
    # Tiered-store pressure twin: host budget as a fraction of the
    # MAX_WINDOW working set (0 = unlimited), and whether the observation
    # gains the trailing cache-headroom entry
    mem_budget_frac: float = 0.0
    observe_headroom: bool = False

    @property
    def total_steps(self) -> int:
        return self.n_epochs * self.steps_per_epoch


@dataclasses.dataclass(frozen=True)
class EnvState:
    scenario: QueueScenario
    params: cm.CostModelParams      # per-env calibrated parameters, (n,)
    step_pos: torch.Tensor          # (n,) float32 global step index
    prev_window: torch.Tensor       # (n,)
    prev_weights: torch.Tensor      # (n, P)
    obs: torch.Tensor               # (n, state_dim)
    done: torch.Tensor              # (n,) bool
    total_energy: torch.Tensor      # (n,)
    total_time: torch.Tensor        # (n,)
    # fluid fabric state
    util_state: torch.Tensor        # (n, P) markov on/off chain state
    delta_level: torch.Tensor       # (n, P) trace-step current level [ms]
    backlog: torch.Tensor           # (n, P) queued miss wire work [s]
    rb_backlog: torch.Tensor        # (n, P) queued rebuild work ahead of
                                    # misses [s]
    shared_backlog: torch.Tensor    # (n,) shared-ingress queued work


class Draws(sim.Draws):
    """The queue env's draws from one ``torch.Generator``: the simulators'
    profile and noise draws, and the scenario's and a window's."""

    def scenario(self, cfg, n: int) -> ScenarioDraws:
        g, dev = self.generator, self.generator.device

        def unit(*shape):
            return torch.rand(shape, generator=g, device=dev)

        pool_idx = torch.randint(0, len(cfg.scenario_pool), (n,),
                                 generator=g, device=dev)
        jitter, util, severity = unit(n), unit(n), unit(n)
        victim = torch.randint(0, cfg.n_owners, (n,), generator=g,
                               device=dev)
        return ScenarioDraws(
            pool_idx=pool_idx, jitter=jitter, util=util, severity=severity,
            victim=victim, phase=unit(n, cfg.n_owners), offset=unit(n),
            mean_seg=unit(n), level_max=unit(n))

    def window(self, cfg, n: int) -> torch.Tensor:
        """(n, MAX_WINDOW, 3, P) unit uniforms: for each step of a window
        the Markov draw, the step-trace resample draw and its level draw
        (masked steps draw too)."""
        return torch.rand((n, MAX_WINDOW, 3, cfg.n_owners),
                          generator=self.generator,
                          device=self.generator.device)


# ------------------------------------------------------------- processes
def _utilization(sc: QueueScenario, util_state: torch.Tensor,
                 step: torch.Tensor, n_owners: int) -> torch.Tensor:
    """Background utilization of each link at ``step`` (n,): (n, P)."""
    u = torch.stack([
        torch.zeros_like(util_state),
        util_state * sc.util_on[:, None],
        dr.diurnal_util(step, sc.period, sc.util_on, sc.phase),
        dr.incast_util(step, sc.period, sc.burst_frac, sc.util_on,
                       sc.offset, n_owners),
        dr.straggler_util(sc.victim, sc.util_on, n_owners),
    ], dim=1)
    rows = torch.arange(u.shape[0], device=u.device)
    return torch.clamp(u[rows, sc.util_kind], 0.0, MAX_UTILIZATION)


def _delta(cfg, sc: QueueScenario, delta_level: torch.Tensor,
           step: torch.Tensor) -> torch.Tensor:
    """Injected per-owner delay [ms] at ``step`` (n,): (n, P)."""
    # a divide by a tensor: a number divisor is a reciprocal product on
    # the card, which can truncate k * spe to k - 1
    epoch = (step / torch.full_like(step, cfg.steps_per_epoch)).to(
        torch.int32)
    d = torch.stack([
        torch.zeros_like(delta_level),
        dr.paper_schedule_delta_t(epoch, cfg.n_epochs, cfg.n_owners),
        dr.delta_at(sc.profile, step, cfg.n_owners),
        sc.fixed_ms[:, None].expand(-1, cfg.n_owners),
        delta_level,
    ], dim=1)
    rows = torch.arange(d.shape[0], device=d.device)
    return d[rows, sc.delta_kind]


# ---------------------------------------------------- memory-pressure twin
# Tensor twins of the tiered store's host tier: a W-step cache working set
# needs ~W/MAX_WINDOW of the full hot set resident; what overflows the
# normalized budget is evicted mid-window and re-fetched over the same
# owner links, so memory pressure reaches the agent as congestion.

def mem_spill(cfg, window: torch.Tensor) -> torch.Tensor:
    """Wire-work multiplier of a W decision (n,) under
    ``cfg.mem_budget_frac`` (callers apply it only when that is > 0)."""
    need = window / MAX_WINDOW
    frac = torch.full_like(need, cfg.mem_budget_frac)
    over = torch.clamp(need - cfg.mem_budget_frac, min=0.0) / frac
    return 1.0 + MEM_SPILL_GAIN * over


def mem_headroom(cfg, window: torch.Tensor) -> torch.Tensor:
    """Normalized host-tier headroom of a W decision (n,) (1.0 =
    unlimited)."""
    if cfg.mem_budget_frac <= 0.0:
        return torch.ones_like(window)
    need = window / MAX_WINDOW
    frac = torch.full_like(need, cfg.mem_budget_frac)
    return torch.clamp((cfg.mem_budget_frac - need) / frac, 0.0, 1.0)


# ------------------------------------------------------- shared cost pieces
# The one source of the fluid cost law, for this env and the P-requester
# cluster twin: the twin adds peer arrivals, heterogeneity and the sync
# barrier around them. ``demand`` optionally skews per-owner demand; None
# skips the product, which keeps the reference's operation order.

def action_volumes(params, window, weights, n_owners, demand=None):
    """Expected per-step miss volumes and boundary rebuild volumes of one
    (W (n,), weights (n, P)) decision per env, in clean-rate seconds of
    wire work: (h_o, miss_rows, miss_work, active, rb_work) (n, P) and
    rb_cpu (n,)."""
    h_o = cm.per_owner_hit_rates_t(params, window, weights)
    miss_rows = params.remote_nodes[:, None] * (1.0 - h_o) / n_owners
    if demand is not None:
        miss_rows = miss_rows * demand
    miss_work = params.beta[:, None] * miss_rows \
        * params.feature_bytes[:, None]
    active = torch.clamp(miss_rows * ACTIVE_ROWS_SCALE, 0.0, 1.0)

    # the rebuild's bulk fetch, enqueued at the boundary: the hot rows the
    # plan must pull, split by the allocation; unique-hub reuse saturates
    # with W, so the volume follows the W**rebuild_c law of T_rebuild
    unique_w = window ** params.rebuild_c
    rb_rows = (
        REBUILD_FETCH_FRAC * (params.remote_nodes / n_owners)
        * unique_w
    )[:, None] * h_o * (weights * n_owners)
    if demand is not None:
        rb_rows = rb_rows * demand
    rb_work = params.beta[:, None] * rb_rows * params.feature_bytes[:, None]
    rb_cpu = (params.alpha_rpc[:, None] + rb_work).sum(-1)
    return h_o, miss_rows, miss_work, active, rb_work, rb_cpu


def reference_volumes(params, n_owners, demand=None):
    """Volumes of the reference action (W = 16, uniform): E_ref is the
    model's own cost of the paper's reference policy under the same
    congestion, so reward ~= -1 at the reference action in every
    scenario. Returns miss_work_ref, active_ref, rb_work_ref (n, P) and
    rb_cpu_ref (n,)."""
    n = params.t_base.shape[0]
    uniform = torch.full((n, n_owners), 1.0 / n_owners,
                         device=params.t_base.device)
    ref_w = torch.full_like(params.t_base, REFERENCE_WINDOW)
    h_ref = cm.per_owner_hit_rates_t(params, ref_w, uniform)
    miss_rows_ref = params.remote_nodes[:, None] * (1.0 - h_ref) / n_owners
    if demand is not None:
        miss_rows_ref = miss_rows_ref * demand
    miss_work_ref = params.beta[:, None] * miss_rows_ref \
        * params.feature_bytes[:, None]
    active_ref = torch.clamp(miss_rows_ref * ACTIVE_ROWS_SCALE, 0.0, 1.0)
    rb_work_ref = (
        params.beta * REBUILD_FETCH_FRAC
        * (params.remote_nodes / n_owners)
        * (ref_w ** params.rebuild_c)
    )[:, None] * h_ref
    if demand is not None:
        rb_work_ref = rb_work_ref * demand
    rb_work_ref = rb_work_ref * params.feature_bytes[:, None]
    rb_cpu_ref = (params.alpha_rpc[:, None] + rb_work_ref).sum(-1)
    return miss_work_ref, active_ref, rb_work_ref, rb_cpu_ref


def make_step_cost(params, slope, t_base, slack, shared_factor):
    """The per-step cost law: the miss fetch waits behind the carried link
    backlogs, plus the shared-ingress wait, the exposed rebuild leak, and
    the EnergyMeter's four-term energy. The reference action takes the
    same law with its own volumes and no carried backlog, so the two
    cost paths cannot drift. Per-owner arguments are (n, P), the others
    (n,) or numbers; returns t_step, stall, rb_leak, e (n,) and wall
    (n, P)."""
    alpha_rpc = params.alpha_rpc

    def step_cost(d, phi, ar, active_, miss_work_, queue_, rb_for_leak,
                  rb_gate, sh_q, rb_cpu_, win):
        wall = (
            active_ * (alpha_rpc[:, None] + PROP_RTT_S_PER_MS * d)
            + (queue_ + active_ * miss_work_) / phi
        )
        # shared ingress (incast): owner responses serialize through a hop
        # at shared_factor x the clean link rate
        sh_rate = torch.clamp(shared_factor, min=1e-6)
        sh_wait = (sh_q + (active_ * miss_work_).sum(-1)) / sh_rate
        raw = wall.amax(-1) + torch.where(shared_factor > 0.0, sh_wait, 0.0)
        stall = active_.amax(-1) * torch.clamp(raw - slack, min=0.0)
        # rebuild exposure: the alpha_crit share of the bulk fetch's wall
        # time leaks onto the critical path, amortized over the window
        rb_wall = alpha_rpc + (rb_for_leak / phi
                               + PROP_RTT_S_PER_MS * d).amax(-1)
        rb_leak = params.alpha_crit * rb_wall / win * rb_gate
        t_stall = stall + rb_leak + ar
        t_step = t_base + t_stall
        cpu = (active_ * (alpha_rpc[:, None]
                          + miss_work_ * (1.0 + slope[:, None] * d))
               ).sum(-1) + rb_cpu_ * (1.0 + slope * d.amax(-1)) / win
        e = (
            params.p_gpu_active * t_base
            + params.p_gpu_idle * t_stall
            + params.p_cpu_base * t_step
            + params.p_cpu_rpc * cpu
        )
        return t_step, stall, rb_leak, e, wall

    return step_cost


def summarize_window(params, acc: dict, n_owners: int) -> dict:
    """Window-mean accounting and the deployed estimator's inputs (the
    per-row fetch ratio against the clean W = 16 baseline the warmup
    percentile estimates, Section V-B)."""
    n = torch.clamp(acc["n"], min=1.0)
    ref_w = torch.full_like(params.t_base, REFERENCE_WINDOW)
    rows16 = params.remote_nodes * (1.0 - cm.hit_rate_t(params, ref_w)) \
        / n_owners
    base_per_row = (
        params.alpha_rpc + params.beta * rows16 * params.feature_bytes
    ) / torch.clamp(rows16, min=1e-6)
    mean_per_row = torch.where(
        acc["active"] > 0.0,
        acc["per_row"] / torch.clamp(acc["active"], min=1e-6),
        base_per_row[:, None],
    )
    t = torch.clamp(acc["t"], min=1e-9)
    return {
        "t_step": acc["t"] / n,
        "e_step": acc["e"] / n,
        "e_ref": acc["e_ref"] / n,
        "f_miss": (acc["stall"] - acc["rb_wait"]) / t,
        "f_rebuild": acc["rb_wait"] / t,
        "fetch_ratio": mean_per_row / base_per_row[:, None],
    }


# ------------------------------------------------------------- dynamics
def _window_dynamics(cfg, params, sc: QueueScenario, uniforms, window,
                     weights, step_pos, util_state, delta_level, backlog,
                     rb_backlog, shared_backlog, eff_window=None) -> dict:
    """Run ``window`` (n,) training steps per env through the fluid fabric,
    on the window's unit uniforms ``uniforms`` (n, MAX_WINDOW, 3, P).

    Returns the window-mean accounting and the updated fabric state. The
    loop has the static length MAX_WINDOW with steps at or past
    ``eff_window`` masked out: the episode horizon cuts execution there
    (the cache is planned for ``window``, so hit rates and the rebuild
    volume keep that scale, but only the remaining steps run and cost).
    The loop is one launch of the ``queue_window`` kernel on the card."""
    if eff_window is None:
        eff_window = window
    h_o, vol, fabric = window_operands(
        cfg, params, window, weights, util_state, delta_level, backlog,
        rb_backlog, shared_backlog)
    acc, fabric = qw.queue_window(cfg, params, sc, vol, fabric, uniforms,
                                  window, eff_window, step_pos)
    out = summarize_window(params, acc, cfg.n_owners)
    out.update({
        "h_o": h_o,
        "util_state": fabric.util_state,
        "delta_level": fabric.delta_level,
        "backlog": fabric.backlog,
        "rb_backlog": fabric.rb_backlog,
        "shared_backlog": fabric.shared_backlog,
    })
    return out


def window_operands(cfg, params, window, weights, util_state, delta_level,
                    backlog, rb_backlog, shared_backlog, demand=None):
    """What a window's loop takes besides the scenario and the draws: the
    per-owner hit rates (n, P), the decision's ``Volumes`` (the memory
    spill applied) and the ``FabricState`` it starts from, the boundary's
    rebuild work queued on the links. ``demand`` (n, P) skews per-owner
    demand (the cluster twin's); None keeps the queue env's operations."""
    n_owners = cfg.n_owners
    h_o, miss_rows, miss_work, active, rb_work, rb_cpu = action_volumes(
        params, window, weights, n_owners, demand=demand)
    miss_work_ref, active_ref, rb_work_ref, rb_cpu_ref = reference_volumes(
        params, n_owners, demand=demand)
    if cfg.mem_budget_frac > 0.0:
        # the working set past the host budget is evicted mid-window and
        # re-fetched over the same links; the reference action pays its
        # own (W = 16) spill under the same budget
        spill = mem_spill(cfg, window)[:, None]
        miss_work = miss_work * spill
        rb_work = rb_work * spill
        rb_cpu = (params.alpha_rpc[:, None] + rb_work).sum(-1)
        spill_ref = mem_spill(
            cfg, torch.full_like(window, REFERENCE_WINDOW))[:, None]
        miss_work_ref = miss_work_ref * spill_ref
        rb_work_ref = rb_work_ref * spill_ref
        rb_cpu_ref = (params.alpha_rpc[:, None] + rb_work_ref).sum(-1)
    vol = qw.Volumes(
        miss_work=miss_work, active=active, miss_rows=miss_rows,
        miss_work_ref=miss_work_ref, active_ref=active_ref,
        rb_work_ref=rb_work_ref, rb_cpu=rb_cpu, rb_cpu_ref=rb_cpu_ref)
    fabric = qw.FabricState(
        util_state=util_state, delta_level=delta_level, backlog=backlog,
        rb_backlog=rb_backlog + rb_work, shared_backlog=shared_backlog)
    return h_o, vol, fabric


def _observe(cfg, params, noise, dyn: dict, window, weights, step_pos
             ) -> torch.Tensor:
    """The deployment-faithful state: sigma through the deployed Eq. 8
    estimator (ratio -> clamped delta -> sigma, clamped at
    ``params.delta_max_ms``), fractions as exposed waits, +-3% telemetry
    noise on measured quantities (``noise``: the sigma (n, P), energy (n,)
    and hit-rate (n, P) factors)."""
    noise_sig, noise_e, noise_h = noise
    noisy_ratio = dyn["fetch_ratio"] * noise_sig
    sigma_hat = torch.clamp(ctl.sigma_from_fetch_ratio_t(noisy_ratio, params),
                            min=1.0)
    noisy_h = torch.clamp(dyn["h_o"] * noise_h, 0.0, 1.0)
    noisy_e = dyn["e_step"] * noise_e
    headroom = mem_headroom(cfg, window) if cfg.observe_headroom else None
    return ctl.build_state_t(
        sigma_hat,
        noisy_h,
        noisy_h.mean(-1),
        dyn["t_step"],
        params.t_base,
        torch.clamp(dyn["f_rebuild"], 0.0, 1.0),
        torch.clamp(dyn["f_miss"], 0.0, 1.0),
        noisy_e,
        dyn["e_ref"],
        sim.remaining_frac(cfg, step_pos),
        window,
        weights,
        headroom=headroom,
    )


def reset(cfg: QueueEnvConfig, draws: Draws, params: cm.CostModelParams
          ) -> EnvState:
    """Fresh episodes, one per entry of ``params`` (fields of shape (n,)):
    a scenario drawn from the pool, and a probe window at the reference
    action that observes its t = 0 conditions without advancing the
    episode (the fabric state stays pristine)."""
    n = params.t_base.shape[0]
    dev = params.t_base.device
    u = draws.scenario(cfg, n)
    pool = constant(tuple(cfg.scenario_pool), dev, torch.int64)
    scenario = sample_scenario(u, draws.profile(cfg, n), pool[u.pool_idx],
                               cfg.total_steps, cfg.n_owners)
    weights = torch.full((n, cfg.n_owners), 1.0 / cfg.n_owners, device=dev)
    window = torch.full((n,), REFERENCE_WINDOW, device=dev)
    zero = torch.zeros(n, device=dev)
    zeros = torch.zeros((n, cfg.n_owners), device=dev)
    dyn = _window_dynamics(cfg, params, scenario, draws.window(cfg, n),
                           window, weights, zero, zeros, zeros, zeros, zeros,
                           zero)
    obs = _observe(cfg, params, draws.noise(cfg, n), dyn, window, weights,
                   zero)
    return EnvState(
        scenario=scenario, params=params, step_pos=zero, prev_window=window,
        prev_weights=weights, obs=obs,
        done=torch.zeros(n, dtype=torch.bool, device=dev),
        total_energy=zero, total_time=zero,
        util_state=zeros, delta_level=zeros, backlog=zeros,
        rb_backlog=zeros, shared_backlog=zero,
    )


def step(cfg: QueueEnvConfig, state: EnvState, action: torch.Tensor,
         draws: Draws):
    """One MDP decision per env: decode the actions (n,), run W steps
    through the fluid fabric, emit (state', obs, reward, done). The reward
    is Eq. 5's, normalized as in the sibling envs."""
    window, weights = ctl.decode_action_t(action, cfg.n_owners)
    n = window.shape[0]
    # the decision plans a W-step cache, but only the steps remaining in
    # the episode run and cost (real epochs end on time)
    w_eff = torch.minimum(window, cfg.total_steps - state.step_pos)
    dyn = _window_dynamics(
        cfg, state.params, state.scenario, draws.window(cfg, n), window,
        weights, state.step_pos, state.util_state, state.delta_level,
        state.backlog, state.rb_backlog, state.shared_backlog,
        eff_window=w_eff,
    )
    obs = _observe(cfg, state.params, draws.noise(cfg, n), dyn, window,
                   weights, state.step_pos + w_eff)
    thrash = torch.abs(weights - state.prev_weights).sum(-1)
    reward = -dyn["e_step"] / dyn["e_ref"] - ctl.LAMBDA_THRASH * thrash

    new_pos = state.step_pos + w_eff
    done = new_pos >= cfg.total_steps
    new_state = EnvState(
        scenario=state.scenario, params=state.params, step_pos=new_pos,
        prev_window=window, prev_weights=weights, obs=obs, done=done,
        total_energy=state.total_energy + dyn["e_step"] * w_eff,
        total_time=state.total_time + dyn["t_step"] * w_eff,
        util_state=dyn["util_state"], delta_level=dyn["delta_level"],
        backlog=dyn["backlog"], rb_backlog=dyn["rb_backlog"],
        shared_backlog=dyn["shared_backlog"],
    )
    return new_state, obs, reward, done


def rollout_policy(cfg: QueueEnvConfig, draws: Draws, params, policy_fn,
                   max_decisions: int = 1024) -> dict:
    """Roll one episode per entry of ``params`` with ``policy_fn(obs) ->
    actions``, as ``simulator.rollout_policy`` does (a finished episode is
    frozen; the loop stops when every episode is done). The default
    ``max_decisions`` cuts an episode of small windows short: pass
    ``cfg.total_steps`` to run every episode to its end."""
    from repro_torch.core import queue_sim

    return sim.rollout_policy(cfg, draws, params, policy_fn, max_decisions,
                              env=queue_sim)
