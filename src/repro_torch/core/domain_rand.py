"""Domain-randomised congestion profiles and the paper's evaluation
schedule (Sections IV-C.2a and VI-A).

Port of ``repro/core/domain_rand.py``: the numpy forms the trainer and the
event fabric evaluate per step (``paper_schedule_delta`` in float32,
``paper_schedule_delta_np`` and ``delta_at_np`` in float64), and the
tensor forms the training simulators run, batched over a leading env axis
(``CongestionProfile``, ``sample_profile``, ``clean_profile``,
``delta_at``, ``paper_schedule_delta_t``, ``observation_noise``), and the
twins of the event fabric's background processes that the queue env
(``core/queue_sim.py``) runs per training step (``diurnal_util``,
``incast_util``, ``straggler_util``, ``markov_switch_prob``,
``markov_onoff_update``, ``step_trace_update``). The two updates take unit
uniforms rather than a generator, so the queue env's draws pass one seam;
:func:`uniform_from_unit` maps a unit uniform onto a range as JAX does.

Six archetypes x three severity levels with random onset/duration and
+-3% measurement noise: 0 none, 1 single-link constant, 2 single-link
fast-switching (the link flips every ``period`` steps), 3 two-link
symmetric, 4 two-link asymmetric (second link at half severity), 5
oscillating (sinusoidal on one link). Delta is the injected one-way extra
latency in ms per remote owner.

Epochs 0-2 are a clean warmup; from epoch 3 a 7-epoch pattern repeats in
which 5 congested epochs inject 15-25 ms on one or two links (rotating
target) followed by 2 clean epochs; the final epoch is forced clean.

The reference computes ``paper_schedule_delta`` in float32 (``0.7 *
17.5`` is not the float64 product), so this port does too; the closed-form
trainer reads it. Its float64 twin ``paper_schedule_delta_np`` gives other
values; the fabric's ``PaperScheduleDelta`` reads that one, as the
reference's does.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import constant

N_ARCHETYPES = 6
# three severity levels; the eval schedule injects 15-25 ms (Section VI-A),
# so training coverage spans mild (5) through the full eval range (15, 25)
SEVERITY_LEVELS_MS = (5.0, 15.0, 25.0)
OBS_NOISE_FRAC = 0.03


def paper_schedule_delta(
    epoch: int,
    n_epochs: int,
    n_owners: int = 3,
) -> np.ndarray:
    """Deterministic per-owner injected delay [ms] (float32, (n_owners,))."""
    epoch = int(epoch)
    owners = np.arange(n_owners)
    phase = max(epoch - 3, 0) % 7
    in_window = (epoch >= 3) and (epoch < n_epochs - 1)
    congested = in_window and (phase < 5)
    if not congested:
        return np.zeros(n_owners, np.float32)
    # severity sweeps 15 -> 25 ms across the 5 congested phases
    sev = np.float32(15.0) + np.float32(2.5) * np.float32(phase)
    # rotate the afflicted link; every other phase hits two links
    onehot_a = (owners == phase % n_owners).astype(np.float32)
    onehot_b = (owners == (phase + 1) % n_owners).astype(np.float32) \
        * np.float32(phase % 2 == 1)
    return sev * (onehot_a + np.float32(0.7) * onehot_b)


def delta_at_np(
    archetype: int,
    severity_ms: float,
    onset: float,
    duration: float,
    period: float,
    link_a: int,
    link_b: int,
    phase: float,
    step: float,
    n_owners: int = 3,
) -> np.ndarray:
    """Per-owner injected delay [ms] of one archetype at ``step`` (float64):
    0 none, 1 single constant, 2 single fast-switching, 3 two-link
    symmetric, 4 two-link asymmetric, 5 oscillating."""
    step = float(step)
    owners = np.arange(n_owners)
    active = (step >= onset) and (step < onset + duration)
    sev = float(severity_ms) if active else 0.0

    onehot_a = (owners == int(link_a)).astype(np.float64)
    onehot_b = (owners == int(link_b)).astype(np.float64)
    p = max(float(period), 1.0)
    flip = np.floor((step - onset) / p) % 2
    switching = onehot_a if flip == 0 else onehot_b
    osc = 0.5 * (1.0 + np.sin(2.0 * np.pi * (step - onset) / p + phase))

    branches = [
        np.zeros(n_owners),
        sev * onehot_a,
        sev * switching,
        sev * (onehot_a + onehot_b),
        sev * (onehot_a + 0.5 * onehot_b),
        sev * osc * onehot_a,
    ]
    return branches[int(archetype) % N_ARCHETYPES]


def paper_schedule_delta_np(epoch: int, n_epochs: int,
                            n_owners: int = 3) -> np.ndarray:
    """The paper schedule in float64 (the fabric's per-step twin)."""
    epoch = int(epoch)
    owners = np.arange(n_owners)
    phase = max(epoch - 3, 0) % 7
    in_window = (epoch >= 3) and (epoch < n_epochs - 1)
    congested = in_window and (phase < 5)
    if not congested:
        return np.zeros(n_owners)
    sev = 15.0 + 2.5 * phase
    link_a = phase % n_owners
    link_b = (phase + 1) % n_owners
    two_links = (phase % 2) == 1
    onehot_a = (owners == link_a).astype(np.float64)
    onehot_b = (owners == link_b).astype(np.float64) * float(two_links)
    return sev * (onehot_a + 0.7 * onehot_b)


# ---------------------------------------------------------------------------
# Tensor forms for the training simulators: every tensor has a leading env
# axis, and every draw comes from an explicit ``torch.Generator`` on the
# device the tensors live on.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CongestionProfile:
    """One domain-randomised profile per env; every field is (n,)."""

    archetype: torch.Tensor      # int64 in [0, 6)
    severity_ms: torch.Tensor    # float32
    onset: torch.Tensor          # float32, step index
    duration: torch.Tensor       # float32, steps
    period: torch.Tensor         # float32, steps (archetypes 2 and 5)
    link_a: torch.Tensor         # int64 owner index
    link_b: torch.Tensor         # int64 owner index (!= link_a)
    phase: torch.Tensor          # float32 radians (archetype 5)


def _uniform(g: torch.Generator, n: int, lo: float, hi: float
             ) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=g, device=g.device)


def sample_profile(generator: torch.Generator, total_steps: int,
                   n_owners: int = 3, n: int = 1) -> CongestionProfile:
    """Draw ``n`` profiles on the generator's device, with the reference's
    ranges. ``n_owners`` is the number of remote-owner links the requester
    sees; ``link_b`` is another link than ``link_a`` whenever there are
    two (at ``n_owners`` = 1 both are link 0, so archetypes stay in range
    at every cluster size)."""
    g, dev = generator, generator.device
    archetype = torch.randint(0, N_ARCHETYPES, (n,), generator=g, device=dev)
    level = torch.randint(0, len(SEVERITY_LEVELS_MS), (n,), generator=g,
                          device=dev)
    severity = constant(SEVERITY_LEVELS_MS, dev)[level]
    onset = _uniform(g, n, 0.0, 0.35 * total_steps)
    duration = _uniform(g, n, 0.25 * total_steps, 1.0 * total_steps)
    period = _uniform(g, n, 32.0, 256.0)
    link_a = torch.randint(0, n_owners, (n,), generator=g, device=dev)
    link_b = (link_a + 1 + torch.randint(0, max(n_owners - 1, 1), (n,),
                                         generator=g, device=dev)) \
        % max(n_owners, 1)
    phase = _uniform(g, n, 0.0, 2.0 * math.pi)
    return CongestionProfile(archetype, severity, onset, duration, period,
                             link_a, link_b, phase)


def clean_profile(n: int = 1, device: torch.device | str = "cpu"
                  ) -> CongestionProfile:
    def full(v, dtype=torch.float32):
        return torch.full((n,), v, dtype=dtype, device=device)

    return CongestionProfile(
        archetype=full(0, torch.int64), severity_ms=full(0.0),
        onset=full(0.0), duration=full(1e9), period=full(64.0),
        link_a=full(0, torch.int64), link_b=full(1, torch.int64),
        phase=full(0.0),
    )


def delta_at(profile: CongestionProfile, step, n_owners: int = 3
             ) -> torch.Tensor:
    """Injected per-owner delay [ms] at global training step ``step``
    (a float32 tensor of shape (n,), or a number for every env): (n,
    n_owners) float32."""
    p = profile
    if not isinstance(step, torch.Tensor):
        step = torch.full_like(p.onset, float(step))
    owners = torch.arange(n_owners, device=p.onset.device)
    active = (step >= p.onset) & (step < p.onset + p.duration)
    sev = (p.severity_ms * active.float())[:, None]

    onehot_a = (owners == p.link_a[:, None]).float()
    onehot_b = (owners == p.link_b[:, None]).float()
    # fast-switching link: alternate a/b each `period` steps
    period = torch.clamp(p.period, min=1.0)
    flip = torch.floor((step - p.onset) / period) % 2
    switching = torch.where((flip == 0)[:, None], onehot_a, onehot_b)
    osc = 0.5 * (1.0 + torch.sin(
        2.0 * math.pi * (step - p.onset) / period + p.phase))

    branches = torch.stack([
        torch.zeros_like(onehot_a),              # 0 none
        sev * onehot_a,                          # 1 single constant
        sev * switching,                         # 2 single fast-switching
        sev * (onehot_a + onehot_b),             # 3 two-link symmetric
        sev * (onehot_a + 0.5 * onehot_b),       # 4 two-link asymmetric
        sev * osc[:, None] * onehot_a,           # 5 oscillating
    ], dim=1)
    rows = torch.arange(branches.shape[0], device=branches.device)
    return branches[rows, p.archetype]


def paper_schedule_delta_t(epoch: torch.Tensor, n_epochs: int,
                           n_owners: int = 3) -> torch.Tensor:
    """:func:`paper_schedule_delta` over an integer tensor of epochs (n,):
    (n, n_owners) float32."""
    owners = torch.arange(n_owners, device=epoch.device)
    phase = torch.clamp(epoch - 3, min=0) % 7
    in_window = (epoch >= 3) & (epoch < n_epochs - 1)
    congested = in_window & (phase < 5)
    # severity sweeps 15 -> 25 ms across the 5 congested phases
    sev = (15.0 + 2.5 * phase.float())[:, None]
    # rotate the afflicted link; every other phase hits two links
    onehot_a = (owners == (phase % n_owners)[:, None]).float()
    onehot_b = (owners == ((phase + 1) % n_owners)[:, None]).float() \
        * (phase % 2 == 1).float()[:, None]
    return torch.where(congested[:, None],
                       sev * (onehot_a + 0.7 * onehot_b), 0.0)


def observation_noise(generator: torch.Generator, shape: tuple
                      ) -> torch.Tensor:
    """+-3% multiplicative measurement noise (energy and fetch times)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return 1.0 + OBS_NOISE_FRAC * (2.0 * u - 1.0)


def uniform_from_unit(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """A unit uniform ``u`` mapped onto [lo, hi) as ``jax.random.uniform``
    maps its own: ``max(lo, u * (hi - lo) + lo)`` in float32, the bounds
    rounded to float32 first. ``lo`` and ``hi`` are numbers or float32
    tensors broadcasting against ``u``; numbers never become tensors, so
    nothing is copied to the device."""
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        lo_t = lo if isinstance(lo, torch.Tensor) else torch.full_like(
            u, float(np.float32(lo)))
        span = hi - lo_t
        return torch.maximum(lo_t, u * span + lo_t)
    lo32 = np.float32(lo)
    span = float(np.float32(hi) - lo32)
    return torch.clamp(u * span + float(lo32), min=float(lo32))


# ---------------------------------------------------------------------------
# Twins of the event fabric's scenario processes (``net/background.py``),
# step-indexed, batched over a leading env axis: what the queue env's
# windows run per training step. Time is measured in training steps (the
# fabric uses virtual seconds); the continuous-time exponential sojourns of
# ``MarkovOnOffLoad`` become a per-step two-state chain with matching mean
# sojourn lengths.
# ---------------------------------------------------------------------------

def diurnal_util(step: torch.Tensor, period: torch.Tensor,
                 amplitude: torch.Tensor, phase: torch.Tensor
                 ) -> torch.Tensor:
    """Twin of ``DiurnalLoad``: per-link sinusoidal load. ``step``,
    ``period`` and ``amplitude`` are (n,), ``phase`` (n, P): (n, P)."""
    s = torch.sin((2.0 * math.pi * step / torch.clamp(period, min=1.0))
                  [:, None] + phase)
    return (amplitude * 0.5)[:, None] * (1.0 + s)


def incast_util(step: torch.Tensor, period: torch.Tensor,
                burst_frac: torch.Tensor, util: torch.Tensor,
                offset: torch.Tensor, n_links: int) -> torch.Tensor:
    """Twin of ``IncastLoad``: synchronized periodic bursts saturating
    every link at once for ``burst_frac`` of each period. The arguments
    are (n,); returns (n, n_links). The phase is the floored remainder
    (the sign of the period), as ``jnp.mod``'s."""
    p = torch.clamp(period, min=1.0)
    t = torch.remainder(step + offset, p)
    on = (t < burst_frac * p).float()
    return (util * on)[:, None].expand(-1, n_links).contiguous()


def straggler_util(victim: torch.Tensor, util: torch.Tensor, n_links: int
                   ) -> torch.Tensor:
    """Twin of ``StragglerLoad``: one overloaded link, ``victim`` (n,)
    integer: (n, n_links)."""
    onehot = (torch.arange(n_links, device=victim.device)
              == victim[:, None]).float()
    return util[:, None] * onehot


def markov_switch_prob(mean_sojourn_steps: torch.Tensor) -> torch.Tensor:
    """Per-step switch probability of the discretized exponential sojourn,
    1 - exp(-1 / mean), so the expected sojourn length matches
    ``MarkovOnOffLoad``'s continuous-time mean."""
    return 1.0 - torch.exp(-1.0 / torch.clamp(mean_sojourn_steps,
                                               min=1e-6))


def markov_onoff_update(u: torch.Tensor, state: torch.Tensor,
                        p_on: torch.Tensor, p_off: torch.Tensor
                        ) -> torch.Tensor:
    """Twin of ``MarkovOnOffLoad``: advance each per-link two-state chain
    (``state`` (n, P) in {0, 1}) one step on the unit uniforms ``u`` (n,
    P); ``p_on`` and ``p_off`` are (n,)."""
    switch = torch.where(state > 0.5, u < p_off[:, None], u < p_on[:, None])
    return torch.where(switch, 1.0 - state, state)


def step_trace_update(u_flip: torch.Tensor, u_val: torch.Tensor,
                      level: torch.Tensor, p_switch: torch.Tensor,
                      level_max: torch.Tensor) -> torch.Tensor:
    """Twin of ``TraceDelta``'s step-function family: per-link
    piecewise-constant delta [ms] (``level`` (n, P)) whose level resamples
    with probability ``p_switch`` (n,) per step, to a fresh level uniform
    on [0, ``level_max``) (n,); ``u_flip`` and ``u_val`` are the unit
    uniforms of the resample and of the level (n, P)."""
    resample = u_flip < p_switch[:, None]
    fresh = uniform_from_unit(u_val, 0.0, level_max[:, None])
    return torch.where(resample, fresh, level)
