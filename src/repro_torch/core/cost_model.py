"""GreenDyGNN analytic cost model (paper Eq. 4) for the trainer's host side.

Port of the parts of ``repro/core/cost_model.py`` that the P=1 trainer,
the event fabric and the baseline policies run: the calibrated parameter
set, the window action space, the Eq. 4 RPC closed forms, the measured-lane
compute law, the congestion multiplier and its Eq. 8 inverse, and the
Eq. 1-3 step laws (``step_time``, ``step_energy``) the oracle minimises.

The reference evaluates these in jnp float32, with Python constants weakly
typed: an operation between two Python constants happens in float64 first
(``remote_nodes * t_miss0``, ``p_gpu_active + p_cpu_base``), and the
result is cast to float32 where it meets an array. This port repeats each
operation in that order in numpy float32, so the sigma trace, the
controller's observation and the policies' actions stay bit-identical.

The training simulators run the tensor forms (``*_t``) of the laws they
call: torch float32, batched over a leading env axis, one law each beside
its host form.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

# Paper-reported calibration constants (Section IV-B).
PAPER_ALPHA_RPC_S = 4.67e-3          # fixed RPC initiation cost [s]
PAPER_BETA_S_PER_BYTE = 1.40e-9      # payload cost [s/byte]
PAPER_GAMMA_C = 2.01e-10             # congestion sensitivity [s/byte/ms]

# Window action space (Section IV-C): W in {1,2,4,8,16,32,64,128}.
WINDOW_CHOICES = (1, 2, 4, 8, 16, 32, 64, 128)

# Ceiling of the Eq. 8 delta inversion, shared by the simulators and the
# deployed controller (2x the eval schedule's severity ceiling).
SCENARIO_DELTA_MAX_MS = 50.0

# One-way injected delay delta [ms] -> propagation seconds on the wall
# clock: the consolidated bulk path pays the full injected RTT, the chunked
# DistTensor path a quarter RTT.
PROP_RTT_BULK_S_PER_MS = 2e-3
PROP_RTT_CHUNKED_S_PER_MS = 0.5e-3

# Background-load ceiling: utilization is clipped here so the fluid service
# factor (1 - u) never reaches zero (read by the event fabric).
MAX_UTILIZATION = 0.95

# Concavity exponent of hit rate vs per-owner capacity share.
ALLOC_RHO = 0.45

_F32 = np.float32


def _powf(x, y) -> np.ndarray:
    """float32 ``x ** y`` element by element through the scalar ``powf``
    (numpy's array loop may take a vectorised pow that differs from it in
    the last bit; the reference's XLA pow agrees with the scalar one)."""
    x = np.asarray(x, _F32)
    y = _F32(y)
    return np.asarray([xi ** y for xi in x.ravel()], _F32).reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class CostModelParams:
    """Calibrated parameter set theta_sim (output of Algorithm 1).

    Same fields and defaults as the reference: the paper's published fit
    plus hit-rate/rebuild parameters placing the clean optimum at W*=16.
    """

    # Eq. (4) RPC model.
    alpha_rpc: float = PAPER_ALPHA_RPC_S
    beta: float = PAPER_BETA_S_PER_BYTE
    gamma_c: float = PAPER_GAMMA_C
    # Eq. (8) inversion ceiling [ms].
    delta_max_ms: float = SCENARIO_DELTA_MAX_MS
    # Eq. (2) hit-rate logistic decay.
    h_min: float = 0.35
    h_max: float = 0.95
    w_half: float = 32.0
    gamma_h: float = 1.25
    # T_rebuild(W) = a + b * W**c (sublinear, 0 < c < 1).
    rebuild_a: float = 4.0e-2
    rebuild_b: float = 1.8e-1
    rebuild_c: float = 0.62
    # Eq. (1) step decomposition.
    t_base: float = 0.010          # compute + AllReduce [s]
    alpha_crit: float = 0.12       # rebuild fraction on critical path
    remote_nodes: float = 96.0     # R, expected remote nodes / batch
    t_miss0: float = 2.5e-4        # clean per-node miss latency [s]
    feature_bytes: float = 400.0   # F_b per-node feature payload
    # AllReduce straggler penalty coefficient [s per unit excess sigma].
    kappa_ar: float = 1.5e-3
    # Power model [W] per node.
    p_gpu_idle: float = 35.0
    p_gpu_active: float = 75.0
    p_cpu_base: float = 325.0
    p_cpu_rpc: float = 260.0

    def replace(self, **kw: Any) -> "CostModelParams":
        return dataclasses.replace(self, **kw)


def rpc_wall_s(
    alpha_rpc, beta, gamma_c, payload_bytes, delta_ms,
    prop_s_per_ms=PROP_RTT_BULK_S_PER_MS,
):
    """Eq. (4) wall clock of ONE consolidated RPC under injected delay:

        alpha + prop * delta + beta * payload + gamma_c * payload * delta

    The term ORDER is part of the contract: bit-reproducibility of runs
    depends on it.
    """
    return (
        alpha_rpc
        + prop_s_per_ms * delta_ms
        + beta * payload_bytes
        + gamma_c * payload_bytes * delta_ms
    )


def rpc_cpu_s(alpha_rpc, beta, gamma_c, payload_bytes, delta_ms):
    """Eq. (4) CPU *processing* component of one RPC (no network wait);
    same term-order contract as :func:`rpc_wall_s`."""
    return (
        alpha_rpc
        + beta * payload_bytes
        + gamma_c * payload_bytes * delta_ms
    )


def compute_step_s(t0, per_edge, n_edges):
    """Per-step compute-time law of the measured lane:
    ``t_step = t0 + per_edge * n_edges`` (same term order as the
    reference)."""
    return t0 + per_edge * n_edges


def sigma_from_delta(params: CostModelParams, delta_ms) -> np.ndarray:
    """Congestion multiplier sigma_o = 1 + (gamma_c / beta) * delta_ms,
    in float32 (the slope is divided in float64, then cast, as the
    reference's weakly-typed scalar is)."""
    slope = np.float32(params.gamma_c / params.beta)  # [1/ms]
    return np.float32(1.0) + slope * np.asarray(delta_ms, np.float32)


def delta_from_sigma(params: CostModelParams, sigma) -> np.ndarray:
    """Eq. (8) inverse mapping: delta_hat = (sigma - 1) * beta / gamma_c
    (float32, left to right)."""
    return ((np.asarray(sigma, _F32) - _F32(1.0)) * _F32(params.beta)
            / _F32(params.gamma_c))


def hit_rate(params: CostModelParams, window) -> np.ndarray:
    """Eq. (2): logistic decay of cache hit rate with window size."""
    w = np.asarray(window, _F32)
    span = params.h_max - params.h_min            # two Python floats
    return _F32(params.h_min) + _F32(span) / (
        _F32(1.0) + _powf(w / _F32(params.w_half), params.gamma_h)
    )


def rebuild_time(params: CostModelParams, window) -> np.ndarray:
    """T_rebuild(W) = a + b * W**c."""
    w = np.asarray(window, _F32)
    return _F32(params.rebuild_a) + _F32(params.rebuild_b) * _powf(
        w, params.rebuild_c
    )


def allreduce_penalty(params: CostModelParams, sigma) -> np.ndarray:
    """dT_AR = kappa_AR * max(max_o sigma_o - 1, 0)."""
    s = np.asarray(sigma, _F32)
    return _F32(params.kappa_ar) * np.maximum(
        np.max(s, axis=-1) - _F32(1.0), _F32(0.0)
    )


def per_owner_hit_rates(params: CostModelParams, window, weights
                        ) -> np.ndarray:
    """Per-owner hit rate under capacity shares ``weights`` (sum to 1):
    ``clip(h(W) * (weights * n_owners) ** ALLOC_RHO, 0, h_max)``."""
    weights = np.asarray(weights, _F32)
    n_owners = weights.shape[-1]
    base = hit_rate(params, window)
    scale = _powf(weights * _F32(n_owners), ALLOC_RHO)
    return np.clip(base * scale, _F32(0.0), _F32(params.h_max))


def step_time(params: CostModelParams, window, sigma, weights=None,
              hit_rate_override=None) -> np.ndarray:
    """Eq. (1) with congestion (Eq. 3), per-owner allocation and the
    AllReduce straggler term; ``sigma`` and ``weights`` are (..., P-1)."""
    sigma = np.asarray(sigma, _F32)
    n_owners = sigma.shape[-1]
    if weights is None:
        weights = np.full((n_owners,), 1.0 / n_owners, _F32)
    if hit_rate_override is not None:
        h_o = np.broadcast_to(np.asarray(hit_rate_override, _F32),
                              sigma.shape)
    else:
        h_o = per_owner_hit_rates(params, window, weights)
    miss = _F32(params.remote_nodes * params.t_miss0) * np.max(
        (_F32(1.0) - h_o) * sigma, axis=-1
    )
    rebuild = _F32(params.alpha_crit) * rebuild_time(params, window) \
        / np.asarray(window, _F32)
    return _F32(params.t_base) + allreduce_penalty(params, sigma) \
        + rebuild + miss


def step_energy(params: CostModelParams, window, sigma, weights=None,
                hit_rate_override=None) -> np.ndarray:
    """E_step ~= Pbar * T_step: the compute fraction at GPU-active power,
    the communication/stall fraction at GPU-idle plus RPC-side CPU
    power. Joules per step per node."""
    t_total = step_time(params, window, sigma, weights, hit_rate_override)
    t_comm = np.maximum(t_total - _F32(params.t_base), _F32(0.0))
    e_compute = (params.p_gpu_active + params.p_cpu_base) * params.t_base
    e_comm = _F32(params.p_gpu_idle + params.p_cpu_base + params.p_cpu_rpc) \
        * t_comm
    return _F32(e_compute) + e_comm


def optimal_window(params: CostModelParams, sigma):
    """Exhaustive argmin of ``step_energy`` over the discrete window set
    (uniform allocation): ``(window, energy)`` as float32."""
    windows = np.asarray(WINDOW_CHOICES, _F32)
    energies = np.asarray([step_energy(params, w, sigma) for w in windows],
                          _F32)
    idx = int(np.argmin(energies))
    return windows[idx], energies[idx]


# ---------------------------------------------------------------------------
# Tensor forms for the training simulators. ``params`` is a parameter set
# whose fields are float32 tensors of shape (n,), one entry per env (the
# reference vmaps one episode over a pool entry); ``window`` is (n,) or a
# number, ``sigma`` and ``weights`` are (n, P-1). Where the reference
# divides a number by an array these divide two tensors: torch computes
# ``number / tensor`` as a product with the reciprocal. torch's pow may
# differ from XLA's in the last bit, so these hold the host forms within
# a tolerance, not bit for bit.
# ---------------------------------------------------------------------------

def _window_t(params, window) -> torch.Tensor:
    if isinstance(window, torch.Tensor):
        return window
    return torch.full_like(params.t_base, float(window))


def sigma_from_delta_t(params, delta_ms: torch.Tensor) -> torch.Tensor:
    """sigma_o = 1 + (gamma_c / beta) * delta_ms: (n, P-1)."""
    slope = params.gamma_c / params.beta
    return 1.0 + slope[:, None] * delta_ms


def hit_rate_t(params, window) -> torch.Tensor:
    """Eq. (2): (n,)."""
    w = _window_t(params, window)
    span = params.h_max - params.h_min
    return params.h_min + span / (1.0 + (w / params.w_half) ** params.gamma_h)


def rebuild_time_t(params, window) -> torch.Tensor:
    """T_rebuild(W) = a + b * W**c: (n,)."""
    w = _window_t(params, window)
    return params.rebuild_a + params.rebuild_b * w ** params.rebuild_c


def allreduce_penalty_t(params, sigma: torch.Tensor) -> torch.Tensor:
    """dT_AR = kappa_AR * max(max_o sigma_o - 1, 0): (n,)."""
    return params.kappa_ar * torch.clamp(sigma.amax(-1) - 1.0, min=0.0)


def per_owner_hit_rates_t(params, window, weights: torch.Tensor
                          ) -> torch.Tensor:
    """Per-owner hit rate under capacity shares ``weights``: (n, P-1)."""
    n_owners = weights.shape[-1]
    base = hit_rate_t(params, window)
    scale = (weights * n_owners) ** ALLOC_RHO
    return torch.minimum(torch.clamp(base[:, None] * scale, min=0.0),
                         params.h_max[:, None])


def step_time_t(params, window, sigma: torch.Tensor,
                weights: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. (1) with congestion (Eq. 3), per-owner allocation and the
    AllReduce straggler term: (n,). ``weights=None`` is uniform."""
    w = _window_t(params, window)
    if weights is None:
        weights = torch.full_like(sigma, 1.0 / sigma.shape[-1])
    h_o = per_owner_hit_rates_t(params, w, weights)
    miss = params.remote_nodes * params.t_miss0 * (
        (1.0 - h_o) * sigma).amax(-1)
    rebuild = params.alpha_crit * rebuild_time_t(params, w) / w
    return params.t_base + allreduce_penalty_t(params, sigma) + rebuild \
        + miss


def step_energy_t(params, window, sigma: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """E_step ~= Pbar * T_step, joules per step per node: (n,)."""
    t_total = step_time_t(params, window, sigma, weights)
    t_comm = torch.clamp(t_total - params.t_base, min=0.0)
    e_compute = (params.p_gpu_active + params.p_cpu_base) * params.t_base
    e_comm = (params.p_gpu_idle + params.p_cpu_base + params.p_cpu_rpc) \
        * t_comm
    return e_compute + e_comm
