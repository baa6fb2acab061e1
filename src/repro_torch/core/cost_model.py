"""GreenDyGNN analytic cost model (paper Eq. 4) for the trainer's host side.

Port of the parts of ``repro/core/cost_model.py`` that the P=1 trainer
runs: the calibrated parameter set, the window action space, the Eq. 4 RPC
closed forms, the measured-lane compute law and the congestion multiplier.
The vectorised simulator laws (Eq. 1-3) come with the simulator port.

The reference evaluates ``sigma_from_delta`` in float32 with the Python
constants weakly typed (cast to float32 before the arithmetic); this port
reproduces exactly that in numpy so the trainer's sigma trace and the
controller's observation stay bit-identical.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

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
