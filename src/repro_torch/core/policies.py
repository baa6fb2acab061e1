"""Cache-control policies: the paper's baselines, ablations and fallback.

Port of ``repro/core/policies.py`` in numpy float32. Every policy is a
``policy_fn(obs, key=None) -> action`` over the same 32-action space, so
the live trainer treats them uniformly:

  * static(W)          fixed rebuild window, uniform allocation
  * heuristic          the paper's threshold fallback rule (Eq. 7)
  * oracle             argmin of the calibrated ``step_energy`` given the
                       observed sigma (an upper bound; not deployable)
  * dqn                the learned Double-DQN policy (``core/dqn.py``)
  * dqn_window_only    RL chooses W, allocation forced uniform

None of them draws random numbers, so the reference's PRNG ``key`` is
accepted and ignored.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import controller as ctl
from repro_torch.core import cost_model as cm
from repro_torch.core import dqn as dqn_lib

# RapidGNN rebuilds once per epoch: with 128 steps/epoch the closest member
# of the discrete window set is 128.
EPOCH_WINDOW = 128
DEFAULT_STATIC_WINDOW = 16

_F32 = np.float32


def _window_action(window: int, n_owners: int) -> int:
    w_idx = cm.WINDOW_CHOICES.index(window)
    return ctl.encode_action(w_idx, 0, n_owners)


def static_policy(window: int = DEFAULT_STATIC_WINDOW, n_owners: int = 3):
    action = _window_action(window, n_owners)

    def fn(obs, key=None) -> int:
        return action

    return fn


def heuristic_policy(params: cm.CostModelParams,
                     w0: int = DEFAULT_STATIC_WINDOW, n_owners: int = 3):
    """Eq. (7): W = W0 if delta <= 1 ms; W0/2 if 1 < delta <= 6 ms; W0/4
    otherwise, with delta_hat inferred from the largest observed sigma
    (the first P-1 entries of the state) by the Eq. 8 inverse."""
    choices = np.asarray(cm.WINDOW_CHOICES, _F32)

    def fn(obs, key=None) -> int:
        sigma_max = np.max(np.asarray(obs, _F32)[:n_owners])
        delta = cm.delta_from_sigma(params, sigma_max)
        if delta <= _F32(1.0):
            w = _F32(w0)
        elif delta <= _F32(6.0):
            w = _F32(w0 // 2)
        else:
            w = _F32(w0 // 4)
        w_idx = int(np.argmin(np.abs(choices - w)))
        return w_idx * (n_owners + 1)          # uniform allocation

    return fn


def oracle_policy(params: cm.CostModelParams, n_owners: int = 3):
    """Exhaustive argmin over all actions of ``step_energy`` at the
    observed sigma (the first P-1 entries of the state)."""
    n_act = ctl.n_actions(n_owners)

    def fn(obs, key=None) -> int:
        sigma = np.asarray(obs, _F32)[:n_owners]
        energies = np.empty(n_act, _F32)
        for a in range(n_act):
            w, weights = ctl.decode_action(a, n_owners)
            energies[a] = cm.step_energy(params, w, sigma, weights)
        return int(np.argmin(energies))

    return fn


def _q_values(qnet: dict, obs) -> torch.Tensor:
    device = qnet["l1"]["w"].device
    with torch.no_grad():
        s = torch.as_tensor(np.asarray(obs, _F32), device=device)
        return dqn_lib.q_forward(qnet, s)


def dqn_policy(qnet: dict):
    """Greedy action of the Q-network."""

    def fn(obs, key=None) -> int:
        return int(torch.argmax(_q_values(qnet, obs)))

    return fn


def dqn_window_only_policy(qnet: dict, n_owners: int = 3):
    """w/o Cost Weights ablation: mask all biased-allocation actions."""
    n_a = n_owners + 1

    def fn(obs, key=None) -> int:
        q = _q_values(qnet, obs)
        mask = (torch.arange(q.shape[-1], device=q.device) % n_a) == 0
        return int(torch.argmax(torch.where(mask, q, -torch.inf)))

    return fn


def as_q_fn(policy_fn, n_actions_total: int):
    """Adapt a policy_fn to the AdaptiveController's ``q_fn`` interface:
    1 at the policy's action, -1 elsewhere."""

    def q_fn(state):
        action = int(policy_fn(np.asarray(state, _F32)))
        q = np.full((n_actions_total,), -1.0, _F32)
        q[action] = 1.0
        return q

    return q_fn
