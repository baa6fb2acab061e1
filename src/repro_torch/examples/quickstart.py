"""Quickstart: the GreenDyGNN control loop in 60 lines.

Calibrates nothing (the paper's defaults), trains a small Double-DQN
policy in the analytic simulator, and shows it adapting the rebuild
window to congestion against the paper's baselines:

    python -m repro_torch.examples.quickstart [--device cuda]

Port of ``examples/quickstart.py``. The episodes draw from a
``torch.Generator`` seeded with 0, a fresh one for each policy, as the
reference rolls each policy out from ``PRNGKey(0)``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import cost_model as cm
from repro_torch.core import dqn, policies
from repro_torch.core import simulator as sim
from repro_torch.device import resolve
from repro_torch.train.policy import make_params_pool

DELTAS_MS = (0.0, 4.0, 20.0)
TRAIN = dict(n_envs=16, iterations=2500, min_replay=500, eps_decay_iters=1200)
EVAL_SEED = 0


def optimal_windows(params: cm.CostModelParams, deltas=DELTAS_MS) -> list:
    """The energy-optimal rebuild window and its energy per step when one
    of three links carries ``delta`` ms (Section II-C): ``(delta, W*,
    E*)`` a delta."""
    out = []
    for delta_ms in deltas:
        sigma = np.asarray([cm.sigma_from_delta(params, delta_ms), 1.0, 1.0],
                           np.float32)
        w_star, e_star = cm.optimal_window(params, sigma)
        out.append((delta_ms, int(w_star), float(e_star)))
    return out


def train(params: cm.CostModelParams, device) -> dict:
    """Double-DQN in the analytic simulator under domain-randomized
    congestion (Section IV-C), on ``device``."""
    pool = make_params_pool([params], device=device)
    return dqn.train_dqn(dqn.DQNConfig(**TRAIN, device=str(device)),
                         sim.EnvConfig(schedule=0), pool)


def _batched(policy_fn):
    """A host policy of one observation as ``rollout_policy``'s batched
    ``policy_fn``."""

    def fn(obs: torch.Tensor) -> torch.Tensor:
        actions = [policy_fn(o) for o in obs.cpu().numpy()]
        return torch.as_tensor(actions, device=obs.device)

    return fn


def contenders(params: cm.CostModelParams, qnet: dict | None) -> list:
    """(name, batched policy) of the paper's baselines, the trained agent
    (where ``qnet`` is given) and the oracle."""
    out = [
        ("static W=16 (w/o RL)", _batched(policies.static_policy(16))),
        ("epoch-level (RapidGNN)", _batched(policies.static_policy(128))),
        ("heuristic (Eq. 7)", _batched(policies.heuristic_policy(params))),
    ]
    if qnet is not None:
        out.append(("Double-DQN (GreenDyGNN)", dqn.greedy_policy(qnet)))
    out.append(("oracle", _batched(policies.oracle_policy(params))))
    return out


def evaluate(params: cm.CostModelParams, qnet: dict | None, draws_of,
             device) -> dict:
    """Each contender's total energy (J a node) over one episode of the
    paper's congestion pattern (schedule 1), each episode drawing from a
    fresh ``draws_of()``."""
    eval_cfg = sim.EnvConfig(schedule=1)
    pool = make_params_pool([params], device=device)
    return {
        name: float(sim.rollout_policy(eval_cfg, draws_of(), pool,
                                       policy)["total_energy"][0])
        for name, policy in contenders(params, qnet)
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    params = cm.CostModelParams()  # paper-faithful calibration defaults

    # 1. The tradeoff the paper formalizes: the energy-optimal rebuild
    #    window shifts when a link becomes congested (Section II-C).
    for delta_ms, w_star, e_star in optimal_windows(params):
        print(f"delta={delta_ms:4.1f} ms -> W*={w_star:3d} "
              f"(E*={e_star:.2f} J/step)")

    # 2. Train a Double-DQN agent in the calibrated simulator.
    result = train(params, dev)
    reward = result["metrics"]["reward"][-200:].mean()
    print(f"trained: {int(result['episodes'])} episodes, "
          f"final mean reward {float(reward):.3f}")

    # 3. Evaluate against the paper's baselines on the eval schedule.
    energies = evaluate(
        params, result["qnet"],
        lambda: sim.Draws(torch.Generator(dev).manual_seed(EVAL_SEED)), dev)
    for name, joules in energies.items():
        print(f"{name:26s} total energy {joules / 1e3:7.2f} kJ/node")
    return energies


if __name__ == "__main__":
    main()
