"""repro_torch.envs — the RL training-environment registry.

Port of ``repro/envs/__init__.py``. Every training environment implements
one protocol, batched over a leading env axis, so ``dqn.train_dqn``,
``train/policy.py`` and ``scripts/export_qnet_torch.py`` enumerate them
uniformly:

    reset(cfg, draws, params) -> EnvState      # EnvState.obs, .done, ...
    step(cfg, state, action, draws) -> (EnvState, obs, reward, done)

  ============ ============================= ===========================
  name          module                        congestion model
  ============ ============================= ===========================
  analytic      ``core.simulator``            parametric Eq. 1-4 law,
                                              legacy archetype schedule
  table         ``core.table_sim``            trace-calibrated hit/stall
                                              tables, parametric sigma
  queue         ``core.queue_sim``            single-requester fluid
                                              fabric twin, scenario-
                                              conditioned
  cluster       ``envs.cluster_sim``          P-requester fluid twin:
                                              shared owner NICs, peer
                                              rebuild storms, barrier and
                                              ring-collective coupling,
                                              rank heterogeneity, demand
                                              skew
  ============ ============================= ===========================
"""
from __future__ import annotations

# Named training environments, in lineage order.
ENVS = ("analytic", "table", "queue", "cluster")


def resolve_env(env, params_pool=None):
    """Resolve an env spec (name, module, or None) to an env module.

    ``None`` infers analytic-vs-table from the pool's parameter type."""
    from repro_torch.core import queue_sim
    from repro_torch.core import simulator as sim
    from repro_torch.core import table_sim
    from repro_torch.envs import cluster_sim

    if env is None:
        return (
            table_sim
            if isinstance(params_pool, table_sim.TableParams) else sim
        )
    if isinstance(env, str):
        try:
            return {"analytic": sim, "table": table_sim,
                    "queue": queue_sim, "cluster": cluster_sim}[env]
        except KeyError:
            raise ValueError(
                f"unknown training env {env!r}; expected one of {ENVS}"
            ) from None
    return env


__all__ = ["ENVS", "resolve_env"]
