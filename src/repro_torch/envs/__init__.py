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
  queue         not ported (ROADMAP queue 1   single-requester fluid
                item 2)                       fabric twin
  cluster       not ported (ROADMAP queue 1   P-requester fluid twin
                item 4)
  ============ ============================= ===========================
"""
from __future__ import annotations

# Named training environments, in lineage order.
ENVS = ("analytic", "table", "queue", "cluster")

_NOT_PORTED = {
    "queue": "the queue env (core/queue_sim.py and the fabric-process "
             "twins of domain_rand.py) is not ported yet: ROADMAP queue 1 "
             "item 2",
    "cluster": "the cluster env (envs/cluster_sim.py) is not ported yet: "
               "ROADMAP queue 1 item 4 (the cluster)",
}


def resolve_env(env, params_pool=None):
    """Resolve an env spec (name, module, or None) to an env module.

    ``None`` infers analytic-vs-table from the pool's parameter type.
    ``"queue"`` and ``"cluster"`` raise ``NotImplementedError``."""
    from repro_torch.core import simulator as sim
    from repro_torch.core import table_sim

    if env is None:
        return (
            table_sim
            if isinstance(params_pool, table_sim.TableParams) else sim
        )
    if isinstance(env, str):
        if env in _NOT_PORTED:
            raise NotImplementedError(_NOT_PORTED[env])
        try:
            return {"analytic": sim, "table": table_sim}[env]
        except KeyError:
            raise ValueError(
                f"unknown training env {env!r}; expected one of {ENVS}"
            ) from None
    return env


__all__ = ["ENVS", "resolve_env"]
