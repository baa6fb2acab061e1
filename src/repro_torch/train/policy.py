"""End-to-end policy pipeline: calibrate -> train Double-DQN -> deploy.

Port of ``repro/train/policy.py`` for the analytic, table, queue and
cluster envs: the paper's three phases (Section IV), Algorithm-1
calibration against the port's trace-driven trainer, simulator training
with domain randomization (``core/dqn.py``, on the card by default), and
a deployable ``q_fn`` for the ``AdaptiveController`` that runs on the
qnet's device.

Artifacts (the qnet's npz and a JSON of its training summary) are cached
under a directory of the port's own, ``$REPRO_TORCH_ARTIFACTS`` or
``.artifacts/torch/`` at the repository root, so a reference-trained npz
is never loaded as the port's.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import zipfile

import numpy as np
import torch

from repro_torch import envs as envs_lib
from repro_torch.core import calibration as cal
from repro_torch.core import cost_model as cm
from repro_torch.core import dqn as dqn_lib
from repro_torch.core import queue_sim
from repro_torch.core import simulator as sim
from repro_torch.core import table_sim
from repro_torch.device import resolve

ENVS = envs_lib.ENVS

ARTIFACT_DIR = os.environ.get(
    "REPRO_TORCH_ARTIFACTS",
    os.path.join(os.path.dirname(__file__), "../../../.artifacts/torch"),
)


def _remote_trace(bundle, run_cfg, n_epochs: int):
    """(remote ids per step of the first ``n_epochs`` epochs, owner index
    of every node, cache capacity, bytes per row)."""
    from repro_torch.graph.features import ShardedFeatureStore

    graph, owner, traces, _ = bundle
    store = ShardedFeatureStore(graph.features, owner, 0, run_cfg.n_parts)
    owner_idx = store.owner_index(np.arange(graph.n_nodes))
    remote_trace = [
        store.remote_ids_of(t) for ep in traces[:n_epochs] for t in ep
    ]
    capacity = int(run_cfg.cache_frac * graph.n_nodes)
    return remote_trace, owner_idx, capacity, store.bytes_per_row


def calibrate_from_bundle(bundle, run_cfg) -> tuple[cm.CostModelParams, dict]:
    """Algorithm 1 against the trace-driven trainer.

    Phase 2: replay the real remote-access trace through the windowed cache
    for a W sweep (hit-rate + rebuild fits), then fit the effective per-node
    miss latency from a (W, delta) grid of measured stall times, each a
    static-window run of the port's ``gnn_trainer.run`` on
    ``run_cfg.device``.
    """
    from repro_torch.train import gnn_trainer as gt

    # greenlint: literal-ok — the reference fits hit rate and rebuild cost on
    # the bundle's first 4 epochs (traces[:4]), whatever run_cfg.n_epochs
    remote_trace, owner_idx, capacity, bytes_per_row = _remote_trace(
        bundle, run_cfg, 4)
    base = cm.CostModelParams(feature_bytes=bytes_per_row)
    theta, diag = cal.calibrate(
        remote_trace, owner_idx, run_cfg.n_parts - 1, capacity, base=base
    )

    # ---- Phase 2b: effective miss latency from a (W, delta) stall grid ----
    r_mean = float(np.mean([len(t) for t in remote_trace]))
    num, den = 0.0, 0.0
    grid = []
    # short bundles may carry fewer than the 3 epochs the grid prefers
    grid_epochs = min(3, len(bundle[2]))
    for delta in (0.0, 10.0, 20.0):
        for w in (4, 16, 64):
            r = gt.run(
                dataclasses.replace(
                    run_cfg, method="static_w", static_window=w,
                    congested=delta > 0, fixed_delta_ms=delta or None,
                    n_epochs=grid_epochs, q_fn=None,
                ),
                bundle,
            )
            t_step = r.meter.wall_s / max(r.meter.n_steps, 1)
            stall = max(t_step - float(theta.t_base), 0.0)
            h = float(r.hit_rate_per_epoch.mean())
            sigma = float(cm.sigma_from_delta(theta, delta))
            factor = r_mean * (1.0 - h) * sigma
            num += stall * factor
            den += factor * factor
            grid.append({"w": w, "delta": delta, "stall": stall, "h": h})
    t_miss0 = num / max(den, 1e-12)
    theta = theta.replace(t_miss0=max(t_miss0, 1e-6), remote_nodes=r_mean)
    diag["miss_grid"] = grid
    diag["t_miss0"] = t_miss0
    return theta, diag


def calibrate_table_from_bundle(bundle, run_cfg) -> table_sim.TableParams:
    """Tabular Phase-2 calibration (see core/table_sim.py): replay the real
    trace through the real cache per (W, allocation) pair."""
    # greenlint: literal-ok — the reference measures its tables on the
    # bundle's first 3 epochs (traces[:3]), whatever run_cfg.n_epochs
    remote_trace, owner_idx, capacity, bytes_per_row = _remote_trace(
        bundle, run_cfg, 3)
    tables = table_sim.measure_table(
        remote_trace, owner_idx, capacity, run_cfg.n_parts - 1
    )
    base = cm.CostModelParams()
    return table_sim.make_table_params(
        tables,
        t_base=float(base.t_base),
        feature_bytes=bytes_per_row,
        slack=run_cfg.prefetch_depth * float(base.t_base),
    )


def make_params_pool(thetas: list, device: str | torch.device = "cuda"):
    """Stack calibrated parameter sets (``CostModelParams`` or
    ``TableParams``) along a leading axis, as float32 tensors on
    ``device``: the episode pool."""
    dev = resolve(device)
    first = thetas[0]
    return dataclasses.replace(first, **{
        f.name: torch.stack([
            torch.as_tensor(getattr(t, f.name), dtype=torch.float32)
            for t in thetas
        ]).to(dev)
        for f in dataclasses.fields(first)
    })


def resolve_env(env, params_pool=None):
    """Resolve an env spec (name, module, or None) to an env module:
    ``"analytic"`` (core.simulator), ``"table"`` (core.table_sim),
    ``"queue"`` (core.queue_sim), ``"cluster"`` (envs.cluster_sim, the
    P-requester twin); None infers from the pool's parameter type."""
    return envs_lib.resolve_env(env, params_pool)


def train_policy(
    params_pool,
    iterations: int = 40_000,
    n_envs: int = 64,
    seed: int = 0,
    env=None,
    steps_per_epoch: int = 32,   # training epoch granularity; the
                                 # batches_remaining observation is
                                 # normalized to [0, 1], so deployment may
                                 # use a different epoch length
    n_epochs: int = 30,
    scenario_pool=None,          # queue/cluster env: registry specs or
                                 # codes
    n_owners: int | None = None,  # remote owners per worker (n_parts - 1,
                                 # default 3); sizes the obs/action spaces
    n_workers: int | None = None,  # cluster env: cluster size P (implies
                                 # n_owners = P - 1)
    cluster_kwargs: dict | None = None,  # cluster env: extra
                                 # ClusterEnvConfig fields (cluster_pool,
                                 # peer_pool, sync, ...)
    device: str = "cuda",
) -> dict:
    """Train a Double-DQN policy in the analytic, table, queue or cluster
    env on ``device`` (the pool must live there). It refuses what the
    reference refuses: ``scenario_pool`` outside the queue and cluster
    envs, an empty pool, ``n_workers`` outside the cluster env, and
    ``n_owners`` other than ``n_workers - 1``; ``cluster_kwargs`` applies
    to the cluster env only."""
    from repro_torch.envs import cluster_sim

    env = resolve_env(env, params_pool)
    if scenario_pool is not None and env not in (queue_sim, cluster_sim):
        raise ValueError(
            "scenario_pool only applies to the queue/cluster envs; the "
            "analytic/table envs draw from the legacy archetype schedule"
        )
    if n_workers is not None and env is not cluster_sim:
        raise ValueError("n_workers only applies to the cluster env")
    if scenario_pool is not None and not scenario_pool:
        raise ValueError("scenario_pool is empty; pass None for the "
                         "default training pool")
    if scenario_pool is not None:
        scenario_pool = tuple(
            queue_sim.code_for(s) if isinstance(s, str) else int(s)
            for s in scenario_pool)
    if env is not cluster_sim and n_owners is None:
        n_owners = 3
    if env is cluster_sim:
        if n_workers is None:
            n_workers = (3 if n_owners is None else n_owners) + 1
        elif n_owners is not None and n_owners != n_workers - 1:
            raise ValueError(
                f"n_workers={n_workers} implies n_owners="
                f"{n_workers - 1}, got n_owners={n_owners}"
            )
        n_owners = n_workers - 1
        kw = dict(cluster_kwargs or {})
        if scenario_pool is not None:
            kw["scenario_pool"] = scenario_pool
        env_cfg = cluster_sim.ClusterEnvConfig(
            n_parts=n_workers, steps_per_epoch=steps_per_epoch,
            n_epochs=n_epochs, **kw,
        )
    elif env is queue_sim:
        if scenario_pool is None:
            scenario_pool = queue_sim.default_training_pool()
        env_cfg = queue_sim.QueueEnvConfig(
            n_owners=n_owners, steps_per_epoch=steps_per_epoch,
            n_epochs=n_epochs, scenario_pool=scenario_pool,
        )
    else:
        env_cfg = sim.EnvConfig(
            n_owners=n_owners, schedule=0, steps_per_epoch=steps_per_epoch,
            n_epochs=n_epochs,
        )
    # warmup scales down with tiny budgets so gradient steps always run:
    # a fixed 2000 would exceed iterations * n_envs inserted transitions
    # and silently return an untrained network
    min_replay = min(2_000, max(iterations * n_envs // 4, 64))
    cfg = dqn_lib.DQNConfig(
        n_envs=n_envs, iterations=iterations, min_replay=min_replay,
        eps_decay_iters=max(iterations // 3, 1), seed=seed,
        n_owners=n_owners, device=device,
    )
    return dqn_lib.train_dqn(cfg, env_cfg, params_pool, env=env)


def get_or_train_policy(
    params_pool,
    name: str = "qnet",
    iterations: int = 40_000,
    force: bool = False,
    env=None,
    device: str = "cuda",
    **train_kw,
):
    """Returns (q_fn, qnet), the qnet on ``device``. Caches the trained
    network under :data:`ARTIFACT_DIR`.

    Named envs get per-env artifacts (``<name>_<env>.npz``), so
    checkpoints trained on different dynamics never collide; the cluster
    env's also carry the cluster size (``<name>_cluster_p<P>.npz``, from
    ``n_workers=P``), since its spaces and its congestion are per P. A
    missing or
    unreadable .npz (fresh clone, partial write, stale format) falls
    through to retraining instead of crashing the caller; regenerate
    explicitly with ``scripts/export_qnet_torch.py``.
    """
    dev = resolve(device)
    if isinstance(env, str):
        resolve_env(env)        # refuses an unknown name
        name = f"{name}_{env}"
        if env == "cluster":
            n_workers = train_kw.get("n_workers") or (
                (train_kw.get("n_owners") or 3) + 1)
            name = f"{name}_p{int(n_workers)}"
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    path = os.path.join(ARTIFACT_DIR, f"{name}.npz")
    qnet = None
    if os.path.exists(path) and not force:
        try:
            qnet = dqn_lib.load_qnet(path, device=dev)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            # corrupt/stale/truncated artifact: log and rebuild it. Anything
            # else (e.g. a bug in load_qnet itself) propagates.
            logging.getLogger(__name__).warning(
                "[policy] could not load %s (%r); retraining", path, e
            )
    if qnet is None:
        result = train_policy(
            params_pool, iterations=iterations, env=env, device=device,
            **train_kw,
        )
        qnet = result["qnet"]
        dqn_lib.save_qnet(path, qnet)
        reward = torch.as_tensor(result["metrics"]["reward"]).cpu().numpy()
        meta = {
            "iterations": iterations,
            "env": env if isinstance(env, str) else "auto",
            "episodes": int(result["episodes"]),
            "grad_steps": int(result.get("grad_steps", 0)),
            "final_reward": float(np.mean(reward[-200:])),
        }
        with open(os.path.join(ARTIFACT_DIR, f"{name}.json"), "w") as f:
            json.dump(meta, f)
    return dqn_lib.q_fn_of(qnet), qnet
