"""Double-DQN agent (paper Section IV-C.2).

Port of ``repro/core/dqn.py``: the 23 -> 256 ReLU -> 256 ReLU -> 32
Q-network, its He-normal init and the reference's npz layout (keys
``l1.w``, ``l1.b``, ... ``l3.b``), so a policy trained by either package
drives the other's controller; and the training loop: Double-DQN target y
= r + gamma * Q_target(s', argmax_a Q_online(s', a)), Huber loss, Adam
with gradient clipping at 10, a 50k replay ring, batch 64, gamma 0.99,
epsilon-greedy 1.0 -> 0.05, target sync every 100 gradient steps.

The reference's training loop is one ``lax.scan`` over (vectorised env
step -> replay insert -> gradient step). Here it is a Python loop over
iterations, each a few hundred eager launches on the device, reading
nothing back to the host: every random draw comes from one
``torch.Generator`` on the device, and what decides control flow (the
replay's size, whether updates have begun, the gradient-step count and
so the target sync) is known on the host from the iteration number.

A qnet is a plain dict ``{"l1": {"w": (in, out), "b": (out,)}, ...}`` of
float32 tensors, the reference's layout.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import optim
from repro_torch.core import controller as ctl
from repro_torch.core import simulator as sim
from repro_torch.device import resolve
from repro_torch.optim.optimizers import tree_leaves, tree_map

HIDDEN = 256
GAMMA = 0.99
REPLAY_CAPACITY = 50_000
BATCH_SIZE = 64
GRAD_CLIP = 10.0
TARGET_SYNC_EVERY = 100
EPS_START, EPS_END = 1.0, 0.05
LEARNING_RATE = 3e-4


def init_qnet(generator: torch.Generator, state_dim: int, n_actions: int,
              device: torch.device | str = "cpu") -> dict:
    """He-normal weights (std sqrt(2 / n_in)) and zero biases, drawn from
    ``generator`` (a CPU generator, so the draw does not depend on the
    device)."""

    def dense(n_in, n_out):
        w = torch.randn((n_in, n_out), generator=generator) \
            * math.sqrt(2.0 / n_in)
        return {"w": w.to(device), "b": torch.zeros(n_out, device=device)}

    return {
        "l1": dense(state_dim, HIDDEN),
        "l2": dense(HIDDEN, HIDDEN),
        "l3": dense(HIDDEN, n_actions),
    }


def q_forward(params: dict, state: torch.Tensor) -> torch.Tensor:
    x = torch.relu(state @ params["l1"]["w"] + params["l1"]["b"])
    x = torch.relu(x @ params["l2"]["w"] + params["l2"]["b"])
    return x @ params["l3"]["w"] + params["l3"]["b"]


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    absx = torch.abs(x)
    return torch.where(absx <= delta, 0.5 * x * x,
                       delta * (absx - 0.5 * delta))


@dataclasses.dataclass
class Replay:
    """A ring of transitions on the device; ``ptr`` and ``size`` are
    host integers (every insert adds a known count)."""

    s: torch.Tensor
    a: torch.Tensor
    r: torch.Tensor
    s2: torch.Tensor
    done: torch.Tensor
    ptr: int = 0
    size: int = 0


def init_replay(state_dim: int, capacity: int = REPLAY_CAPACITY,
                device: torch.device | str = "cpu") -> Replay:
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Replay(s=zeros(capacity, state_dim),
                  a=zeros(capacity, dtype=torch.int64), r=zeros(capacity),
                  s2=zeros(capacity, state_dim),
                  done=zeros(capacity, dtype=torch.bool))


def replay_insert(buf: Replay, s, a, r, s2, done) -> Replay:
    """Insert a batch of transitions at the ring pointer (wraps), in
    place; returns ``buf``."""
    n = s.shape[0]
    capacity = buf.s.shape[0]
    if n > capacity:
        raise ValueError(f"{n} transitions exceed the capacity {capacity}")
    head = min(n, capacity - buf.ptr)
    for dst, src in ((buf.s, s), (buf.a, a), (buf.r, r), (buf.s2, s2),
                     (buf.done, done)):
        dst[buf.ptr:buf.ptr + head] = src[:head]
        if head < n:
            dst[:n - head] = src[head:]
    buf.ptr = (buf.ptr + n) % capacity
    buf.size = min(buf.size + n, capacity)
    return buf


def replay_sample(buf: Replay, generator: torch.Generator,
                  batch: int = BATCH_SIZE):
    """``batch`` transitions drawn uniformly from the filled slots."""
    idx = torch.randint(0, max(buf.size, 1), (batch,), generator=generator,
                        device=buf.s.device)
    return buf.s[idx], buf.a[idx], buf.r[idx], buf.s2[idx], buf.done[idx]


def dqn_loss(online: dict, target: dict, s, a, r, s2, done
             ) -> torch.Tensor:
    """Double-DQN (Eq. 6): the online net selects, the target net
    evaluates; the target carries no gradient. ``q_sa`` is a gather (one
    index a row), so its backward has no colliding atomics."""
    q = q_forward(online, s)
    q_sa = torch.take_along_dim(q, a[:, None], dim=1)[:, 0]
    with torch.no_grad():
        a_star = torch.argmax(q_forward(online, s2), dim=1)
        q_next = torch.take_along_dim(q_forward(target, s2), a_star[:, None],
                                      dim=1)[:, 0]
        y = r + GAMMA * q_next * (1.0 - done.float())
    return torch.mean(huber(q_sa - y))


def loss_and_grads(online: dict, target: dict, batch
                   ) -> tuple[torch.Tensor, dict]:
    """``dqn_loss`` and its gradients with respect to ``online``."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), online)
    loss = dqn_loss(params, target, *batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(params)))
    return loss.detach(), tree_map(lambda _: next(grads), params)


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    n_owners: int = 3
    n_envs: int = 32
    iterations: int = 20_000
    min_replay: int = 1_000
    eps_decay_iters: int = 5_000          # paper: over 5000 episodes
    learning_rate: float = LEARNING_RATE
    seed: int = 0
    device: str = "cuda"


def epsilon(it: int, decay_iters: int) -> float:
    """The exploration rate at iteration ``it`` (float32, as the
    reference computes it)."""
    f32 = np.float32
    eps = f32(EPS_START) - f32(EPS_START - EPS_END) * f32(it) / f32(
        decay_iters)
    return float(max(f32(EPS_END), eps))


def train_dqn(cfg: DQNConfig, env_cfg, params_pool, env=sim) -> dict:
    """Train the agent in the calibrated simulator with domain
    randomization, on ``cfg.device``.

    ``params_pool`` is a parameter set whose fields are stacked along a
    leading axis, one entry per calibrated dataset x batch size (each
    reset picks one uniformly), on ``cfg.device``. ``env`` is the
    analytic simulator (``core.simulator``), the trace-calibrated
    tabular one (``core.table_sim``) or the queue env
    (``core.queue_sim``); its draws come from its own ``Draws`` where it
    has one, and ``env_cfg.observe_headroom`` adds the state's trailing
    headroom entry. Returns the online qnet, the
    per-iteration metrics (device tensors of length ``iterations``: loss,
    mean reward, epsilon, episodes so far, gradient steps so far, whether
    the target synced), the episode count (a device tensor) and the
    gradient-step count."""
    dev = resolve(cfg.device)
    n_pool = params_pool.t_base.shape[0]
    state_dim = ctl.state_dim(
        cfg.n_owners,
        headroom=getattr(env_cfg, "observe_headroom", False),
    )
    n_act = ctl.n_actions(cfg.n_owners)

    g = torch.Generator(device=dev).manual_seed(cfg.seed)
    draws = getattr(env, "Draws", sim.Draws)(g)
    online = init_qnet(torch.Generator().manual_seed(cfg.seed), state_dim,
                       n_act, device=dev)
    target = tree_map(torch.clone, online)
    opt = optim.adam(cfg.learning_rate, max_grad_norm=GRAD_CLIP)
    opt_state = opt.init(online)
    replay = init_replay(state_dim, device=dev)

    def reset_all():
        idx = torch.randint(0, n_pool, (cfg.n_envs,), generator=g,
                            device=dev)
        return env.reset(env_cfg, draws, sim.take(params_pool, idx))

    envs = reset_all()
    loss_m = torch.zeros(cfg.iterations, device=dev)
    reward_m = torch.zeros(cfg.iterations, device=dev)
    episodes_m = torch.zeros(cfg.iterations, dtype=torch.int64, device=dev)
    eps_m = np.zeros(cfg.iterations, np.float32)
    grad_steps_m = np.zeros(cfg.iterations, np.int64)
    synced_m = np.zeros(cfg.iterations, bool)
    ep_count = torch.zeros((), dtype=torch.int64, device=dev)
    grad_steps = 0

    for it in range(cfg.iterations):
        eps = epsilon(it, cfg.eps_decay_iters)

        # --- vectorized epsilon-greedy action selection ---------------
        obs = envs.obs
        with torch.no_grad():
            greedy = torch.argmax(q_forward(online, obs), dim=1)
            randoms = torch.randint(0, n_act, (cfg.n_envs,), generator=g,
                                    device=dev)
            explore = torch.rand(cfg.n_envs, generator=g, device=dev) < eps
            actions = torch.where(explore, randoms, greedy)

            # --- env step, replay, reset of finished episodes ---------
            nxt, obs2, rewards, dones = env.step(env_cfg, envs, actions,
                                                 draws)
            replay_insert(replay, obs, actions, rewards, obs2, dones)
            envs = sim.select(dones, reset_all(), nxt)
            ep_count = ep_count + dones.sum()

        # --- gradient step, once the replay holds min_replay ----------
        batch = replay_sample(replay, g)
        ready = replay.size >= cfg.min_replay
        loss, grads = loss_and_grads(online, target, batch)
        if ready:
            updates, opt_state = opt.update(grads, opt_state, online)
            online = optim.apply_updates(online, updates)
            grad_steps += 1
        # target sync every 100 GRADIENT steps (Sec. IV-C.2), not scan
        # iterations: updates begin only after the warmup
        sync = ready and grad_steps % TARGET_SYNC_EVERY == 0
        if sync:
            target = tree_map(torch.clone, online)

        loss_m[it] = loss
        reward_m[it] = rewards.mean()
        episodes_m[it] = ep_count
        eps_m[it], grad_steps_m[it], synced_m[it] = eps, grad_steps, sync

    metrics = {
        "loss": loss_m, "reward": reward_m,
        "eps": torch.as_tensor(eps_m, device=dev), "episodes": episodes_m,
        "grad_steps": torch.as_tensor(grad_steps_m, device=dev),
        "synced": torch.as_tensor(synced_m, device=dev),
    }
    return {"qnet": online, "metrics": metrics, "episodes": ep_count,
            "grad_steps": grad_steps}


def greedy_policy(qnet: dict):
    """``policy_fn(obs) -> actions`` (batched) for
    ``simulator.rollout_policy``."""

    @torch.no_grad()
    def fn(obs: torch.Tensor) -> torch.Tensor:
        return torch.argmax(q_forward(qnet, obs), dim=-1)

    return fn


def q_fn_of(params: dict):
    """``q_fn(state: np.ndarray) -> np.ndarray`` for the controller, on
    the device the qnet's tensors live on."""
    device = params["l1"]["w"].device

    @torch.no_grad()
    def q_fn(state: np.ndarray) -> np.ndarray:
        s = torch.as_tensor(np.asarray(state, np.float32), device=device)
        return q_forward(params, s).cpu().numpy()

    return q_fn


def save_qnet(path: str, qnet: dict) -> None:
    flat = {
        f"{layer}.{name}": v.detach().cpu().numpy()
        for layer, sub in qnet.items()
        for name, v in sub.items()
    }
    np.savez(path, **flat)


def load_qnet(path: str, device: torch.device | str = "cpu") -> dict:
    out: dict[str, dict[str, torch.Tensor]] = {}
    with np.load(path) as data:
        for key in data.files:
            layer, name = key.split(".")
            out.setdefault(layer, {})[name] = torch.as_tensor(
                data[key], device=device
            )
    return out
