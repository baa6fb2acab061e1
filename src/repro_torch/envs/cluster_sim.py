"""Cluster-twin training environment: P requesters over shared owner NICs,
batched.

Port of ``repro/envs/cluster_sim.py``. The queue env
(``core/queue_sim.py``) is a fluid twin of the event fabric for a single
requester, its congestion injected by background processes. The cluster
driver (``train/cluster.py``) runs P live trainers over one fabric, where
congestion also emerges from the ranks themselves: incast at a hot
feature owner, peer rebuild storms on the shared NICs, stragglers felt
through the per-step gradient-sync barrier. This env is the P-requester
twin the reference trains its cluster policies in:

  * **shared owner NICs**: the ego rank's per-owner link queues take its
    own miss and rebuild fetches (the queue env's law) and the miss
    traffic and synchronized rebuild storms of ``n_peers`` scripted
    peers, queued FIFO ahead of the ego's new arrivals. Peer rank i + 1
    owns partition i + 1, the ego's owner slot i, and never fetches from
    its own NIC;
  * **scripted peers**: a static W = 16 or a congestion-reactive cache
    policy (the window shrinks with the sigma it sees), mixed per episode;
  * **lockstep barrier**: each step ends in the gradient sync the cluster
    driver charges, a wait for the slowest live rank and then the ring
    collective (a float32 twin of ``ring_collective_cost``), with
    ``EnergyMeter.record_sync``'s energy;
  * **heterogeneity and demand skew**: the emergent archetypes the cluster
    sweep evaluates (``clean``, ``hot_owner``, ``slow_worker``,
    ``demand_skew``), domain-randomized, over the queue env's injected
    overlay pool, with the number of live peers randomized too;
  * **observations** are the queue env's (``queue_sim._observe``).

Every tensor carries a leading env axis, as in the queue env, and a
decision's window of ``MAX_WINDOW`` = 128 masked steps runs in one launch
of the hand-written CUDA kernel ``kernels/csrc/cluster_window.cu``
(``kernels/cluster_window``), which runs the queue env's window code with
the cluster's terms added; its plain version, the eager masked loop, runs
on the CPU. The random draws come through :class:`ClusterDraws`: the
queue env's draws from the same generator in the same order, and the
cluster's from a second generator seeded from the first's seed, so that
no cluster draw moves the queue env's stream.

Reduction: with ``peer_pool=(0,)`` and ``cluster_pool=(0,)`` every added
term is an exact zero or one, and an episode equals the queue env's on
the same draws bit for bit (the reference states this contract and
misses it by 1.19e-7; the port shares the queue env's code and holds it).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import controller as ctl
from repro_torch.core import cost_model as cm
from repro_torch.core import domain_rand as dr
from repro_torch.core import queue_sim as qs
from repro_torch.core import simulator as sim
from repro_torch.device import constant
from repro_torch.kernels.cluster_window import ops as cw

MAX_WINDOW = qs.MAX_WINDOW
REFERENCE_WINDOW = qs.REFERENCE_WINDOW
PROP_RTT_S_PER_MS = qs.PROP_RTT_S_PER_MS
ACTIVE_ROWS_SCALE = qs.ACTIVE_ROWS_SCALE
REBUILD_FETCH_FRAC = qs.REBUILD_FETCH_FRAC

# Emergent cluster archetypes: the names the cluster sweep registers as its
# emergent scenarios.
CLUSTER_CODES = {
    "clean": 0,
    "hot_owner": 1,
    "slow_worker": 2,
    "demand_skew": 3,
}
N_CLUSTER = len(CLUSTER_CODES)

SYNC_MODES = ("allreduce", "reduce_scatter", "none")
PEER_POLICIES = ("static", "greendygnn", "mixed")

# a second generator's seed, from the first's (the reference folds its
# cluster keys off k_pool with this constant)
_CLUSTER_SEED_SALT = 0xC1


def default_cluster_pool() -> tuple[int, ...]:
    """All four emergent archetypes, uniformly sampled per episode."""
    return tuple(CLUSTER_CODES[n] for n in (
        "clean", "hot_owner", "slow_worker", "demand_skew",
    ))


def cluster_code_for(spec: str) -> int:
    """An emergent-scenario name of the cluster sweep as its training code
    (overlay names go through ``queue_sim.code_for``)."""
    name = spec.split(":", 1)[0]
    if name not in CLUSTER_CODES:
        raise KeyError(
            f"no cluster-sim archetype for scenario {spec!r}; "
            f"known: {', '.join(sorted(CLUSTER_CODES))}"
        )
    return CLUSTER_CODES[name]


# ------------------------------------------------------------- env cfg
@dataclasses.dataclass(frozen=True)
class ClusterEnvConfig:
    """Shape of the P-rank cluster the ego trains inside: the ego is rank
    0 of ``n_parts`` and sees ``n_owners = n_parts - 1`` remote owners,
    which sizes the observation and action spaces as deployment at P ranks
    does."""

    n_parts: int = 4
    n_epochs: int = 30
    steps_per_epoch: int = 128
    # injected-overlay pool (queue_sim.SCENARIO_CODES values)
    scenario_pool: tuple = dataclasses.field(
        default_factory=qs.default_training_pool)
    # emergent-archetype pool (CLUSTER_CODES values), sampled independently
    cluster_pool: tuple = dataclasses.field(
        default_factory=default_cluster_pool)
    # live-peer counts sampled per episode; None = half the mass on the
    # full fleet, the rest spread over 0 .. P - 2
    peer_pool: tuple | None = None
    # the scripted peers' cache policy: "static" (W = 16), "greendygnn"
    # (the window shrinks with observed sigma) or "mixed" (a coin an
    # episode)
    peer_policy: str = "mixed"
    slack_steps: float = 4.0
    # the per-step gradient sync: payload and ring schedule
    grad_bytes: float = 12480.0
    sync: str = "allreduce"
    # the tiered-store pressure twin (queue_sim's semantics)
    mem_budget_frac: float = 0.0
    observe_headroom: bool = False

    def __post_init__(self):
        if self.n_parts < 2:
            raise ValueError("cluster env needs n_parts >= 2")
        if self.sync not in SYNC_MODES:
            raise ValueError(
                f"unknown sync mode {self.sync!r}; expected {SYNC_MODES}"
            )
        if self.peer_policy not in PEER_POLICIES:
            raise ValueError(
                f"unknown peer policy {self.peer_policy!r}; "
                f"expected {PEER_POLICIES}"
            )

    @property
    def n_owners(self) -> int:
        return self.n_parts - 1

    @property
    def total_steps(self) -> int:
        return self.n_epochs * self.steps_per_epoch

    # greenlint: host-fn — config-time helper, never traced
    def resolved_peer_pool(self) -> tuple[int, ...]:
        if self.peer_pool is not None:
            return tuple(int(p) for p in self.peer_pool)
        # the deployed configuration (the full fleet) takes ~half the mass
        full = self.n_owners
        return (full,) * max(full, 1) + tuple(range(full))


# ------------------------------------------------------------ scenario
@dataclasses.dataclass(frozen=True)
class ClusterScenario:
    """One episode's cluster recipe per env: the injected overlay and the
    emergent factors. Fields (n,), the per-owner ones (n, P)."""

    base: qs.QueueScenario       # the injected overlay (the queue env's)
    cluster_kind: torch.Tensor   # int64, CLUSTER_CODES value
    n_peers: torch.Tensor        # int64 live scripted peers (<= P)
    link_scale: torch.Tensor     # (n, P) ego-slot NIC rate multiplier
    own_scale: torch.Tensor      # the ego partition's NIC rate multiplier
                                 # (peers fetch from it; the ego never does)
    demand_skew: torch.Tensor    # (n, P) per-owner demand multiplier
    ego_compute: torch.Tensor    # the ego's t_base multiplier
    peer_compute: torch.Tensor   # (n, P) each peer's t_base multiplier
    peer_reactive: torch.Tensor  # 1.0 = the peers run the reactive policy


@dataclasses.dataclass(frozen=True)
class ClusterFactorDraws:
    """The cluster's draws of one reset, (n,) each: the pool picks, the
    reactive coin, and each archetype's integers and unit uniforms (every
    archetype draws whatever the env's code, as the reference's
    ``lax.switch`` under ``vmap`` does)."""

    kind_idx: torch.Tensor      # int64 index into cfg.cluster_pool
    peers_idx: torch.Tensor     # int64 index into the resolved peer pool
    react: torch.Tensor         # unit; < 0.5 = reactive peers ("mixed")
    victim: torch.Tensor        # int64 hot NIC in [0, n_parts)
    rate: torch.Tensor          # -> [0.25, 0.6)
    rank: torch.Tensor          # int64 straggler in [0, n_parts)
    factor: torch.Tensor        # -> [1.25, 2)
    hot: torch.Tensor           # int64 hot owner in [0, P)
    frac: torch.Tensor          # -> [0.35, 0.65)


class ClusterDraws(qs.Draws):
    """The cluster env's draws: the queue env's from ``generator``, in the
    order the queue env asks for them, and the cluster's from a second
    generator on the same device, seeded from the first's seed without a
    draw from it."""

    def __init__(self, generator: torch.Generator):
        super().__init__(generator)
        self.cluster_generator = torch.Generator(
            device=generator.device).manual_seed(
            (generator.initial_seed() * 0x9E3779B1 + _CLUSTER_SEED_SALT)
            % 2**63)

    def cluster(self, cfg, n: int) -> ClusterFactorDraws:
        g, dev = self.cluster_generator, self.cluster_generator.device

        def ints(hi):
            return torch.randint(0, hi, (n,), generator=g, device=dev)

        def unit():
            return torch.rand(n, generator=g, device=dev)

        kind_idx = ints(len(cfg.cluster_pool))
        peers_idx = ints(len(cfg.resolved_peer_pool()))
        react = unit()
        victim, rate = ints(cfg.n_parts), unit()
        rank, factor = ints(cfg.n_parts), unit()
        hot, frac = ints(cfg.n_owners), unit()
        return ClusterFactorDraws(
            kind_idx=kind_idx, peers_idx=peers_idx, react=react,
            victim=victim, rate=rate, rank=rank, factor=factor, hot=hot,
            frac=frac)


def sample_cluster_factors(c: ClusterFactorDraws, code: torch.Tensor,
                           cfg: ClusterEnvConfig) -> dict:
    """Domain-randomize one emergent archetype per env of ``code`` (n,):
    severities bracket the eval sweep's defaults (hot_owner rate 0.35,
    slow_worker factor 1.5, demand bias ~50%). Each field is selected by
    code over the four archetypes."""
    n_owners = cfg.n_owners
    n = code.shape[0]
    dev = code.device
    idx = torch.arange(n_owners, device=dev)[None, :]
    ones = torch.ones((n, n_owners), device=dev)
    one = torch.ones(n, device=dev)

    # hot_owner: any of the n_parts NICs, the ego's own partition included
    # (then only the peers feel it directly)
    rate = dr.uniform_from_unit(c.rate, 0.25, 0.6)
    hot_link = torch.where(idx == (c.victim - 1)[:, None], rate[:, None],
                           1.0)
    hot_link = torch.where((c.victim == 0)[:, None], ones, hot_link)
    hot_own = torch.where(c.victim == 0, rate, 1.0)
    # slow_worker: one straggler rank, possibly the ego
    factor = dr.uniform_from_unit(c.factor, 1.25, 2.0)
    slow_ego = torch.where(c.rank == 0, factor, 1.0)
    slow_peer = torch.where(idx == (c.rank - 1)[:, None], factor[:, None],
                            1.0)
    # demand_skew: one partition owns a large share of the hot nodes; a
    # single owner cannot be skewed against
    if n_owners == 1:
        skew = ones
    else:
        frac = dr.uniform_from_unit(c.frac, 0.35, 0.65)
        skew_hot = frac * n_owners
        skew_rest = (1.0 - frac) * n_owners / (n_owners - 1)
        skew = torch.where(idx == c.hot[:, None], skew_hot[:, None],
                           skew_rest[:, None])

    def pick(k, value, other):
        mask = code == CLUSTER_CODES[k]
        if value.dim() == 2:
            mask = mask[:, None]
        return torch.where(mask, value, other)

    return dict(
        link_scale=pick("hot_owner", hot_link, ones),
        own_scale=pick("hot_owner", hot_own, one),
        demand_skew=pick("demand_skew", skew, ones),
        ego_compute=pick("slow_worker", slow_ego, one),
        peer_compute=pick("slow_worker", slow_peer, ones),
    )


def sample_scenario(u: qs.ScenarioDraws, profile: dr.CongestionProfile,
                    c: ClusterFactorDraws, cfg: ClusterEnvConfig
                    ) -> ClusterScenario:
    """One episode's full recipe per env: the injected overlay from the
    queue env's draws ``u`` and ``profile`` exactly as the queue env's
    reset makes it, and the cluster factors from ``c``."""
    dev = u.pool_idx.device
    pool = constant(tuple(cfg.scenario_pool), dev, torch.int64)
    base = qs.sample_scenario(u, profile, pool[u.pool_idx], cfg.total_steps,
                              cfg.n_owners)
    ckind = constant(tuple(cfg.cluster_pool), dev,
                     torch.int64)[c.kind_idx]
    n_peers = constant(cfg.resolved_peer_pool(), dev,
                       torch.int64)[c.peers_idx]
    if cfg.peer_policy == "static":
        reactive = torch.zeros_like(c.react)
    elif cfg.peer_policy == "greendygnn":
        reactive = torch.ones_like(c.react)
    else:
        reactive = (c.react < 0.5).float()
    return ClusterScenario(
        base=base, cluster_kind=ckind, n_peers=n_peers,
        peer_reactive=reactive, **sample_cluster_factors(c, ckind, cfg))


# --------------------------------------------------------------- state
@dataclasses.dataclass(frozen=True)
class EnvState:
    scenario: ClusterScenario
    params: cm.CostModelParams      # per-env calibrated parameters, (n,)
    step_pos: torch.Tensor          # (n,) float32 global step index
    prev_window: torch.Tensor       # (n,)
    prev_weights: torch.Tensor      # (n, P)
    obs: torch.Tensor               # (n, state_dim)
    done: torch.Tensor              # (n,) bool
    total_energy: torch.Tensor      # (n,)
    total_time: torch.Tensor        # (n,)
    # the fluid fabric's state (the queue env's, and the peers')
    util_state: torch.Tensor        # (n, P)
    delta_level: torch.Tensor       # (n, P)
    backlog: torch.Tensor           # (n, P) ego queued miss work [s]
    rb_backlog: torch.Tensor        # (n, P) ego queued rebuild work [s]
    shared_backlog: torch.Tensor    # (n,) ego ingress queued work
    peer_backlog: torch.Tensor      # (n, P) peer work queued at the
                                    # ego-visible NICs (served first)
    peer_left: torch.Tensor         # (n,) steps to the peers' next rebuild
    peer_window: torch.Tensor       # (n,) the peers' current window


# ------------------------------------------------------------ dynamics
def ring_collective_t(cfg: ClusterEnvConfig, params, n_live: torch.Tensor):
    """The ring collective's float32 twin at 1 + ``n_live`` ranks (n,):
    (wall, cpu) seconds, in the reference's operation order. With no live
    peer the ring has no phase and both are exactly 0."""
    if cfg.sync == "none":
        z = torch.zeros_like(n_live)
        return z, z
    n_active = 1.0 + n_live
    scatter = cfg.sync == "reduce_scatter"
    phases = (n_active - 1.0) * (1.0 if scatter else 2.0)
    chunk = torch.full_like(n_active, cfg.grad_bytes) / torch.clamp(
        n_active, min=1.0)
    per_phase = params.alpha_rpc + params.beta * chunk
    wall = phases * per_phase
    cpu = phases * (per_phase + params.beta * chunk)
    return wall, cpu


def peer_operands(cfg: ClusterEnvConfig, params, sc: ClusterScenario
                  ) -> cw.Peers:
    """A window's fixed peer terms (the live mask, the collective, each
    peer's compute-scaled ``t_base`` and slack), computed once an env
    before the launch."""
    n_owners = cfg.n_owners
    peer_on = (torch.arange(n_owners, device=sc.n_peers.device)[None, :]
               < sc.n_peers[:, None]).float()
    n_live = peer_on.sum(-1)
    coll_wall, coll_cpu = ring_collective_t(cfg, params, n_live)
    return cw.Peers(
        link_scale=sc.link_scale, demand_skew=sc.demand_skew,
        peer_on=peer_on, t_peer=params.t_base[:, None] * sc.peer_compute,
        peer_slack=(cfg.slack_steps * params.t_base)[:, None]
        * sc.peer_compute,
        n_live=n_live, own_scale=sc.own_scale, reactive=sc.peer_reactive,
        coll_wall=coll_wall, coll_cpu=coll_cpu)


def _window_dynamics(cfg, params, sc: ClusterScenario, uniforms, window,
                     weights, step_pos, util_state, delta_level, backlog,
                     rb_backlog, shared_backlog, peer_backlog, peer_left,
                     peer_window, eff_window=None) -> dict:
    """Run ``window`` (n,) ego training steps per env through the shared
    fluid fabric, on the window's unit uniforms (n, MAX_WINDOW, 3, P).

    The queue env's window (same draws, same operations on the ego's path)
    with the cluster's terms: the peers' arrivals at the shared NICs, the
    per-step barrier and ring collective, and the heterogeneity factors.
    The loop is one launch of the ``cluster_window`` kernel on the
    card."""
    if eff_window is None:
        eff_window = window
    # the ego's compute-scaled t_base prices its steps; the peers' own
    # t_base is folded into peer_operands
    ego = dataclasses.replace(params, t_base=params.t_base * sc.ego_compute)
    h_o, vol, fabric = qs.window_operands(
        cfg, ego, window, weights, util_state, delta_level, backlog,
        rb_backlog, shared_backlog, demand=sc.demand_skew)
    acc, fabric, peer_state = cw.cluster_window(
        cfg, ego, sc.base, vol, fabric, peer_operands(cfg, params, sc),
        cw.PeerState(peer_backlog, peer_left, peer_window), uniforms,
        window, eff_window, step_pos)
    out = qs.summarize_window(params, acc, cfg.n_owners)
    out.update({
        "h_o": h_o,
        "util_state": fabric.util_state,
        "delta_level": fabric.delta_level,
        "backlog": fabric.backlog,
        "rb_backlog": fabric.rb_backlog,
        "shared_backlog": fabric.shared_backlog,
        "peer_backlog": peer_state.peer_backlog,
        "peer_left": peer_state.peer_left,
        "peer_window": peer_state.peer_window,
    })
    return out


def reset(cfg: ClusterEnvConfig, draws: ClusterDraws,
          params: cm.CostModelParams) -> EnvState:
    """Fresh episodes, one per entry of ``params`` (fields of shape (n,)):
    a scenario and cluster factors, and a probe window at the reference
    action that observes the t = 0 conditions without advancing the
    episode."""
    n = params.t_base.shape[0]
    dev = params.t_base.device
    u = draws.scenario(cfg, n)
    profile = draws.profile(cfg, n)
    scenario = sample_scenario(u, profile, draws.cluster(cfg, n), cfg)
    weights = torch.full((n, cfg.n_owners), 1.0 / cfg.n_owners, device=dev)
    window = torch.full((n,), REFERENCE_WINDOW, device=dev)
    zero = torch.zeros(n, device=dev)
    zeros = torch.zeros((n, cfg.n_owners), device=dev)
    dyn = _window_dynamics(cfg, params, scenario, draws.window(cfg, n),
                           window, weights, zero, zeros, zeros, zeros, zeros,
                           zero, zeros, zero, window)
    obs = qs._observe(cfg, params, draws.noise(cfg, n), dyn, window, weights,
                      zero)
    return EnvState(
        scenario=scenario, params=params, step_pos=zero, prev_window=window,
        prev_weights=weights, obs=obs,
        done=torch.zeros(n, dtype=torch.bool, device=dev),
        total_energy=zero, total_time=zero,
        util_state=zeros, delta_level=zeros, backlog=zeros,
        rb_backlog=zeros, shared_backlog=zero,
        peer_backlog=zeros, peer_left=zero, peer_window=window,
    )


def step(cfg: ClusterEnvConfig, state: EnvState, action: torch.Tensor,
         draws: ClusterDraws):
    """One MDP decision per env: decode the actions (n,), run W ego steps
    through the shared fabric (the peers riding along), emit (state', obs,
    reward, done)."""
    window, weights = ctl.decode_action_t(action, cfg.n_owners)
    n = window.shape[0]
    w_eff = torch.minimum(window, cfg.total_steps - state.step_pos)
    dyn = _window_dynamics(
        cfg, state.params, state.scenario, draws.window(cfg, n), window,
        weights, state.step_pos, state.util_state, state.delta_level,
        state.backlog, state.rb_backlog, state.shared_backlog,
        state.peer_backlog, state.peer_left, state.peer_window,
        eff_window=w_eff,
    )
    obs = qs._observe(cfg, state.params, draws.noise(cfg, n), dyn, window,
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
        peer_backlog=dyn["peer_backlog"], peer_left=dyn["peer_left"],
        peer_window=dyn["peer_window"],
    )
    return new_state, obs, reward, done


def rollout_policy(cfg: ClusterEnvConfig, draws: ClusterDraws, params,
                   policy_fn, max_decisions: int = 1024) -> dict:
    """Roll one episode per entry of ``params`` with ``policy_fn(obs) ->
    actions``, as ``queue_sim.rollout_policy`` does. Pass
    ``max_decisions=cfg.total_steps`` to run every episode to its end."""
    from repro_torch.envs import cluster_sim

    return sim.rollout_policy(cfg, draws, params, policy_fn, max_decisions,
                              env=cluster_sim)


# the env protocol's draws class (``dqn.train_dqn`` builds ``env.Draws``)
Draws = ClusterDraws
