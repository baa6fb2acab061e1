"""The port's cluster env (``envs/cluster_sim.py``) and its window kernel's
wrapper, against the JAX reference, on the CPU.

The env takes its draws through a seam (``cluster_sim.ClusterDraws``):
the queue env's draws and the cluster's. ``ReferenceClusterDraws``
replays the reference's: the queue env's key splits
(``test_torch_queue_sim.ReferenceQueueDraws``), and the cluster factors
the reference folds off ``k_pool`` (``fold_in(k_pool, 0xC1)`` split into
k_kind, k_peers, k_factors, k_react, and k_factors six ways). On the CPU
the window runs the kernel's plain version.

Tolerances are the queue env's: ``sample_scenario``'s integers equal and
its floats within rtol 1e-6; windows, steps and whole episodes within
rtol 1e-5 / atol 1e-6 (torch's sin, exp, sqrt and pow may differ from
XLA's in the last bit, and sums over owners may run in another order).
Within the port, the zero-peer clean configuration equals the queue env
bit for bit (``torch.equal``; a finished episode's 0 / 0 is NaN on both
sides), over the whole scenario pool.
"""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as rctl
from repro.core import cost_model as rcm
from repro.envs import cluster_sim as rcs
from repro.train import policy as rpol
from repro_torch.core import controller as pctl
from repro_torch.core import cost_model as pcm
from repro_torch.core import dqn as pdqn
from repro_torch.core import queue_sim as pqs
from repro_torch.envs import cluster_sim as pcs
from repro_torch.envs import resolve_env
from repro_torch.kernels import _build
from repro_torch.kernels.cluster_window import ops as cw
from repro_torch.kernels.queue_window import ops as qw
from repro_torch.train import policy as ppol
from test_torch_queue_sim import (
    ReferenceQueueDraws, _assert_tree_close, _keys, _np, _pool, _randint,
    _split, _t, _unit, _window_uniforms,
)
from _jax_release import release_jax_executables  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
TOL_SAMPLE = dict(rtol=1e-6, atol=0.0)
PARAMS32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                        rcm.CostModelParams())
KINDS = sorted(rcs.CLUSTER_CODES.values())
A16 = rctl.encode_action(4, 0, 3)       # W = 16, uniform


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The env's eager steps are tiny ops: one thread runs them faster
    than a pool woken for each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    """The same ClusterEnvConfig in both packages."""
    return rcs.ClusterEnvConfig(**kw), pcs.ClusterEnvConfig(**kw)


# ------------------------------------------------------------ draws seam
@functools.partial(jax.jit, static_argnums=1)
def _fold(keys, data):
    return jax.vmap(lambda k: jax.random.fold_in(k, data))(keys)


class ReferenceClusterDraws(ReferenceQueueDraws):
    """The reference's draws: the queue env's, and the cluster factors it
    folds off each reset's k_pool."""

    def scenario(self, cfg, n):
        self._k_pool = _split(self.keys, 5)[:, 0]
        return super().scenario(cfg, n)

    def cluster(self, cfg, n):
        kc = _split(_fold(self._k_pool, 0xC1), 4)
        k_kind, k_peers, k_factors, k_react = (kc[:, i] for i in range(4))
        ks = _split(k_factors, 6)
        return pcs.ClusterFactorDraws(
            kind_idx=_randint(k_kind, len(cfg.cluster_pool)),
            peers_idx=_randint(k_peers, len(cfg.resolved_peer_pool())),
            react=_unit(k_react), victim=_randint(ks[:, 0], cfg.n_parts),
            rate=_unit(ks[:, 1]), rank=_randint(ks[:, 2], cfg.n_parts),
            factor=_unit(ks[:, 3]), hot=_randint(ks[:, 4], cfg.n_owners),
            frac=_unit(ks[:, 5]))


@functools.lru_cache(maxsize=None)
def _ref_sampler(cfg):
    return jax.jit(jax.vmap(lambda k: rcs.sample_scenario(
        *jax.random.split(k, 5)[:2], cfg)))


# --------------------------------------------------- codes, pools, config
def test_codes_pools_and_config_equal_reference():
    assert pcs.CLUSTER_CODES == rcs.CLUSTER_CODES
    assert pcs.N_CLUSTER == rcs.N_CLUSTER
    assert pcs.SYNC_MODES == rcs.SYNC_MODES
    assert pcs.PEER_POLICIES == rcs.PEER_POLICIES
    assert pcs.default_cluster_pool() == rcs.default_cluster_pool()
    for name in (*rcs.CLUSTER_CODES, "hot_owner:0.35", "slow_worker:2"):
        assert pcs.cluster_code_for(name) == rcs.cluster_code_for(name)
    for mod in (pcs, rcs):
        with pytest.raises(KeyError):
            mod.cluster_code_for("bursty_markov")   # an overlay
    for kw in (dict(n_parts=2), dict(n_parts=4), dict(n_parts=8),
               dict(n_parts=4, peer_pool=(0, 3)), dict(n_parts=2,
                                                        peer_pool=(1,))):
        r, p = _cfgs(**kw)
        assert p.resolved_peer_pool() == r.resolved_peer_pool()
        assert (p.n_owners, p.total_steps) == (r.n_owners, r.total_steps)
        assert p.scenario_pool == r.scenario_pool
        assert p.cluster_pool == r.cluster_pool
    for f in dataclasses.fields(rcs.ClusterEnvConfig):
        assert getattr(pcs.ClusterEnvConfig(), f.name) \
            == getattr(rcs.ClusterEnvConfig(), f.name), f.name


@pytest.mark.parametrize("kw", [dict(n_parts=1), dict(sync="ring"),
                                dict(peer_policy="greedy")],
                         ids=["n_parts", "sync", "peer_policy"])
def test_config_refuses_what_the_reference_refuses(kw):
    for mod in (rcs, pcs):
        with pytest.raises(ValueError):
            mod.ClusterEnvConfig(**kw)


# ------------------------------------------------------------ scenarios
@pytest.mark.parametrize("n_parts,policy", [(4, "mixed"), (4, "static"),
                                            (2, "greendygnn"), (2, "mixed")])
@pytest.mark.parametrize("kind", KINDS)
def test_sample_scenario_matches_reference(kind, n_parts, policy):
    """Every field of 16 scenarios of archetype ``kind`` (at P = 2 the
    demand skew is clean), every peer count, drawn from the reference's
    keys: integers equal, floats within rtol 1e-6."""
    rcfg, pcfg = _cfgs(n_parts=n_parts, n_epochs=30, steps_per_epoch=32,
                       cluster_pool=(kind,), peer_policy=policy)
    keys = _keys(100 + kind, 16)
    want = _ref_sampler(rcfg)(keys)
    draws = ReferenceClusterDraws(keys)
    u = draws.scenario(pcfg, 16)
    got = pcs.sample_scenario(u, draws.profile(pcfg, 16),
                              draws.cluster(pcfg, 16), pcfg)
    _assert_tree_close(got, want, TOL_SAMPLE)
    assert set(_np(got.n_peers).tolist()) <= set(
        pcfg.resolved_peer_pool())
    if kind != rcs.CLUSTER_CODES["clean"] and n_parts > 2:
        # the archetype moved its field off the clean value somewhere
        moved = (_np(got.link_scale) != 1).any() \
            or (_np(got.demand_skew) != 1).any() \
            or (_np(got.ego_compute) != 1).any() \
            or (_np(got.peer_compute) != 1).any() \
            or (_np(got.own_scale) != 1).any()
        assert moved


def test_cluster_draws_leave_the_queue_stream():
    """The cluster's draws come from a second generator: the queue env's
    draws of a ClusterDraws equal a queue Draws' of the same seed, with
    cluster draws between them."""
    cfg = pcs.ClusterEnvConfig(n_epochs=2, steps_per_epoch=16)
    a = pcs.ClusterDraws(torch.Generator().manual_seed(5))
    b = pqs.Draws(torch.Generator().manual_seed(5))
    ua, ub = a.scenario(cfg, 8), b.scenario(cfg, 8)
    c1 = a.cluster(cfg, 8)
    assert all(torch.equal(getattr(ua, f.name), getattr(ub, f.name))
               for f in dataclasses.fields(ua))
    assert torch.equal(a.window(cfg, 8), b.window(cfg, 8))
    c2 = a.cluster(cfg, 8)
    assert all(torch.equal(x, y) for x, y in zip(a.noise(cfg, 8),
                                                  b.noise(cfg, 8)))
    assert not torch.equal(c1.rate, c2.rate)
    # the second generator follows the first's seed
    again = pcs.ClusterDraws(torch.Generator().manual_seed(5))
    assert torch.equal(again.cluster(cfg, 8).rate, c1.rate)


# ------------------------------------------------------------- windows
@functools.lru_cache(maxsize=None)
def _ref_window(cfg):
    return jax.jit(jax.vmap(
        lambda sc, k, w, wt, pos, us, dl, bl, rb, sh, pb, pl, pw, eff:
        rcs._window_dynamics(cfg, PARAMS32, sc, k, w, wt, pos, us, dl, bl,
                             rb, sh, pb, pl, pw, eff_window=eff)))


def _to_reference(x, like):
    """A port dataclass of tensors as the reference's class ``like`` of
    jnp arrays (integers as int32, as the reference keeps them)."""
    if dataclasses.is_dataclass(x):
        return type(like)(**{
            f.name: _to_reference(getattr(x, f.name), getattr(like, f.name))
            for f in dataclasses.fields(x)})
    a = _np(x)
    return jnp.asarray(a, jnp.int32 if np.issubdtype(a.dtype, np.integer)
                       else jnp.float32)


def _window_case(kind, window, policy, sync, seed, n_parts=4, mem=0.0,
                 peers=(0, 1, 3)):
    """A batch of windows of archetype ``kind``: 4 envs for each live-peer
    count, carried fabric and peer states (some peers at their boundary),
    step positions across the run, eff_window cut for some envs. The
    scenarios are the port's (``sample_scenario`` is held above), handed
    to the reference as its own."""
    peers = tuple(p for p in peers if p < n_parts)
    kw = dict(n_parts=n_parts, n_epochs=30, steps_per_epoch=32,
              mem_budget_frac=mem, sync=sync)
    rcfg, pcfg = _cfgs(**kw)
    pcfg = dataclasses.replace(pcfg, peer_policy=policy,
                               cluster_pool=(kind,), peer_pool=peers)
    n_owners = n_parts - 1
    n = 4 * len(peers)
    keys = _keys(seed, n)
    draws = ReferenceClusterDraws(keys)
    u = draws.scenario(pcfg, n)
    c = dataclasses.replace(draws.cluster(pcfg, n), peers_idx=torch.arange(
        len(peers)).repeat_interleave(4))
    psc = pcs.sample_scenario(u, draws.profile(pcfg, n), c, pcfg)
    assert _np(psc.n_peers).tolist() == [p for p in peers for _ in range(4)]
    sc = _to_reference(psc, _ref_sampler(rcfg)(keys[:1]))
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.random(s).astype(np.float32)  # noqa: E731
    weights = np.stack([np.asarray(rctl.allocation_weights(
        int(a), n_owners)) for a in rng.integers(0, n_owners + 1, n)])
    eff = np.full(n, window, np.float32)
    eff[1::4] = 0.0
    eff[2::4] = np.ceil(window / 2)
    inputs = dict(
        w=np.full(n, window, np.float32), wt=weights,
        pos=np.floor(f(n) * (rcfg.total_steps - 1)).astype(np.float32),
        us=(f(n, n_owners) < 0.5).astype(np.float32), dl=40 * f(n, n_owners),
        bl=0.05 * f(n, n_owners), rb=0.05 * f(n, n_owners), sh=0.05 * f(n),
        pb=0.05 * f(n, n_owners),
        pl=rng.integers(-1, 20, n).astype(np.float32),
        pw=rng.integers(4, 33, n).astype(np.float32), eff=eff)
    dyn_keys = jax.vmap(lambda k: jax.random.split(k, 5)[2])(keys)
    want = _ref_window(rcfg)(sc, dyn_keys, *(jnp.asarray(v) for v in
                                             inputs.values()))
    t = {k: torch.as_tensor(v) for k, v in inputs.items()}
    got = pcs._window_dynamics(
        pcfg, _pool(n), psc,
        _t(_window_uniforms(dyn_keys, n_owners)), t["w"], t["wt"], t["pos"],
        t["us"], t["dl"], t["bl"], t["rb"], t["sh"], t["pb"], t["pl"],
        t["pw"], eff_window=t["eff"])
    return got, want


def _assert_window_close(got, want):
    for k, v in got.items():
        np.testing.assert_allclose(_np(v), np.asarray(want[k]), err_msg=k,
                                   **TOL)


WINDOW_CASES = [(1, "static", "allreduce"), (16, "greendygnn",
                                             "reduce_scatter"),
                (128, "mixed", "none"), (4, "greendygnn", "allreduce")]


@pytest.mark.parametrize("window,policy,sync", WINDOW_CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_window_dynamics_matches_reference(kind, window, policy, sync):
    """Twelve envs of archetype ``kind`` (0, 1 and 3 live peers), every
    output of the window: accounting, estimator inputs, fabric and peer
    state. The sync mode and the peer policy vary with the case."""
    got, want = _window_case(kind, window, policy, sync,
                             seed=1000 * kind + window)
    _assert_window_close(got, want)


@pytest.mark.parametrize("window", (2, 32))
@pytest.mark.parametrize("kind", KINDS)
def test_window_dynamics_under_memory_pressure(kind, window):
    """``mem_budget_frac`` 0.3: the spill multiplies both actions' wire
    work, on top of the peers' arrivals."""
    got, want = _window_case(kind, window, "mixed", "allreduce",
                             seed=77 + kind, mem=0.3)
    _assert_window_close(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_window_dynamics_at_two_ranks(kind):
    """P = 2: one owner, at most one live peer (which owns it)."""
    got, want = _window_case(kind, 16, "greendygnn", "allreduce",
                             seed=55 + kind, n_parts=2)
    _assert_window_close(got, want)


# -------------------------------------------------------- reset and step
@pytest.mark.parametrize("mem,headroom", [(0.0, False), (0.3, True)])
def test_reset_and_steps_match_reference(mem, headroom):
    """Reset and 8 steps of 28 envs over every queue code's pool and the
    default cluster pools (archetypes, peer counts, mixed peers), seeded
    actions, 4 epochs of 16 steps: obs, reward, done, totals, fabric and
    peer state."""
    pool = tuple(sorted(pqs.SCENARIO_CODES.values()))
    rcfg, pcfg = _cfgs(n_parts=4, n_epochs=4, steps_per_epoch=16,
                       scenario_pool=pool, mem_budget_frac=mem,
                       observe_headroom=headroom)
    n = 28
    keys = _keys(31, n)
    r_reset = jax.jit(jax.vmap(lambda k: rcs.reset(rcfg, k, PARAMS32)))
    r_step = jax.jit(jax.vmap(lambda s, a: rcs.step(rcfg, s, a)))
    draws = ReferenceClusterDraws(keys)
    ref = r_reset(keys)
    port = pcs.reset(pcfg, draws, _pool(n))
    assert port.obs.shape == (n, pctl.state_dim(3, headroom=headroom))
    assert len(set(_np(port.scenario.cluster_kind).tolist())) == 4
    assert len(set(_np(port.scenario.n_peers).tolist())) >= 3

    def fields(r, p):
        _assert_tree_close(p.scenario, r.scenario, TOL)
        for k in ("step_pos", "prev_window", "prev_weights", "obs", "done",
                  "total_energy", "total_time", "util_state", "delta_level",
                  "backlog", "rb_backlog", "shared_backlog", "peer_backlog",
                  "peer_left", "peer_window"):
            _assert_tree_close(getattr(p, k), getattr(r, k), TOL, k)

    fields(ref, port)
    rng = np.random.default_rng(8)
    n_done = 0
    for _ in range(8):
        actions = rng.integers(0, rctl.n_actions(3), n)
        ref, r_obs, r_rew, r_done = r_step(ref, jnp.asarray(actions))
        port, p_obs, p_rew, p_done = pcs.step(
            pcfg, port, torch.as_tensor(actions), draws)
        np.testing.assert_allclose(_np(p_obs), np.asarray(r_obs), **TOL)
        np.testing.assert_allclose(_np(p_rew), np.asarray(r_rew), **TOL)
        np.testing.assert_array_equal(_np(p_done), np.asarray(r_done))
        fields(ref, port)
        n_done += int(np.asarray(r_done).sum())
    assert n_done > 0


@pytest.mark.parametrize("window,alloc,code,kind,peers", [
    (2, 2, "bursty_markov", "hot_owner", 3),
    (128, 0, "incast", "slow_worker", 1),
    (4, 1, "trace", "demand_skew", 2)])
def test_static_episode_matches_reference_rollout(window, alloc, code, kind,
                                                  peers):
    """A whole episode (4 epochs of 32 steps) under one static action,
    the reference's draws replayed: energy and time totals, and every
    decision's reward and step position."""
    rcfg, pcfg = _cfgs(n_parts=4, n_epochs=4, steps_per_epoch=32,
                       scenario_pool=(pqs.SCENARIO_CODES[code],),
                       cluster_pool=(rcs.CLUSTER_CODES[kind],),
                       peer_pool=(peers,))
    action = rctl.encode_action(rcm.WINDOW_CHOICES.index(window), alloc, 3)
    key = jax.random.PRNGKey(window + peers)
    want = rcs.rollout_policy(rcfg, key, PARAMS32,
                              lambda obs, k: jnp.asarray(action, jnp.int32),
                              max_decisions=rcfg.total_steps)
    got = pcs.rollout_policy(pcfg, ReferenceClusterDraws(key[None]),
                             _pool(1), lambda obs: torch.full((1,), action),
                             max_decisions=pcfg.total_steps)
    for k in ("total_energy", "total_time"):
        np.testing.assert_allclose(_np(got[k])[0], np.asarray(want[k]),
                                   **TOL)
    active = np.asarray(want["trace"]["active"])
    n_dec = int(active.sum())
    assert int(_np(got["trace"]["active"][:, 0]).sum()) == n_dec
    for k in ("reward", "step_pos"):
        np.testing.assert_allclose(
            _np(got["trace"][k][:n_dec, 0]),
            np.asarray(want["trace"][k])[:n_dec], err_msg=k, **TOL)


# ------------------------------------------------- the reduction, bitwise
def _covering(draws_cls):
    """``draws_cls`` with env e taking entry e % len of the scenario pool,
    so a batch covers the pool."""
    class Covering(draws_cls):
        def scenario(self, cfg, n):
            u = super().scenario(cfg, n)
            return dataclasses.replace(
                u, pool_idx=torch.arange(n) % len(cfg.scenario_pool))
    return Covering


def _same(a, b) -> bool:
    """Bit-equal, a NaN equal to a NaN (a finished episode's 0 / 0)."""
    return torch.equal(a, b) or bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.parametrize("seed", (0, 7, 23))
def test_zero_peers_equal_the_queue_env_bitwise(seed):
    """With ``peer_pool=(0,)`` and ``cluster_pool=(0,)``, reset, every
    step's obs, reward, backlogs and done, and the totals equal the port's
    queue env exactly, over the whole scenario pool (28 envs, two of each
    code), whole episodes of random actions."""
    codes = tuple(sorted(pqs.SCENARIO_CODES.values()))
    ccfg = pcs.ClusterEnvConfig(n_parts=4, steps_per_epoch=32, n_epochs=6,
                                scenario_pool=codes, peer_pool=(0,),
                                cluster_pool=(0,))
    qcfg = pqs.QueueEnvConfig(n_owners=3, steps_per_epoch=32, n_epochs=6,
                              scenario_pool=codes)
    n = 2 * len(codes)
    pool = _pool(n)
    dc = _covering(pcs.ClusterDraws)(torch.Generator().manual_seed(seed))
    dq = _covering(pqs.Draws)(torch.Generator().manual_seed(seed))
    s_c, s_q = pcs.reset(ccfg, dc, pool), pqs.reset(qcfg, dq, pool)
    assert sorted(set(_np(s_c.scenario.base.kind).tolist())) == list(codes)
    assert torch.equal(s_c.obs, s_q.obs)
    g = torch.Generator().manual_seed(seed + 100)
    for _ in range(ccfg.total_steps):
        a = torch.randint(0, pctl.n_actions(3), (n,), generator=g)
        s_c, o_c, r_c, d_c = pcs.step(ccfg, s_c, a, dc)
        s_q, o_q, r_q, d_q = pqs.step(qcfg, s_q, a, dq)
        assert _same(o_c, o_q)
        assert _same(r_c, r_q)
        for k in ("backlog", "rb_backlog", "shared_backlog", "util_state",
                  "delta_level"):
            assert torch.equal(getattr(s_c, k), getattr(s_q, k)), k
        assert torch.equal(d_c, d_q)
        assert not s_c.peer_backlog.any()
        if bool(d_c.all()):
            break
    assert bool(d_c.all())
    assert torch.equal(s_c.total_energy, s_q.total_energy)
    assert torch.equal(s_c.total_time, s_q.total_time)


def _plain_operands(n_owners=3, clean=False, seed=0, mem=0.0):
    """The wrapper's operands, as ``_window_dynamics`` builds them, for 16
    envs (every archetype, 0 to 3 live peers unless ``clean``)."""
    cfg = pcs.ClusterEnvConfig(n_parts=n_owners + 1, n_epochs=4,
                               steps_per_epoch=32, mem_budget_frac=mem,
                               peer_pool=(0,) if clean else None,
                               cluster_pool=(0,) if clean else
                               pcs.default_cluster_pool())
    n = 16
    draws = pcs.ClusterDraws(torch.Generator().manual_seed(seed))
    state = pcs.reset(cfg, draws, _pool(n))
    sc = state.scenario
    window, weights = pctl.decode_action_t(
        torch.arange(n) * 3 % pctl.n_actions(n_owners), n_owners)
    g = torch.Generator().manual_seed(seed + 1)
    pool = _pool(n)
    ego = dataclasses.replace(pool, t_base=pool.t_base * sc.ego_compute)
    _, vol, fabric = pqs.window_operands(
        cfg, ego, window, weights,
        (torch.rand((n, n_owners), generator=g) < 0.5).float(),
        30 * torch.rand((n, n_owners), generator=g),
        0.02 * torch.rand((n, n_owners), generator=g),
        0.02 * torch.rand((n, n_owners), generator=g),
        0.02 * torch.rand(n, generator=g), demand=sc.demand_skew)
    peer_state = cw.PeerState(
        0.0 if clean else 0.02 * torch.rand((n, n_owners), generator=g),
        torch.randint(-1, 6, (n,), generator=g).float(),
        torch.randint(4, 33, (n,), generator=g).float())
    if clean:
        peer_state = dataclasses.replace(
            peer_state, peer_backlog=torch.zeros((n, n_owners)))
    eff = torch.minimum(window, torch.tensor([128.0, 0, 1, 5] * 4))
    return (cfg, ego, sc.base, vol, fabric,
            pcs.peer_operands(cfg, pool, sc), peer_state,
            draws.window(cfg, n), window, eff,
            8 * torch.arange(n, dtype=torch.float32))


@pytest.mark.parametrize("n_owners,mem", [(3, 0.0), (3, 0.3), (1, 0.0)])
def test_plain_window_reduces_to_the_queue_window_bitwise(n_owners, mem):
    """``cluster_window_plain`` at zero peers and clean factors gives
    ``queue_window_plain``'s outputs bit for bit, and leaves no peer
    work."""
    args = _plain_operands(n_owners, clean=True, mem=mem)
    cfg = args[0]
    assert not args[5].n_live.any()
    qcfg = pqs.QueueEnvConfig(n_owners=n_owners, n_epochs=cfg.n_epochs,
                              steps_per_epoch=cfg.steps_per_epoch,
                              mem_budget_frac=mem)
    acc_c, fab_c, ps_c = cw.cluster_window_plain(*args)
    acc_q, fab_q = qw.queue_window_plain(qcfg, *args[1:5], *args[7:])
    for k in acc_q:
        assert torch.equal(acc_c[k], acc_q[k]), k
    for f in dataclasses.fields(fab_q):
        assert torch.equal(getattr(fab_c, f.name), getattr(fab_q, f.name))
    assert not ps_c.peer_backlog.any()


@pytest.mark.parametrize("n_owners", [1, 3, 8])
def test_backlog_free_outputs_ignore_the_carried_backlogs(n_owners):
    """The premise of the kernel's split: on the same operands but other
    carried backlogs (the ego's and the peers'), the plain version's
    backlog-free outputs (the chains, the peers' window, the live steps,
    the active sums) are equal, while the time, energy and backlogs
    differ."""
    args = list(_plain_operands(n_owners, seed=n_owners))
    want = cw.as_dict(*cw.cluster_window_plain(*args))
    fab, ps = args[4], args[6]
    args[4] = dataclasses.replace(
        fab, backlog=fab.backlog + 0.5, rb_backlog=2 * fab.rb_backlog + 0.01,
        shared_backlog=fab.shared_backlog + 0.25)
    args[6] = dataclasses.replace(ps, peer_backlog=ps.peer_backlog + 0.125)
    got = cw.as_dict(*cw.cluster_window_plain(*args))
    for k in ("util_state", "delta_level", "peer_left", "peer_window", "n",
              "active"):
        assert torch.equal(got[k], want[k]), k
    for k in ("t", "e", "backlog"):
        assert not torch.equal(got[k], want[k]), k


# ------------------------------------------------------------ physics
def _episode_energy(cfg, seed=0, action=A16, decisions=16):
    out = pcs.rollout_policy(cfg, pcs.ClusterDraws(
        torch.Generator().manual_seed(seed)), _pool(1),
        lambda obs: torch.full((1,), action), max_decisions=decisions)
    return float(out["total_energy"][0])


def _reduction_cfg(**kw):
    return pcs.ClusterEnvConfig(**dict(dict(
        n_parts=4, steps_per_epoch=32, n_epochs=6, peer_pool=(0,),
        cluster_pool=(pcs.CLUSTER_CODES["clean"],)), **kw))


class TestClusterPhysics:
    """The reference's physics tests, on the port: the terms the queue
    env cannot express move the right way."""

    def test_live_peers_cost_energy(self):
        lone, fleet = _reduction_cfg(), _reduction_cfg(peer_pool=(3,))
        for seed in (0, 3):
            assert _episode_energy(fleet, seed) \
                > _episode_energy(lone, seed) * 1.5

    def test_straggler_peer_drags_the_barrier(self):
        clean = _reduction_cfg(peer_pool=(3,))
        slow = _reduction_cfg(peer_pool=(3,), cluster_pool=(
            pcs.CLUSTER_CODES["slow_worker"],))
        clean_e = np.mean([_episode_energy(clean, s) for s in range(4)])
        slow_e = np.mean([_episode_energy(slow, s) for s in range(4)])
        assert slow_e > clean_e * 1.02

    def test_peer_storms_occupy_the_shared_nics(self):
        fleet = _reduction_cfg(peer_pool=(3,))
        draws = pcs.ClusterDraws(torch.Generator().manual_seed(1))
        st = pcs.reset(fleet, draws, _pool(1))
        assert float(st.peer_backlog.sum()) == 0.0
        st, _, _, _ = pcs.step(fleet, st, torch.full((1,), A16), draws)
        assert float(st.peer_backlog.sum()) > 0
        lone = _reduction_cfg()
        draws = pcs.ClusterDraws(torch.Generator().manual_seed(1))
        st0 = pcs.reset(lone, draws, _pool(1))
        st0, _, _, _ = pcs.step(lone, st0, torch.full((1,), A16), draws)
        assert float(st0.peer_backlog.sum()) == 0.0

    def test_reward_near_minus_one_at_reference_action(self):
        cfg = pcs.ClusterEnvConfig(n_parts=4, steps_per_epoch=32,
                                   n_epochs=6)
        draws = pcs.ClusterDraws(torch.Generator().manual_seed(3))
        envs = pcs.reset(cfg, draws, _pool(32))
        _, _, rewards, _ = pcs.step(cfg, envs, torch.full((32,), A16),
                                    draws)
        r = _np(rewards)
        assert np.all(np.isfinite(r))
        assert -1.3 < r.mean() < -0.7


class TestFabricCrossValidation:
    """The port's fluid twin against the port's ``run_cluster`` (the
    modeled lane, on the CPU) on matched shapes, within the reference's
    25%."""

    @pytest.fixture(scope="class")
    def matched(self):
        from repro_torch.graph.features import ShardedFeatureStore
        from repro_torch.train import gnn_trainer as gt
        from repro_torch.train.cluster import (
            ClusterConfig, build_cluster_traces, default_grad_bytes,
            run_cluster,
        )

        cfg = gt.RunConfig(method="static_w", dataset="reddit",
                           batch_size=600, n_epochs=2, steps_per_epoch=8,
                           scenario="clean", device="cpu")
        bundles = build_cluster_traces(cfg, 4)
        graph, owner, traces, _ = bundles[0]
        store = ShardedFeatureStore(graph.features, owner, 0, 4)
        remote_rows = float(np.mean(
            [len(store.remote_ids_of(t)) for ep in traces for t in ep]))
        params = pcm.CostModelParams().replace(
            feature_bytes=float(store.bytes_per_row),
            remote_nodes=remote_rows)
        clean = run_cluster(cfg, ClusterConfig(n_workers=4),
                            trace_bundles=bundles)
        hot = (0.35, 1.0, 1.0, 1.0)
        hot_rep = run_cluster(
            cfg, ClusterConfig(n_workers=4, link_rate_scale=hot),
            trace_bundles=bundles)
        env_cfg = pcs.ClusterEnvConfig(
            n_parts=4, n_epochs=2, steps_per_epoch=8, scenario_pool=(0,),
            cluster_pool=(0,), peer_pool=(3,),
            grad_bytes=default_grad_bytes(graph))
        pool = ppol.make_params_pool([params], device="cpu")
        return pool, env_cfg, clean, hot_rep

    def test_energy_within_tolerance(self, matched):
        pool, env_cfg, clean, _ = matched
        m0 = clean.results[0].meter
        eval_e = (m0.gpu_j + m0.cpu_j) / m0.n_steps
        eval_t = m0.wall_s / m0.n_steps
        out = pcs.rollout_policy(
            env_cfg, pcs.ClusterDraws(torch.Generator().manual_seed(0)),
            pool, lambda obs: torch.full((1,), A16), max_decisions=4)
        env_e = float(out["total_energy"][0]) / env_cfg.total_steps
        env_t = float(out["total_time"][0]) / env_cfg.total_steps
        assert env_e == pytest.approx(eval_e, rel=0.25)
        assert env_t == pytest.approx(eval_t, rel=0.25)

    def test_latency_inflation_ordering(self, matched):
        pool, env_cfg, clean, hot_rep = matched
        assert hot_rep.total_queue_s > clean.total_queue_s
        hot_env = dataclasses.replace(
            env_cfg, cluster_pool=(pcs.CLUSTER_CODES["hot_owner"],))
        n = 8
        pools = ppol.make_params_pool(
            [pcm.CostModelParams(**{
                f.name: float(getattr(pool, f.name)[0])
                for f in dataclasses.fields(pool)})] * n, device="cpu")

        def max_ratio(cfg):
            draws = pcs.ClusterDraws(torch.Generator().manual_seed(0))
            st = pcs.reset(cfg, draws, pools)
            st, _, _, _ = pcs.step(cfg, st, torch.full((n,), A16), draws)
            w = torch.full((n,), 16.0)
            dyn = pcs._window_dynamics(
                cfg, pools, st.scenario, draws.window(cfg, n), w,
                torch.full((n, 3), 1.0 / 3), st.step_pos, st.util_state,
                st.delta_level, st.backlog, st.rb_backlog,
                st.shared_backlog, st.peer_backlog, st.peer_left,
                st.peer_window)
            return st, dyn["fetch_ratio"].amax(-1)

        st, hot_ratio = max_ratio(hot_env)
        in_slots = st.scenario.link_scale.amin(-1) < 1.0
        assert bool(in_slots.any()), "no hot-slot episodes sampled"
        _, clean_ratio = max_ratio(env_cfg)
        assert float(hot_ratio[in_slots].max()) > float(clean_ratio.max())


# ------------------------------------------------------ wrapper (ops.py)
def test_layout_matches_the_kernel_source():
    """The peers' column names in the order of the header's enums, the
    constants the kernel compiles in, the entry and its flags, and the
    library's hash over the header too."""
    src = (_build.CSRC / "fluid_window.cuh").read_text()

    def enum(name):
        body = re.search(r"enum %s\s*\{([^}]*)\}" % name, src).group(1)
        return [x.strip() for x in body.split(",") if x.strip()]

    for name, cols, prefix in (("PScal", cw.PEER_SCALARS, "PS_"),
                               ("POwn", cw.PEER_OWNERS, "PO_"),
                               ("PState", cw.PEER_STATE, "PT_")):
        names = enum(name)
        assert names[-1].startswith("N_")
        assert [x[len(prefix):].lower() for x in names[:-1]] == list(cols)
    consts = dict(re.findall(r"constexpr \w+ (\w+) = ([^;]+);", src))
    assert float(consts["ACTIVE_ROWS_SCALE"].rstrip("f")) \
        == pqs.ACTIVE_ROWS_SCALE == pcs.ACTIVE_ROWS_SCALE
    assert float(consts["REBUILD_FETCH_FRAC"].rstrip("f")) \
        == pqs.REBUILD_FETCH_FRAC
    assert float(consts["REF_W"].rstrip("f")) == pcs.REFERENCE_WINDOW
    cu = (_build.CSRC / "cluster_window.cu").read_text()
    assert '#include "fluid_window.cuh"' in cu
    assert "window_scan<MAXP, true>" in cu
    assert "window_scan<MAXP, false>" in (
        _build.CSRC / "queue_window.cu").read_text()
    assert [int(x) for x in re.findall(r"launch<(\d+)>\(", cu)] \
        == [1, 2, 3, 4, 8, 16]
    assert cw.MAX_OWNERS == 16
    assert _build.ENTRIES["cluster_window_f32"][0] == "cluster_window"
    assert len(_build.ENTRIES["cluster_window_f32"][1]) == 17
    assert "-fmad=false" in _build._flags("cluster_window")
    assert _build.sources("cluster_window") == [
        _build.CSRC / "cluster_window.cu", _build.CSRC / "fluid_window.cuh"]


def test_library_hash_covers_the_header(tmp_path, monkeypatch):
    """An edited header rebuilds both window libraries; an unrelated
    source's library keeps its path."""
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {s: _build._lib_path(s) for s in ("queue_window",
                                               "cluster_window", "csr_spmm")}
    header = tmp_path / "fluid_window.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: _build._lib_path(s) for s in before}
    assert after["queue_window"] != before["queue_window"]
    assert after["cluster_window"] != before["cluster_window"]
    assert after["csr_spmm"] == before["csr_spmm"]


def test_pack_peers_puts_every_field_in_its_column():
    cfg, ego, sc, vol, fabric, peers, peer_state, *_ = _plain_operands()
    pscal, pown = cw.pack_peers(ego, peers, peer_state)
    assert pscal.is_contiguous() and pown.is_contiguous()
    assert pscal.dtype == pown.dtype == torch.float32
    col = dict(zip(cw.PEER_SCALARS, pscal.unbind(1)))
    for k in ("n_live", "own_scale", "reactive", "coll_wall", "coll_cpu"):
        assert torch.equal(col[k], getattr(peers, k)), k
    for k in ("h_min", "h_max", "w_half", "gamma_h", "rebuild_c",
              "remote_nodes", "beta", "feature_bytes"):
        assert torch.equal(col[k], getattr(ego, k)), k
    assert torch.equal(col["peer_left"], peer_state.peer_left)
    assert torch.equal(col["peer_window"], peer_state.peer_window)
    ocol = dict(zip(cw.PEER_OWNERS, pown.unbind(1)))
    for k in ("link_scale", "demand_skew", "peer_on", "t_peer",
              "peer_slack"):
        assert torch.equal(ocol[k], getattr(peers, k)), k
    assert torch.equal(ocol["peer_backlog"], peer_state.peer_backlog)
    assert peers.n_live.tolist() == peers.peer_on.sum(-1).tolist()
    assert bool((peers.n_live > 0).any())


def test_wrapper_takes_the_plain_version_on_the_cpu():
    args = _plain_operands(seed=2)
    got = cw.as_dict(*cw.cluster_window(*args))
    want = cw.as_dict(*cw.cluster_window_plain(*args))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["n"], args[9])      # live steps = eff_window


def test_masked_steps_change_nothing():
    """The kernel stops at eff_window: every draw past it, replaced, must
    leave every output of the masked loop bit for bit."""
    args = list(_plain_operands(seed=3))
    eff, uniforms = args[9], args[7]
    want = cw.as_dict(*cw.cluster_window_plain(*args))
    past = torch.arange(qw.MAX_WINDOW)[None, :] >= eff[:, None]
    args[7] = torch.where(past[:, :, None, None], 1.0 - uniforms, uniforms)
    got = cw.as_dict(*cw.cluster_window_plain(*args))
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_window_dynamics_is_the_wrapper_between_volumes_and_summary():
    """``_window_dynamics``' outputs from the plain version's on the
    operands it builds (the ego's scaled t_base, the demand skew, the
    peers' terms), and its state the plain version's."""
    cfg = pcs.ClusterEnvConfig(n_parts=4, n_epochs=4, steps_per_epoch=32)
    n = 16
    draws = pcs.ClusterDraws(torch.Generator().manual_seed(4))
    pool = _pool(n)
    st = pcs.reset(cfg, draws, pool)
    window, weights = pctl.decode_action_t(torch.arange(n) * 5 % 32, 3)
    uniforms = draws.window(cfg, n)
    carried = (st.util_state, st.delta_level, st.backlog + 0.01,
               st.rb_backlog, st.shared_backlog, st.peer_backlog + 0.01,
               st.peer_left, st.peer_window)
    dyn = pcs._window_dynamics(cfg, pool, st.scenario, uniforms, window,
                               weights, st.step_pos, *carried)
    sc = st.scenario
    ego = dataclasses.replace(pool, t_base=pool.t_base * sc.ego_compute)
    _, vol, fabric = pqs.window_operands(cfg, ego, window, weights,
                                         *carried[:5],
                                         demand=sc.demand_skew)
    acc, fab, ps = cw.cluster_window_plain(
        cfg, ego, sc.base, vol, fabric, pcs.peer_operands(cfg, pool, sc),
        cw.PeerState(*carried[5:]), uniforms, window, window, st.step_pos)
    for k, v in pqs.summarize_window(pool, acc, 3).items():
        assert torch.equal(dyn[k], v), k
    for k, v in {**dataclasses.asdict(fab), **dataclasses.asdict(ps)}.items():
        assert torch.equal(dyn[k], v), k


def test_ring_collective_twin_matches_the_reference_law():
    """The float32 twin: 0 with no live peer; the reference's phases,
    chunk and per-phase cost otherwise, for each sync mode."""
    pool = _pool(4)
    n_live = torch.tensor([0.0, 1.0, 2.0, 3.0])
    for sync, per in (("allreduce", 2.0), ("reduce_scatter", 1.0)):
        cfg = pcs.ClusterEnvConfig(sync=sync)
        wall, cpu = pcs.ring_collective_t(cfg, pool, n_live)
        assert wall[0] == 0.0 and cpu[0] == 0.0
        n_active = (1.0 + n_live).numpy()
        chunk = np.float32(cfg.grad_bytes) / n_active
        per_phase = np.float32(pool.alpha_rpc[0]) + np.float32(
            pool.beta[0]) * chunk
        np.testing.assert_allclose(_np(wall), (n_active - 1) * per
                                   * per_phase, rtol=1e-6)
        np.testing.assert_allclose(
            _np(cpu), (n_active - 1) * per
            * (per_phase + np.float32(pool.beta[0]) * chunk), rtol=1e-6)
    wall, cpu = pcs.ring_collective_t(pcs.ClusterEnvConfig(sync="none"),
                                      pool, n_live)
    assert not wall.any() and not cpu.any()


def test_wrapper_operand_checks():
    """What every call refuses (dtype, shape, mixed or unsupported
    devices) and what a CUDA launch refuses beyond it (more owners than
    the kernel's register arrays hold, on metadata)."""
    args = list(_plain_operands())
    bad = list(args)
    bad[5] = dataclasses.replace(args[5], coll_wall=args[5].coll_wall.double())
    with pytest.raises(TypeError):
        cw.cluster_window(*bad)
    bad = list(args)
    bad[6] = dataclasses.replace(args[6], peer_backlog=args[6].peer_backlog[:,
                                                                           :2])
    with pytest.raises(ValueError, match="per-owner"):
        cw.cluster_window(*bad)
    bad = list(args)
    bad[6] = dataclasses.replace(args[6], peer_left=args[6].peer_left[:3])
    with pytest.raises(ValueError, match="per-env"):
        cw.cluster_window(*bad)
    bad = list(args)
    bad[5] = dataclasses.replace(args[5], link_scale=args[5].link_scale.to(
        "meta"))
    with pytest.raises(ValueError, match="one device"):
        cw.cluster_window(*bad)
    bad = list(args)
    bad[7] = args[7][:, :64].contiguous()       # the queue window's checks
    with pytest.raises(ValueError):
        cw.cluster_window(*bad)
    cw.check_kernel_operands(torch.empty((4, 128, 3, 16), device="meta"))
    with pytest.raises(ValueError, match="owners"):
        cw.check_kernel_operands(torch.empty((4, 128, 3, 17), device="meta"))


def test_kernel_operand_check_holds_shared_memory(monkeypatch):
    """The cluster block's shared memory (the queue window's and the
    peers' rows) against the card's limit, on metadata: 16 owners fit,
    and a limit below what the block takes is refused."""
    wide = torch.empty((4, 128, 3, 16), device="meta")
    assert cw.smem_bytes(16) == qw.smem_bytes(16) + 4 * (
        len(cw.PEER_SCALARS) + len(cw.PEER_OWNERS) * 16)
    cw.check_kernel_operands(wide)
    monkeypatch.setattr(qw, "MAX_SMEM", cw.smem_bytes(16) - 4)
    with pytest.raises(ValueError, match="cluster_window.*shared memory"):
        cw.check_kernel_operands(wide)
    qw.check_kernel_operands(wide)       # the queue block is smaller


# -------------------------------------------------- training and policy
def test_resolve_env_cluster_is_the_port_module():
    assert resolve_env("cluster") is pcs
    assert ppol.resolve_env("cluster") is pcs
    assert "cluster" in ppol.ENVS
    with pytest.raises(ValueError, match="unknown training env"):
        resolve_env("warp_drive")


def test_trains_with_dqn_protocol():
    """The reference's test: train_dqn runs unchanged on the cluster env
    (4 envs, 30 iterations): finite losses, gradient steps taken."""
    env_cfg = pcs.ClusterEnvConfig(steps_per_epoch=16, n_epochs=2)
    cfg = pdqn.DQNConfig(n_envs=4, iterations=30, min_replay=16,
                         eps_decay_iters=20, seed=0, device="cpu")
    res = pdqn.train_dqn(cfg, env_cfg, _pool(1), env=pcs)
    assert np.all(np.isfinite(_np(res["metrics"]["loss"])))
    assert int(res["grad_steps"]) > 0
    assert res["qnet"]["l1"]["w"].shape[0] == pctl.state_dim(3)


@pytest.mark.parametrize("kw,exc", [
    (dict(env="analytic", scenario_pool=("clean",)), ValueError),
    (dict(env="queue", n_workers=4), ValueError),
    (dict(env="cluster", n_workers=4, n_owners=2), ValueError),
    (dict(env="cluster", scenario_pool=()), ValueError),
    (dict(env="cluster", cluster_kwargs={"sync": "ring"}), ValueError),
    (dict(env="cluster", cluster_kwargs={"peer_policy": "greedy"}),
     ValueError),
    (dict(env="cluster", n_workers=1), ValueError),
    (dict(env="cluster", scenario_pool=("warp_drive",)), KeyError),
], ids=["pool-analytic", "workers-queue", "owners-mismatch", "empty-pool",
        "sync", "peer-policy", "one-rank", "unknown-spec"])
def test_train_policy_refuses_what_the_reference_refuses(kw, exc):
    rpool = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32)[None],
                         rcm.CostModelParams())
    with pytest.raises(exc):
        rpol.train_policy(rpool, iterations=2, **kw)
    with pytest.raises(exc):
        ppol.train_policy(_pool(1), iterations=2, device="cpu", **kw)


def test_get_or_train_policy_writes_the_cluster_artifact(tmp_path,
                                                         monkeypatch):
    """``env="cluster", n_workers=4`` trains at P = 4 and writes
    ``<name>_cluster_p4.npz``; a second call loads it; P = 3 is another
    artifact with its own spaces."""
    monkeypatch.setattr(ppol, "ARTIFACT_DIR", str(tmp_path))
    q_fn, qnet = ppol.get_or_train_policy(
        _pool(1), name="t", iterations=6, env="cluster", n_workers=4,
        device="cpu", n_envs=4, n_epochs=2, steps_per_epoch=16,
        cluster_kwargs={"peer_pool": (3,)}, scenario_pool=("incast",))
    assert (tmp_path / "t_cluster_p4.npz").is_file()
    assert (tmp_path / "t_cluster_p4.json").is_file()
    _, again = ppol.get_or_train_policy(_pool(1), name="t", env="cluster",
                                        n_workers=4, device="cpu")
    assert torch.equal(again["l3"]["w"], qnet["l3"]["w"])
    assert q_fn(np.zeros(pctl.state_dim(3), np.float32)).shape == (32,)
    _, q3 = ppol.get_or_train_policy(
        _pool(1), name="t", iterations=4, env="cluster", n_workers=3,
        device="cpu", n_envs=4, n_epochs=2, steps_per_epoch=16)
    assert (tmp_path / "t_cluster_p3.npz").is_file()
    assert q3["l1"]["w"].shape[0] == pctl.state_dim(2)
