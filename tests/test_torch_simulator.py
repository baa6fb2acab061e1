"""The port's training simulators against the JAX reference's, on the CPU.

JAX's threefry and torch's generators differ, so the port's envs take
their random draws through a seam (``simulator.Draws``); here a
replacement replays the draws the reference makes from the same keys,
splitting them exactly as ``repro/core/simulator.py`` and
``repro/core/table_sim.py`` do. Parameters go to the reference as float32
arrays, as ``train_dqn`` hands each env its pool entry.

Tolerances: the tensor forms and the env steps agree with the reference
and the port's numpy host forms within rtol 1e-5 (atol 1e-6 where values
cross zero): torch's pow and sin may differ from XLA's and numpy's in
the last bit, and torch divides by a number through its reciprocal on
the card. Discrete outputs (the one-hot, ``done``, profiles' integers)
are equal.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as rctl
from repro.core import cost_model as rcm
from repro.core import domain_rand as rdr
from repro.core import policies as rpol
from repro.core import simulator as rsim
from repro.core import table_sim as rtab
from repro_torch.core import controller as pctl
from repro_torch.core import cost_model as pcm
from repro_torch.core import domain_rand as pdr
from repro_torch.core import simulator as psim
from repro_torch.core import table_sim as ptab
from repro_torch.train import policy as ppol
from _jax_release import release_jax_executables  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
ARCHETYPES = range(pdr.N_ARCHETYPES)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


# ------------------------------------------------------------ draws seam
def _profile_to_torch(prof) -> pdr.CongestionProfile:
    ints = ("archetype", "link_a", "link_b")
    return pdr.CongestionProfile(**{
        name: torch.as_tensor(
            np.array(getattr(prof, name)),
            dtype=torch.int64 if name in ints else torch.float32)
        for name in ("archetype", "severity_ms", "onset", "duration",
                     "period", "link_a", "link_b", "phase")
    })


class ReferenceDraws:
    """The draws the reference's ``reset``/``step`` make from one key per
    env: reset splits (k_prof, k_obs, k_next), a step splits (key, k_obs),
    and each observation splits k_obs into (k_sig, k_e, k_h)."""

    def __init__(self, keys):
        self.keys = keys                  # (n, 2) uint32, one per env
        self._reset_obs = None

    def profile(self, cfg, n):
        k = jax.vmap(lambda k: jax.random.split(k, 3))(self.keys)
        self._reset_obs, self.keys = k[:, 1], k[:, 2]
        prof = jax.vmap(lambda kp: rdr.sample_profile(
            kp, cfg.total_steps, cfg.n_owners))(k[:, 0])
        return _profile_to_torch(prof)

    def noise(self, cfg, n):
        if self._reset_obs is not None:
            k_obs, self._reset_obs = self._reset_obs, None
        else:
            k = jax.vmap(jax.random.split)(self.keys)
            self.keys, k_obs = k[:, 0], k[:, 1]

        def one(ko):
            k_sig, k_e, k_h = jax.random.split(ko, 3)
            return (rdr.observation_noise(k_sig, (cfg.n_owners,)),
                    rdr.observation_noise(k_e, ()),
                    rdr.observation_noise(k_h, (cfg.n_owners,)))

        return tuple(torch.as_tensor(np.array(x))
                     for x in jax.vmap(one)(k_obs))


def _f32_tree(params):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), params)


def _port_params(params, n):
    """``n`` copies of one parameter set as the port's per-env pool."""
    return ppol.make_params_pool([params] * n, device="cpu")


# ----------------------------------------------------- domain randomisation
def _ref_profiles(n_owners, seed=0, n=96):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return jax.vmap(lambda k: rdr.sample_profile(k, 3840, n_owners))(keys)


@pytest.mark.parametrize("n_owners", [1, 3, 7])
@pytest.mark.parametrize("archetype", ARCHETYPES)
def test_delta_at_matches_reference(archetype, n_owners):
    """Every archetype at 1, 3 and 7 owners over a grid of steps, on
    profiles the reference drew (their archetype forced)."""
    prof = _ref_profiles(n_owners)
    prof = prof.__class__(**{**prof.__dict__, "archetype": jnp.full_like(
        prof.archetype, archetype)})
    port = _profile_to_torch(prof)
    for step in (0.0, 17.5, 100.0, 512.25, 1337.0, 2999.5, 3839.0):
        want = jax.vmap(lambda p: rdr.delta_at(p, step, n_owners))(prof)
        got = pdr.delta_at(port, step, n_owners)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    steps = np.linspace(0, 3840, 96, dtype=np.float32)
    want = jax.vmap(lambda p, s: rdr.delta_at(p, s, n_owners))(
        prof, jnp.asarray(steps))
    got = pdr.delta_at(port, torch.as_tensor(steps), n_owners)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_owners", [1, 3, 7])
def test_paper_schedule_matches_reference(n_owners):
    epochs = np.arange(31)
    got = pdr.paper_schedule_delta_t(torch.as_tensor(epochs), 30, n_owners)
    want = np.stack([np.asarray(rdr.paper_schedule_delta(e, 30, n_owners))
                     for e in epochs])
    np.testing.assert_array_equal(_np(got), want)
    host = np.stack([pdr.paper_schedule_delta(e, 30, n_owners)
                     for e in epochs])
    np.testing.assert_array_equal(_np(got), host)


@pytest.mark.parametrize("n_owners", [1, 2, 3, 7])
def test_sampler_ranges(n_owners):
    g = torch.Generator().manual_seed(5)
    total = 3840
    p = pdr.sample_profile(g, total, n_owners, n=4096)
    assert set(_np(p.archetype).tolist()) == set(ARCHETYPES)
    assert set(_np(p.severity_ms).tolist()) == set(pdr.SEVERITY_LEVELS_MS)
    for name, lo, hi in (("onset", 0.0, 0.35 * total),
                         ("duration", 0.25 * total, 1.0 * total),
                         ("period", 32.0, 256.0),
                         ("phase", 0.0, 2.0 * math.pi)):
        v = _np(getattr(p, name))
        assert v.min() >= lo and v.max() <= hi, name
    a, b = _np(p.link_a), _np(p.link_b)
    assert a.min() >= 0 and a.max() < n_owners
    assert b.min() >= 0 and b.max() < n_owners
    if n_owners > 1:
        assert (a != b).all()
        assert set(a.tolist()) == set(range(n_owners))
    else:
        assert (a == 0).all() and (b == 0).all()
    noise = pdr.observation_noise(g, (4096,))
    assert float((noise - 1).abs().max()) <= pdr.OBS_NOISE_FRAC + 1e-6


def test_clean_profile_injects_nothing():
    p = pdr.clean_profile(3)
    assert float(pdr.delta_at(p, 100.0).abs().sum()) == 0.0


# -------------------------------------------------------- tensor forms
def _law_inputs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    windows = np.asarray(pcm.WINDOW_CHOICES, np.float32)[
        rng.integers(0, 8, n)]
    sigma = (1 + 5 * rng.random((n, 3))).astype(np.float32)
    weights = np.stack([pctl.allocation_weights(a, 3)
                        for a in rng.integers(0, 4, n)])
    return windows, sigma, weights


def test_cost_laws_tensor_forms_match_host_forms():
    params = pcm.CostModelParams(t_base=0.0123, h_min=0.3, w_half=20.0)
    windows, sigma, weights = _law_inputs()
    n = len(windows)
    pool = _port_params(params, n)
    w_t, s_t, ww_t = map(torch.as_tensor, (windows, sigma, weights))
    delta = (sigma - 1) * 7
    np.testing.assert_allclose(
        _np(pcm.sigma_from_delta_t(pool, torch.as_tensor(delta))),
        pcm.sigma_from_delta(params, delta), **TOL)
    np.testing.assert_allclose(_np(pcm.hit_rate_t(pool, w_t)),
                               pcm.hit_rate(params, windows), **TOL)
    np.testing.assert_allclose(_np(pcm.rebuild_time_t(pool, w_t)),
                               pcm.rebuild_time(params, windows), **TOL)
    np.testing.assert_allclose(_np(pcm.allreduce_penalty_t(pool, s_t)),
                               pcm.allreduce_penalty(params, sigma), **TOL)
    for i in range(n):
        np.testing.assert_allclose(
            _np(pcm.per_owner_hit_rates_t(pool, w_t, ww_t))[i],
            pcm.per_owner_hit_rates(params, windows[i], weights[i]), **TOL)
        for wts, wts_t in ((weights[i], ww_t), (None, None)):
            np.testing.assert_allclose(
                _np(pcm.step_time_t(pool, w_t, s_t, wts_t))[i],
                pcm.step_time(params, windows[i], sigma[i], wts), **TOL)
            np.testing.assert_allclose(
                _np(pcm.step_energy_t(pool, w_t, s_t, wts_t))[i],
                pcm.step_energy(params, windows[i], sigma[i], wts), **TOL)
    np.testing.assert_allclose(
        _np(pcm.step_energy_t(pool, 16.0, s_t)),
        [pcm.step_energy(params, 16.0, s) for s in sigma], **TOL)


@pytest.mark.parametrize("n_owners", [1, 3, 7])
def test_codec_and_state_tensor_forms_match_host_forms(n_owners):
    n_act = pctl.n_actions(n_owners)
    actions = torch.arange(n_act)
    window, weights = pctl.decode_action_t(actions, n_owners)
    for a in range(n_act):
        w_h, ww_h = pctl.decode_action(a, n_owners)
        assert _np(window)[a] == w_h
        np.testing.assert_array_equal(_np(weights)[a], ww_h)
    rng = np.random.default_rng(n_owners)
    n = n_act
    sig = (1 + rng.random((n, n_owners))).astype(np.float32)
    hits = rng.random((n, n_owners)).astype(np.float32)
    scalars = rng.random((7, n)).astype(np.float32) + 0.1
    prev_w = _np(window).copy()
    prev_w[0] = 3.0                  # no exact match: one-hot at index 0
    got = pctl.build_state_t(
        torch.as_tensor(sig), torch.as_tensor(hits),
        torch.as_tensor(hits.mean(1)),
        *map(torch.as_tensor, scalars), torch.as_tensor(prev_w), weights)
    assert got.shape == (n, pctl.state_dim(n_owners))
    for i in range(n):
        want = pctl.build_state(sig[i], hits[i], hits[i].mean(),
                                *scalars[:, i], prev_w[i], _np(weights)[i])
        np.testing.assert_allclose(_np(got)[i], want, **TOL)


# ------------------------------------------------------- simulator steps
N_ENVS = 4
N_STEPS = 40


def _ref_analytic_params():
    return rcm.CostModelParams(t_base=0.0123, remote_nodes=80.0)


def _ref_table_params(n_owners=3, seed=1):
    rng = np.random.default_rng(seed)
    shape = (rtab.N_W, n_owners + 1, n_owners)
    tables = {
        "miss_rows": 50 * rng.random(shape),
        "miss_active": rng.random(shape),
        "rebuild_rows": 900 * rng.random(shape),
        "rebuild_active": rng.random(shape),
        "hit": rng.random(shape),
    }
    kw = dict(t_base=0.011, feature_bytes=256.0, slack=0.044)
    return tables, kw


def _env_pair(kind):
    """(reference module, reference params, port module, port pool)."""
    if kind == "analytic":
        params = _ref_analytic_params()
        port_params = pcm.CostModelParams(t_base=0.0123, remote_nodes=80.0)
        return rsim, _f32_tree(params), psim, _port_params(port_params,
                                                           N_ENVS)
    tables, kw = _ref_table_params()
    return (rtab, _f32_tree(rtab.make_table_params(tables, **kw)), ptab,
            _port_params(ptab.make_table_params(tables, **kw), N_ENVS))


def _state_fields(kind, ref, port):
    pairs = [(ref.obs, port.obs), (ref.step_pos, port.step_pos),
             (ref.total_energy, port.total_energy),
             (ref.total_time, port.total_time)]
    if kind == "analytic":
        pairs += [(ref.prev_window, port.prev_window),
                  (ref.prev_weights, port.prev_weights)]
    return pairs


@pytest.mark.parametrize("schedule", [0, 1])
@pytest.mark.parametrize("kind", ["analytic", "table"])
def test_reset_and_step_match_reference_with_replayed_draws(kind, schedule):
    """Obs, reward, done and the running totals, step by step, for 4 envs
    over 40 decisions of seeded actions."""
    rmod, rparams, pmod, pool = _env_pair(kind)
    cfg_r = rsim.EnvConfig(schedule=schedule, n_epochs=6,
                           steps_per_epoch=32)
    cfg_p = psim.EnvConfig(schedule=schedule, n_epochs=6, steps_per_epoch=32)
    keys = jax.random.split(jax.random.PRNGKey(7 + schedule), N_ENVS)
    r_reset = jax.jit(jax.vmap(lambda k: rmod.reset(cfg_r, k, rparams)))
    r_step = jax.jit(jax.vmap(lambda s, a: rmod.step(cfg_r, s, a)))
    draws = ReferenceDraws(keys)

    ref = r_reset(keys)
    port = pmod.reset(cfg_p, draws, pool)
    for r, p in _state_fields(kind, ref, port):
        np.testing.assert_allclose(_np(p), np.asarray(r), **TOL)
    rng = np.random.default_rng(schedule)
    n_done = 0
    for _ in range(N_STEPS):
        actions = rng.integers(0, rctl.n_actions(3), N_ENVS)
        ref, r_obs, r_rew, r_done = r_step(ref, jnp.asarray(actions))
        port, p_obs, p_rew, p_done = pmod.step(
            cfg_p, port, torch.as_tensor(actions), draws)
        np.testing.assert_allclose(_np(p_obs), np.asarray(r_obs), **TOL)
        np.testing.assert_allclose(_np(p_rew), np.asarray(r_rew), **TOL)
        np.testing.assert_array_equal(_np(p_done), np.asarray(r_done))
        for r, p in _state_fields(kind, ref, port):
            np.testing.assert_allclose(_np(p), np.asarray(r), **TOL)
        n_done += int(np.asarray(r_done).sum())
    assert n_done > 0            # some episodes ended within the run


def test_table_step_time_energy_matches_reference():
    tables, kw = _ref_table_params()
    rparams = _f32_tree(rtab.make_table_params(tables, **kw))
    pool = _port_params(ptab.make_table_params(tables, **kw), 32)
    w = torch.arange(32) % rtab.N_W
    a = torch.arange(32) % 4
    delta = torch.as_tensor(
        np.random.default_rng(2).random((32, 3)).astype(np.float32) * 30)
    t, e, aux = ptab.step_time_energy(pool, w, a, delta)
    for i in range(32):
        rt, re, raux = rtab.step_time_energy(
            rparams, jnp.asarray(int(w[i])), jnp.asarray(int(a[i])),
            jnp.asarray(_np(delta)[i]))
        np.testing.assert_allclose(_np(t)[i], np.asarray(rt), **TOL)
        np.testing.assert_allclose(_np(e)[i], np.asarray(re), **TOL)
        for k in ("stall", "rebuild_frac", "miss_frac", "sigma", "hit"):
            np.testing.assert_allclose(_np(aux[k])[i], np.asarray(raux[k]),
                                       **TOL)


# ------------------------------------------------------- whole episodes
@pytest.mark.parametrize("window,alloc", [(16, 0), (128, 0), (2, 3)])
@pytest.mark.parametrize("schedule", [1, 2])
def test_static_episodes_match_reference_rollout(schedule, window, alloc):
    """A static policy ignores the noise, and schedules 1 and 2 ignore
    the profile, so the port's episode totals must equal the
    reference's ``rollout_policy`` whatever either draws (rtol 1e-5)."""
    params = rcm.CostModelParams()
    action = rctl.encode_action(rcm.WINDOW_CHOICES.index(window), alloc, 3)
    out = rsim.rollout_policy(
        rsim.EnvConfig(schedule=schedule), jax.random.PRNGKey(3), params,
        lambda obs, key: jnp.asarray(action, jnp.int32))
    draws = psim.Draws(torch.Generator().manual_seed(3))
    got = psim.rollout_policy(
        psim.EnvConfig(schedule=schedule), draws,
        _port_params(pcm.CostModelParams(), 2),
        lambda obs: torch.full((obs.shape[0],), action))
    for k in ("total_energy", "total_time"):
        np.testing.assert_allclose(_np(got[k]),
                                   np.full(2, float(out[k])), rtol=1e-5)
    trace = got["trace"]
    n_dec = int(np.asarray(out["trace"]["active"]).sum())
    assert int(_np(trace["active"][:, 0]).sum()) == n_dec
    assert (_np(trace["window"]) == window).all()


def test_rollout_reward_scale_invariance():
    """The reference-window policy earns reward ~ -1 whatever the
    congestion (the reference's bounds)."""
    draws = psim.Draws(torch.Generator().manual_seed(2))
    out = psim.rollout_policy(
        psim.EnvConfig(schedule=0), draws,
        _port_params(pcm.CostModelParams(), 8),
        lambda obs: torch.full((obs.shape[0],), 16), max_decisions=256)
    r = _np(out["trace"]["reward"])[_np(out["trace"]["active"])]
    assert -1.15 < r.mean() < -0.9


def test_oracle_window_beats_static_under_the_paper_schedule():
    """Under schedule 1 a better window exists than W=16: the port's
    episode totals order the static windows as the reference's do."""
    params = rcm.CostModelParams()
    pool = _port_params(pcm.CostModelParams(), 1)
    draws = psim.Draws(torch.Generator().manual_seed(0))
    cfg = psim.EnvConfig(schedule=1)
    got, want = [], []
    for w in (4, 8, 16, 32):
        a = rpol._window_action(w, 3)
        got.append(float(psim.rollout_policy(
            cfg, draws, pool, lambda obs: torch.full((1,), a))[
                "total_energy"][0]))
        want.append(float(rsim.rollout_policy(
            rsim.EnvConfig(schedule=1), jax.random.PRNGKey(0), params,
            rpol.static_policy(w))["total_energy"]))
    assert np.argsort(got).tolist() == np.argsort(want).tolist()
