"""The port's queue env (``core/queue_sim.py``), its fabric-process twins
and its window kernel's wrapper, against the JAX reference, on the CPU.

JAX's threefry and torch's generators differ, so the env takes its draws
through a seam (``queue_sim.Draws``); ``ReferenceQueueDraws`` replays the
draws the reference makes from the same keys, splitting them as
``repro/core/queue_sim.py`` does: ``reset`` splits (k_pool, k_sc, k_dyn,
k_obs, k_next) and ``sample_scenario`` splits k_sc ten ways; a step splits
(key, k_dyn, k_obs); each step of a window splits (key, k_markov, k_step)
and k_step into (k_flip, k_val); an observation splits k_obs into (k_sig,
k_e, k_h). On the CPU the window runs the kernel's plain version.

Tolerances: ``sample_scenario``'s integers are equal and its floats within
rtol 1e-6 (its only transcendental is exp). The twins, the windows, the
steps and whole episodes are held within rtol 1e-5 / atol 1e-6: torch's
sin, exp and pow may differ from XLA's in the last bit, sums over owners
may run in another order, and the reference's own two twins of this env
differ by 1.19e-7 (``tests/test_cluster_env.py::TestQueueSimReduction``).
Discrete outputs (codes, kinds, ``done``) are equal.
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
from repro.core import domain_rand as rdr
from repro.core import queue_sim as rqs
from repro_torch.core import controller as pctl
from repro_torch.core import cost_model as pcm
from repro_torch.core import domain_rand as pdr
from repro_torch.core import dqn as pdqn
from repro_torch.core import queue_sim as pqs
from repro_torch.envs import resolve_env
from repro_torch.kernels import _build
from repro_torch.kernels.queue_window import ops as qw
from repro_torch.train import policy as ppol
from test_torch_simulator import _profile_to_torch
from _jax_release import release_jax_executables  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
TOL_SAMPLE = dict(rtol=1e-6, atol=0.0)
P = 3
CODES = sorted(rqs.SCENARIO_CODES.values())
WINDOWS = (1, 2, 16, 128)
PARAMS = rcm.CostModelParams()
PARAMS32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), PARAMS)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _pool(n):
    return ppol.make_params_pool([pcm.CostModelParams()] * n, device="cpu")


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


# ------------------------------------------------------------ draws seam
@functools.partial(jax.jit, static_argnums=1)
def _window_uniforms(keys, p):
    """Each key's (MAX_WINDOW, 3, p) window draws, as ``substep`` makes
    them: the Markov uniform, the resample uniform, the level's unit
    uniform (``uniform(k_val, minval=0, maxval=m)`` maps the same bits)."""
    def one(key):
        def body(key, _):
            key, k_markov, k_step = jax.random.split(key, 3)
            k_flip, k_val = jax.random.split(k_step)
            return key, jnp.stack([jax.random.uniform(k_markov, (p,)),
                                   jax.random.uniform(k_flip, (p,)),
                                   jax.random.uniform(k_val, (p,))])
        return jax.lax.scan(body, key, None, length=rqs.MAX_WINDOW)[1]
    return jax.vmap(one)(keys)


@functools.partial(jax.jit, static_argnums=1)
def _split(keys, parts):
    return jax.vmap(lambda k: jax.random.split(k, parts))(keys)


@functools.partial(jax.jit, static_argnums=1)
def _unit_jax(keys, shape):
    return jax.vmap(lambda k: jax.random.uniform(k, shape))(keys)


def _unit(keys, shape=()):
    return _t(_unit_jax(keys, shape))


def _randint(keys, hi):
    return _t(jax.vmap(lambda k: jax.random.randint(k, (), 0, hi))(keys),
              torch.int64)


@functools.partial(jax.jit, static_argnums=1)
def _noise(keys, p):
    def one(ko):
        k_sig, k_e, k_h = jax.random.split(ko, 3)
        return (rdr.observation_noise(k_sig, (p,)),
                rdr.observation_noise(k_e, ()),
                rdr.observation_noise(k_h, (p,)))
    return jax.vmap(one)(keys)


class ReferenceQueueDraws:
    """The draws the reference's ``reset``/``step`` make from one key per
    env, in the order the port asks for them: scenario, profile, window,
    noise at reset; window, noise at a step."""

    def __init__(self, keys):
        self.keys = keys                  # (n, 2) uint32, one per env
        self._dyn = self._obs = self._prof = None

    def scenario(self, cfg, n):
        k = _split(self.keys, 5)
        k_pool, k_sc = k[:, 0], k[:, 1]
        self._dyn, self._obs, self.keys = k[:, 2], k[:, 3], k[:, 4]
        ks = _split(k_sc, 10)
        self._prof = ks[:, 5]
        return pqs.ScenarioDraws(
            pool_idx=_randint(k_pool, len(cfg.scenario_pool)),
            jitter=_unit(ks[:, 0]), util=_unit(ks[:, 1]),
            severity=_unit(ks[:, 2]), victim=_randint(ks[:, 3], cfg.n_owners),
            phase=_unit(ks[:, 4], (cfg.n_owners,)), offset=_unit(ks[:, 6]),
            mean_seg=_unit(ks[:, 7]), level_max=_unit(ks[:, 8]))

    def profile(self, cfg, n):
        prof = jax.vmap(lambda k: rdr.sample_profile(
            k, cfg.total_steps, cfg.n_owners))(self._prof)
        return _profile_to_torch(prof)

    def window(self, cfg, n):
        if self._dyn is not None:
            k_dyn, self._dyn = self._dyn, None
        else:
            k = _split(self.keys, 3)
            self.keys, k_dyn, self._obs = k[:, 0], k[:, 1], k[:, 2]
        return _t(_window_uniforms(k_dyn, cfg.n_owners))

    def noise(self, cfg, n):
        k_obs, self._obs = self._obs, None
        return tuple(_t(x) for x in _noise(k_obs, cfg.n_owners))


def _keys(seed, n):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _scenario_to_torch(sc) -> pqs.QueueScenario:
    ints = ("kind", "util_kind", "victim", "delta_kind")
    fields = {f.name: getattr(sc, f.name) for f in dataclasses.fields(sc)}
    return pqs.QueueScenario(**{
        k: (_profile_to_torch(v) if k == "profile" else
            _t(v, torch.int64 if k in ints else torch.float32))
        for k, v in fields.items()})


@functools.lru_cache(maxsize=None)
def _ref_sampler(total_steps, n_owners):
    return jax.jit(jax.vmap(lambda k, c: rqs.sample_scenario(
        jax.random.split(k, 5)[1], c, total_steps, n_owners)))


def _ref_scenarios(keys, codes, cfg):
    """The reference's scenarios, of ``codes`` (one a key, or one for
    all), from the k_sc of each key."""
    codes = jnp.broadcast_to(jnp.asarray(codes, jnp.int32), (len(keys),))
    return _ref_sampler(cfg.total_steps, cfg.n_owners)(keys, codes)


def _assert_tree_close(got, want, tol, path=""):
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            _assert_tree_close(getattr(got, f.name), getattr(want, f.name),
                               tol, f"{path}.{f.name}")
        return
    got, want = _np(got), np.asarray(want)
    if np.issubdtype(want.dtype, np.integer) or want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        np.testing.assert_allclose(got, want, err_msg=path, **tol)


# ------------------------------------------------------------ scenarios
def test_codes_and_default_pool_equal_reference():
    assert pqs.SCENARIO_CODES == rqs.SCENARIO_CODES
    assert pqs.N_SCENARIOS == rqs.N_SCENARIOS
    assert pqs.default_training_pool() == rqs.default_training_pool()
    for spec in ("clean", "closed_form", "fixed:10", "trace:x.json",
                 "arch_osc", "incast", "bursty_markov", "arch_none"):
        assert pqs.code_for(spec) == rqs.code_for(spec)
    with pytest.raises(KeyError):
        pqs.code_for("warp_drive")


@pytest.mark.parametrize("code", CODES)
def test_sample_scenario_matches_reference(code):
    """Every field of 16 scenarios of ``code``, drawn from the reference's
    keys: integers equal, floats within rtol 1e-6."""
    cfg = pqs.QueueEnvConfig(n_owners=P, n_epochs=30, steps_per_epoch=32)
    keys = _keys(code, 16)
    want = _ref_scenarios(keys, code, cfg)
    draws = ReferenceQueueDraws(keys)
    u = draws.scenario(cfg, 16)
    got = pqs.sample_scenario(u, draws.profile(cfg, 16),
                              torch.full((16,), code), cfg.total_steps, P)
    _assert_tree_close(got, want, TOL_SAMPLE)


# ----------------------------------------------------------------- twins
def _twin_cases(name, rng, n=64):
    f = lambda *s: rng.random(s).astype(np.float32)  # noqa: E731
    step = np.floor(rng.random(n) * 4000).astype(np.float32)
    if name == "diurnal_util":
        args = (step, 1 + 300 * f(n), f(n), 6.3 * f(n, P))
        ref = jax.vmap(rdr.diurnal_util)
        return ref, pdr.diurnal_util, args, {}
    if name == "incast_util":
        # negative offsets too: the remainder takes the period's sign
        args = (step, 0.5 + 300 * f(n), f(n), f(n),
                (600 * f(n) - 300).astype(np.float32))
        ref = jax.vmap(lambda *a: rdr.incast_util(*a, P))
        return ref, pdr.incast_util, args, {"n_links": P}
    if name == "straggler_util":
        args = (rng.integers(0, P, n), f(n))
        ref = jax.vmap(lambda v, u: rdr.straggler_util(v, u, P))
        return ref, pdr.straggler_util, args, {"n_links": P}
    if name == "markov_switch_prob":
        args = (np.concatenate([[0.0, 1e-7], 500 * f(n - 2)]).astype(
            np.float32),)
        return rdr.markov_switch_prob, pdr.markov_switch_prob, args, {}
    raise KeyError(name)


@pytest.mark.parametrize("name", ["diurnal_util", "incast_util",
                                  "straggler_util", "markov_switch_prob"])
def test_fabric_twins_match_reference(name):
    ref, port, args, kw = _twin_cases(name, np.random.default_rng(5))
    want = ref(*(jnp.asarray(a) for a in args))
    got = port(*(torch.as_tensor(a) for a in args), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["markov_onoff_update",
                                  "step_trace_update"])
def test_fabric_updates_match_reference_on_its_draws(name):
    """The updates take the unit uniforms the reference draws from its
    key; 200 steps of 64 chains, carried."""
    rng = np.random.default_rng(6)
    n = 64
    keys = _keys(11, n)
    p_a = jnp.asarray(rng.random(n).astype(np.float32) * 0.3)
    p_b = jnp.asarray(rng.random(n).astype(np.float32) * 40)
    state = jnp.asarray((rng.random((n, P)) < 0.5).astype(np.float32))
    got = torch.as_tensor(np.asarray(state))
    for _ in range(200):
        k = jax.vmap(jax.random.split)(keys)
        keys, kk = k[:, 0], k[:, 1]
        if name == "markov_onoff_update":
            state = jax.vmap(rdr.markov_onoff_update)(kk, state, p_a, p_b)
            got = pdr.markov_onoff_update(
                _unit(kk, (P,)), got, _t(p_a), _t(p_b))
        else:
            state = jax.vmap(rdr.step_trace_update)(kk, state, p_a, p_b)
            kf = jax.vmap(jax.random.split)(kk)
            got = pdr.step_trace_update(
                _unit(kf[:, 0], (P,)), _unit(kf[:, 1], (P,)), got, _t(p_a),
                _t(p_b))
        np.testing.assert_allclose(_np(got), np.asarray(state), **TOL)
    assert 0 < float(jnp.mean(state)) and (
        name == "step_trace_update" or float(jnp.mean(state)) < 1)


# ------------------------------------------------------------- windows
@functools.lru_cache(maxsize=None)
def _ref_window(cfg):
    return jax.jit(jax.vmap(
        lambda sc, k, w, wt, pos, us, dl, bl, rb, sh, eff:
        rqs._window_dynamics(cfg, PARAMS32, sc, k, w, wt, pos, us, dl, bl,
                             rb, sh, eff_window=eff)))


def _window_case(codes, window, seed, mem_budget_frac=0.0):
    """A batch of windows, one env per code: carried backlogs, Markov
    states and levels; step positions across the run; eff_window cut for
    some envs (0, 1, half the window) as the episode horizon cuts it."""
    n = len(codes)
    rcfg = rqs.QueueEnvConfig(n_owners=P, n_epochs=30, steps_per_epoch=32,
                              mem_budget_frac=mem_budget_frac)
    pcfg = pqs.QueueEnvConfig(n_owners=P, n_epochs=30, steps_per_epoch=32,
                              mem_budget_frac=mem_budget_frac)
    rng = np.random.default_rng(seed)
    keys = _keys(seed, n)
    sc = _ref_scenarios(keys, codes, rcfg)
    f = lambda *s: rng.random(s).astype(np.float32)  # noqa: E731
    weights = np.stack([np.asarray(rctl.allocation_weights(
        int(a), P)) for a in rng.integers(0, P + 1, n)])
    step_pos = np.floor(f(n) * (rcfg.total_steps - 1)).astype(np.float32)
    eff = np.full(n, window, np.float32)
    eff[1::4] = 0.0
    eff[2::4] = 1.0
    eff[3::4] = np.ceil(window / 2)
    inputs = dict(
        w=np.full(n, window, np.float32), wt=weights, pos=step_pos,
        us=(f(n, P) < 0.5).astype(np.float32), dl=40 * f(n, P),
        bl=0.05 * f(n, P), rb=0.05 * f(n, P), sh=0.05 * f(n), eff=eff)
    dyn_keys = jax.vmap(lambda k: jax.random.split(k, 5)[2])(keys)
    want = _ref_window(rcfg)(sc, dyn_keys, *(jnp.asarray(v) for v in
                                             inputs.values()))
    t = {k: torch.as_tensor(v) for k, v in inputs.items()}
    got = pqs._window_dynamics(
        pcfg, _pool(n), _scenario_to_torch(sc),
        _t(_window_uniforms(dyn_keys, P)), t["w"], t["wt"], t["pos"],
        t["us"], t["dl"], t["bl"], t["rb"], t["sh"], eff_window=t["eff"])
    return got, want


def _assert_window_close(got, want):
    for k, v in got.items():
        np.testing.assert_allclose(_np(v), np.asarray(want[k]), err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("code", CODES)
def test_window_dynamics_matches_reference(code, window):
    """Eight envs of ``code`` from carried fabric states, every output of
    the window (accounting, estimator inputs, fabric state)."""
    got, want = _window_case([code] * 8, window, seed=100 * code + window)
    _assert_window_close(got, want)


@pytest.mark.parametrize("window", WINDOWS)
def test_window_dynamics_under_memory_pressure(window):
    """``mem_budget_frac`` 0.3: the spill multiplies both actions' wire
    work; one env per code."""
    got, want = _window_case(CODES, window, seed=window,
                             mem_budget_frac=0.3)
    _assert_window_close(got, want)


# -------------------------------------------------------- reset and step
@pytest.mark.parametrize("mem,headroom", [(0.0, False), (0.3, True)])
def test_reset_and_steps_match_reference(mem, headroom):
    """Reset and 8 steps of 28 envs over every code's pool, seeded
    actions, 4 epochs of 16 steps (windows cut by the horizon, episodes
    ending): obs, reward, done, totals and fabric state."""
    pool = tuple(CODES)
    kw = dict(n_owners=P, n_epochs=4, steps_per_epoch=16, scenario_pool=pool,
              mem_budget_frac=mem, observe_headroom=headroom)
    rcfg, pcfg = rqs.QueueEnvConfig(**kw), pqs.QueueEnvConfig(**kw)
    n = 28
    keys = _keys(21, n)
    r_reset = jax.jit(jax.vmap(lambda k: rqs.reset(rcfg, k, PARAMS32)))
    r_step = jax.jit(jax.vmap(lambda s, a: rqs.step(rcfg, s, a)))
    draws = ReferenceQueueDraws(keys)
    ref = r_reset(keys)
    port = pqs.reset(pcfg, draws, _pool(n))
    assert port.obs.shape == (n, pctl.state_dim(P, headroom=headroom))
    assert len(set(_np(port.scenario.kind).tolist())) >= 8

    def fields(r, p):
        _assert_tree_close(p.scenario, r.scenario, TOL)
        for k in ("step_pos", "prev_window", "prev_weights", "obs", "done",
                  "total_energy", "total_time", "util_state", "delta_level",
                  "backlog", "rb_backlog", "shared_backlog"):
            _assert_tree_close(getattr(p, k), getattr(r, k), TOL, k)

    fields(ref, port)
    rng = np.random.default_rng(4)
    n_done = 0
    for _ in range(8):
        actions = rng.integers(0, rctl.n_actions(P), n)
        ref, r_obs, r_rew, r_done = r_step(ref, jnp.asarray(actions))
        port, p_obs, p_rew, p_done = pqs.step(
            pcfg, port, torch.as_tensor(actions), draws)
        np.testing.assert_allclose(_np(p_obs), np.asarray(r_obs), **TOL)
        np.testing.assert_allclose(_np(p_rew), np.asarray(r_rew), **TOL)
        np.testing.assert_array_equal(_np(p_done), np.asarray(r_done))
        fields(ref, port)
        n_done += int(np.asarray(r_done).sum())
    assert n_done > 0


@pytest.mark.parametrize("window,alloc,code", [
    (16, 0, "paper_schedule"), (2, 2, "bursty_markov"), (128, 0, "incast"),
    (4, 1, "trace"), (32, 3, "arch_switch")])
def test_static_episode_matches_reference_rollout(window, alloc, code):
    """A whole episode (4 epochs of 32 steps) under one static action,
    the reference's draws replayed: energy and time totals, and the
    rewards and step positions of every decision."""
    kw = dict(n_owners=P, n_epochs=4, steps_per_epoch=32,
              scenario_pool=(rqs.SCENARIO_CODES[code],))
    rcfg, pcfg = rqs.QueueEnvConfig(**kw), pqs.QueueEnvConfig(**kw)
    action = rctl.encode_action(rcm.WINDOW_CHOICES.index(window), alloc, P)
    key = jax.random.PRNGKey(window)
    want = rqs.rollout_policy(rcfg, key, PARAMS32,
                              lambda obs, k: jnp.asarray(action, jnp.int32),
                              max_decisions=rcfg.total_steps)
    got = pqs.rollout_policy(pcfg, ReferenceQueueDraws(key[None]), _pool(1),
                             lambda obs: torch.full((1,), action),
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


# ------------------------------------------------------- wrapper (ops.py)
def _wrapper_inputs(n=6, p=P, seed=0, pcfg=None):
    """The inputs ``_window_dynamics`` hands the wrapper, on the CPU."""
    pcfg = pcfg or pqs.QueueEnvConfig(n_owners=p, n_epochs=4,
                                      steps_per_epoch=32)
    draws = pqs.Draws(torch.Generator().manual_seed(seed))
    pool = ppol.make_params_pool([pcm.CostModelParams()] * n, device="cpu")
    state = pqs.reset(pcfg, draws, pool)
    window, weights = pctl.decode_action_t(
        torch.arange(n) * 3 % pctl.n_actions(p), p)
    g = torch.Generator().manual_seed(seed + 1)
    _, vol, fabric = pqs.window_operands(
        pcfg, pool, window, weights,
        (torch.rand((n, p), generator=g) < 0.5).float(),
        30 * torch.rand((n, p), generator=g),
        0.02 * torch.rand((n, p), generator=g),
        0.02 * torch.rand((n, p), generator=g),
        0.02 * torch.rand(n, generator=g))
    eff = torch.minimum(window, torch.tensor([128.0, 0, 1, 5, 64, 128])[:n])
    return (pcfg, pool, state.scenario, vol, fabric, draws.window(pcfg, n),
            window, eff, 40 * torch.arange(n, dtype=torch.float32))


def test_layout_matches_the_kernel_source():
    """The wrapper's column names, in the order of the enums of the .cu
    and the window header it includes (``fluid_window.cuh``, shared with
    the cluster env's kernel)."""
    cu = (_build.CSRC / "queue_window.cu").read_text()
    src = "".join(p.read_text() for p in _build.sources("queue_window"))

    def enum(name):
        body = re.search(r"enum %s\s*\{([^}]*)\}" % name, src).group(1)
        return [x.strip() for x in body.split(",") if x.strip()]

    for name, cols, prefix in (("Scal", qw.SCALARS, "S_"),
                               ("Ints", qw.INTS, "I_"),
                               ("Own", qw.OWNERS, "O_"),
                               ("State", qw.STATE, "ST_"),
                               ("Acc", qw.ACC, "A_"),
                               ("AccOwn", qw.ACC_OWNERS, "AO_")):
        names = enum(name)
        assert names[-1].startswith("N_")
        assert [x[len(prefix):].lower() for x in names[:-1]] == list(cols)
    # the env's constants the kernel compiles in
    consts = dict(re.findall(r"constexpr \w+ (\w+) = ([^;]+);", src))
    assert int(consts["MAX_WINDOW"]) == pqs.MAX_WINDOW == qw.MAX_WINDOW
    assert float(consts["MAX_UTILIZATION"].rstrip("f")) \
        == pqs.MAX_UTILIZATION
    assert float(consts["PROP_RTT_S_PER_MS"].rstrip("f")) \
        == pqs.PROP_RTT_S_PER_MS
    assert float(consts["REF_W"].rstrip("f")) == pqs.REFERENCE_WINDOW
    assert [int(x) for x in re.findall(
        r"launch<(\d+)>\(", cu)] == [1, 2, 3, 4, 8, 16]
    assert max(int(x) for x in re.findall(r"launch<(\d+)>\(", cu)) \
        == qw.MAX_OWNERS
    assert _build.ENTRIES["queue_window_f32"][0] == "queue_window"
    assert (_build.CSRC / "queue_window.cu").is_file()
    assert "-fmad=false" in _build._flags("queue_window")
    assert _build._lib_path("queue_window").parent.parent == _build.BUILD_DIR


def test_shared_memory_layout_matches_the_kernel_source():
    """The block's shared-memory slots in the order of the header's
    StepOwner and StepTerm enums, the block a step wide, and both entries
    raising a block's shared-memory limit for what passes 48 KB."""
    src = (_build.CSRC / "fluid_window.cuh").read_text()

    def enum(name):
        body = re.search(r"enum %s\s*\{([^}]*)\}" % name, src).group(1)
        return [x.strip() for x in body.split(",") if x.strip()]

    for name, cols, prefix in (("StepOwner", qw.STEP_OWNER_TERMS, "SO_"),
                               ("StepTerm", qw.STEP_TERMS, "SP_")):
        names = enum(name)
        assert names[-1].startswith("N_")
        assert [x[len(prefix):].lower() for x in names[:-1]] == list(cols)
    assert "constexpr int THREADS = MAX_WINDOW;" in src
    assert qw.smem_bytes(3) < 48 * 1024 < qw.smem_bytes(16) <= qw.MAX_SMEM
    for stem in ("queue_window", "cluster_window"):
        cu = (_build.CSRC / f"{stem}.cu").read_text()
        assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in cu
        assert f"smem_bytes<{str(stem == 'cluster_window').lower()}>(a.P)" \
            in cu


@pytest.mark.parametrize("p", [1, 3, 8])
def test_backlog_free_outputs_ignore_the_carried_backlogs(p):
    """The premise of the kernel's split: on the same operands but other
    carried backlogs, the plain version's backlog-free outputs (the
    reference action's energy, the live steps, the active sums, the
    chains) are equal, while the time, energy and backlogs differ."""
    args = list(_wrapper_inputs(p=p, seed=p))
    acc, fabric = qw.queue_window_plain(*args)
    fab = args[4]
    args[4] = dataclasses.replace(
        fab, backlog=fab.backlog + 0.5, rb_backlog=2 * fab.rb_backlog + 0.01,
        shared_backlog=fab.shared_backlog + 0.25)
    acc2, fabric2 = qw.queue_window_plain(*args)
    for k in ("e_ref", "n", "active"):
        assert torch.equal(acc[k], acc2[k]), k
    for k in ("util_state", "delta_level"):
        assert torch.equal(getattr(fabric, k), getattr(fabric2, k)), k
    for k in ("t", "e"):
        assert not torch.equal(acc[k], acc2[k]), k
    assert not torch.equal(fabric.backlog, fabric2.backlog)


def test_pack_puts_every_field_in_its_column():
    cfg, params, sc, vol, fabric, uniforms, window, eff, pos = \
        _wrapper_inputs()
    scal, ints, own, state = qw.pack(cfg, params, sc, vol, fabric, window,
                                     eff, pos)
    for t in (scal, ints, own, state):
        assert t.is_contiguous()
    assert scal.dtype == torch.float32 and ints.dtype == torch.int32
    col = dict(zip(qw.SCALARS, scal.unbind(1)))
    assert torch.equal(col["window"], window)
    assert torch.equal(col["eff_window"], eff)
    assert torch.equal(col["step_pos"], pos)
    assert torch.equal(col["p_switch"], sc.p_switch)
    assert torch.equal(col["prof_onset"], sc.profile.onset)
    assert torch.equal(col["slope"], params.gamma_c / params.beta)
    assert torch.equal(col["slack"], cfg.slack_steps * params.t_base)
    assert torch.equal(col["rb_cpu_ref"], vol.rb_cpu_ref)
    assert torch.equal(col["shared_backlog"], fabric.shared_backlog)
    icol = dict(zip(qw.INTS, ints.unbind(1)))
    assert torch.equal(icol["delta_kind"].long(), sc.delta_kind)
    assert torch.equal(icol["link_b"].long(), sc.profile.link_b)
    ocol = dict(zip(qw.OWNERS, own.unbind(1)))
    assert torch.equal(ocol["phase"], sc.phase)
    assert torch.equal(ocol["rb_work_ref"], vol.rb_work_ref)
    scol = dict(zip(qw.STATE, state.unbind(1)))
    assert torch.equal(scol["rb_backlog"], fabric.rb_backlog)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    args = _wrapper_inputs()
    acc, fabric = qw.queue_window(*args)
    acc_p, fabric_p = qw.queue_window_plain(*args)
    for k in acc_p:
        assert torch.equal(acc[k], acc_p[k]), k
    for f in dataclasses.fields(fabric_p):
        assert torch.equal(getattr(fabric, f.name), getattr(fabric_p, f.name))
    assert torch.equal(acc["n"], args[7])      # live steps = eff_window


def test_masked_steps_change_nothing():
    """The kernel stops at eff_window: every draw past it, replaced, must
    leave every output of the masked loop bit for bit."""
    args = list(_wrapper_inputs())
    eff, uniforms = args[7], args[5]
    acc, fabric = qw.queue_window_plain(*args)
    past = torch.arange(qw.MAX_WINDOW)[None, :] >= eff[:, None]
    args[5] = torch.where(past[:, :, None, None], 1.0 - uniforms, uniforms)
    acc2, fabric2 = qw.queue_window_plain(*args)
    for k in acc:
        assert torch.equal(acc[k], acc2[k]), k
    for f in dataclasses.fields(fabric):
        assert torch.equal(getattr(fabric, f.name), getattr(fabric2, f.name))


def test_window_dynamics_is_the_wrapper_between_volumes_and_summary():
    """``_window_dynamics``' outputs from the plain version's on the
    operands ``window_operands`` builds, and its fabric state the plain
    version's (the rebuild work queued ahead of the carried backlog)."""
    cfg, params, sc, _, _, uniforms, window, eff, pos = _wrapper_inputs()
    weights = pctl.decode_action_t(torch.arange(6) * 3 % 32, P)[1]
    g = torch.Generator().manual_seed(9)
    carried = [(torch.rand((6, P), generator=g) < 0.5).float()] + [
        torch.rand((6, P), generator=g) for _ in range(3)] + [
        torch.rand(6, generator=g)]
    dyn = pqs._window_dynamics(cfg, params, sc, uniforms, window, weights,
                               pos, *carried, eff_window=eff)
    _, vol, fabric = pqs.window_operands(cfg, params, window, weights,
                                         *carried)
    assert torch.equal(fabric.rb_backlog, carried[3] + pqs.action_volumes(
        params, window, weights, P)[4])
    acc, out = qw.queue_window_plain(cfg, params, sc, vol, fabric, uniforms,
                                     window, eff, pos)
    summary = pqs.summarize_window(params, acc, P)
    for k, v in summary.items():
        assert torch.equal(dyn[k], v), k
    for f in dataclasses.fields(out):
        assert torch.equal(dyn[f.name], getattr(out, f.name)), f.name


def test_wrapper_operand_checks():
    """What every call refuses (dtype, shape, contiguity, mixed or
    unsupported devices) and what a CUDA launch refuses beyond it: more
    owners than the kernel's register arrays hold, checked on metadata
    (a meta tensor) since the CPU has no kernel."""
    args = list(_wrapper_inputs())
    bad_dtype = list(args)
    bad_dtype[6] = args[6].double()
    with pytest.raises(TypeError):
        qw.queue_window(*bad_dtype)
    bad_shape = list(args)
    bad_shape[5] = args[5][:, :64].contiguous()
    with pytest.raises(ValueError):
        qw.queue_window(*bad_shape)
    strided = list(args)
    strided[5] = args[5].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        qw.queue_window(*strided)
    per_env = list(args)
    per_env[7] = args[7][:3]
    with pytest.raises(ValueError):
        qw.queue_window(*per_env)
    meta = list(args)
    meta[5] = args[5].to("meta")
    with pytest.raises(ValueError, match="one device"):
        qw.queue_window(*meta)
    qw.check_kernel_operands(torch.empty((4, 128, 3, 16), device="meta"))
    qw.check_kernel_operands(torch.empty((4, 128, 3, 1), device="meta"))
    with pytest.raises(ValueError, match="owners"):
        qw.check_kernel_operands(torch.empty((4, 128, 3, 17), device="meta"))


def test_kernel_operand_check_holds_shared_memory(monkeypatch):
    """A block's shared memory, at P owners, against the card's limit:
    the 16-owner block passes 48 KB and fits 227 KB; below what a block
    takes, the check refuses it on metadata alone."""
    wide = torch.empty((4, 128, 3, 16), device="meta")
    assert qw.smem_bytes(16) == 4 * (
        128 * (len(qw.STEP_OWNER_TERMS) * 16 + len(qw.STEP_TERMS))
        + len(qw.SCALARS) + (len(qw.OWNERS) + len(qw.STATE)) * 16
        + len(qw.INTS))
    qw.check_kernel_operands(wide)
    monkeypatch.setattr(qw, "MAX_SMEM", qw.smem_bytes(16) - 4)
    with pytest.raises(ValueError, match="shared memory"):
        qw.check_kernel_operands(wide)
    qw.check_kernel_operands(torch.empty((4, 128, 3, 8), device="meta"))


# -------------------------------------------------- training and policy
def test_resolve_env_queue_is_the_port_module():
    from repro_torch.envs import cluster_sim

    assert resolve_env("queue") is pqs
    # the cluster env is ported too (tests/test_torch_cluster_sim.py)
    assert resolve_env("cluster") is cluster_sim


def test_trains_with_dqn_protocol():
    """The reference's test: train_dqn runs unchanged on the queue env (4
    envs, 30 iterations): finite losses, gradient steps taken; and with
    the headroom entry the state grows by one."""
    env_cfg = pqs.QueueEnvConfig(
        steps_per_epoch=16, n_epochs=2,
        scenario_pool=(pqs.SCENARIO_CODES["clean"],
                       pqs.SCENARIO_CODES["bursty_markov"]))
    cfg = pdqn.DQNConfig(n_envs=4, iterations=30, min_replay=16,
                         eps_decay_iters=20, seed=0, device="cpu")
    res = pdqn.train_dqn(cfg, env_cfg, _pool(1), env=pqs)
    assert np.all(np.isfinite(_np(res["metrics"]["loss"])))
    assert int(res["grad_steps"]) > 0
    assert res["qnet"]["l1"]["w"].shape[0] == pctl.state_dim(P)


def test_train_policy_refuses_what_the_reference_refuses():
    pool = _pool(1)
    with pytest.raises(ValueError, match="scenario_pool"):
        ppol.train_policy(pool, iterations=2, env="analytic",
                          scenario_pool=("clean",), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        ppol.train_policy(pool, iterations=2, env="queue", scenario_pool=(),
                          device="cpu")
    with pytest.raises(ValueError, match="n_workers"):
        ppol.train_policy(pool, iterations=2, env="queue", n_workers=4,
                          device="cpu")
    # cluster_kwargs configure the cluster env, which refuses a bad one
    with pytest.raises(ValueError, match="sync"):
        ppol.train_policy(pool, iterations=2, env="cluster",
                          cluster_kwargs={"sync": True}, device="cpu")
    with pytest.raises(KeyError):
        ppol.train_policy(pool, iterations=2, env="queue",
                          scenario_pool=("warp_drive",), device="cpu")


def test_get_or_train_policy_writes_the_queue_artifact(tmp_path,
                                                       monkeypatch):
    """``env="queue"`` trains on a registry-spec pool and writes
    ``<name>_queue.npz``; a second call loads it."""
    monkeypatch.setattr(ppol, "ARTIFACT_DIR", str(tmp_path))
    q_fn, qnet = ppol.get_or_train_policy(
        _pool(1), name="t", iterations=6, env="queue", device="cpu",
        n_envs=4, scenario_pool=("incast", "fixed:10"), n_epochs=2,
        steps_per_epoch=16)
    assert (tmp_path / "t_queue.npz").is_file()
    assert (tmp_path / "t_queue.json").is_file()
    _, again = ppol.get_or_train_policy(_pool(1), name="t", env="queue",
                                        device="cpu")
    assert torch.equal(again["l3"]["w"], qnet["l3"]["w"])
    assert q_fn(np.zeros(pctl.state_dim(P), np.float32)).shape == (32,)
