"""The port's Double-DQN training against the JAX reference's, on the CPU.

The optimiser and the loss take the same parameters and batches on both
sides (converted across as numpy); the training loop's random streams
differ between the packages, so whole runs are held to the reference's
own checks (the target-sync arithmetic, same-seed reproducibility) and to
the reference's evaluation: a port-trained qnet, converted, is rolled out
through ``repro.core.simulator.rollout_policy``.

Tolerances: Adam with clipping rtol 1e-6 over 3 updates; the loss and its
gradients rtol 1e-5, atol 1e-6 (float32 matrix products summed in
another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as roptim
from repro.core import cost_model as rcm
from repro.core import dqn as rdqn
from repro.core import policies as rpol
from repro.core import simulator as rsim
from repro_torch import convert
from repro_torch import optim as poptim
from repro_torch.core import cost_model as pcm
from repro_torch.core import dqn as pdqn
from repro_torch.core import simulator as psim
from repro_torch.core import table_sim as ptab
from repro_torch.train import policy as ppol
from _jax_release import release_jax_executables  # noqa: F401


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _qnet_pair(seed, state_dim=23, n_act=32):
    """A reference qnet (numpy) and the same weights in the port."""
    ref = _np_tree(rdqn.init_qnet(jax.random.PRNGKey(seed), state_dim,
                                  n_act))
    return ref, convert.qnet_from_jax(ref)


def _batch(seed, n=64, state_dim=23, n_act=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, state_dim)).astype(np.float32),
            rng.integers(0, n_act, n).astype(np.int32),
            rng.normal(size=n).astype(np.float32),
            rng.normal(size=(n, state_dim)).astype(np.float32),
            rng.random(n) < 0.2)


def _port_batch(batch):
    s, a, r, s2, d = batch
    return (torch.as_tensor(s), torch.as_tensor(a.astype(np.int64)),
            torch.as_tensor(r), torch.as_tensor(s2), torch.as_tensor(d))


# ------------------------------------------------------------ optimiser
@pytest.mark.parametrize("scale", [0.01, 100.0])
def test_adam_with_clipping_matches_reference(scale):
    """Three updates of Adam(max_grad_norm=10) from the same parameters
    and gradients (scale 100 clips, 0.01 does not): rtol 1e-6."""
    ref_p, port_p = _qnet_pair(0)
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(
        lambda x: (scale * rng.normal(size=x.shape)).astype(np.float32),
        ref_p) for _ in range(3)]
    ropt = roptim.adam(3e-4, max_grad_norm=10.0)
    popt = poptim.adam(3e-4, max_grad_norm=10.0)
    rs, ps = ropt.init(ref_p), popt.init(port_p)
    rp = jax.tree.map(jnp.asarray, ref_p)
    for g in grads:
        upd, rs = ropt.update(jax.tree.map(jnp.asarray, g), rs, rp)
        rp = roptim.apply_updates(rp, upd)
        pupd, ps = popt.update(convert.qnet_from_jax(g), ps, port_p)
        port_p = poptim.apply_updates(port_p, pupd)
    for layer in ref_p:
        for k in ref_p[layer]:
            np.testing.assert_allclose(port_p[layer][k].numpy(),
                                       np.asarray(rp[layer][k]), rtol=1e-6,
                                       atol=1e-9)
    norm = poptim.global_norm(convert.qnet_from_jax(grads[0]))
    np.testing.assert_allclose(
        float(norm), float(roptim.optimizers.global_norm(grads[0])),
        rtol=1e-6)


def test_clip_scale_stays_a_tensor():
    g = {"w": torch.full((4,), 30.0)}
    clipped, norm = poptim.clip_by_global_norm(g, 10.0)
    assert isinstance(norm, torch.Tensor)
    np.testing.assert_allclose(float(poptim.global_norm(clipped)), 10.0,
                               rtol=1e-6)


# --------------------------------------------------------------- replay
def test_replay_ring_wraps():
    buf = pdqn.init_replay(23, capacity=100)
    s = torch.arange(60, dtype=torch.float32)[:, None].expand(60, 23)
    a = torch.arange(60)
    z, d = torch.zeros(60), torch.zeros(60, dtype=torch.bool)
    pdqn.replay_insert(buf, s, a, z, s, d)
    assert buf.size == 60 and buf.ptr == 60
    pdqn.replay_insert(buf, s + 100, a + 100, z, s, d)
    assert buf.size == 100 and buf.ptr == 20
    # the second batch's first 40 went to 60..99, its last 20 to 0..19
    np.testing.assert_array_equal(buf.a[60:].numpy(), np.arange(100, 140))
    np.testing.assert_array_equal(buf.a[:20].numpy(), np.arange(140, 160))
    np.testing.assert_array_equal(buf.a[20:60].numpy(), np.arange(20, 60))
    np.testing.assert_array_equal(buf.s[:20, 0].numpy(),
                                  np.arange(140, 160))
    with pytest.raises(ValueError):
        pdqn.replay_insert(buf, *(x.repeat(2, *([1] * (x.ndim - 1)))
                                  for x in (s, a, z, s, d)))


def test_replay_sample_never_reads_unfilled_slots():
    """Before the ring wraps, sampling stays within [0, size)."""
    buf = pdqn.init_replay(4, capacity=100)
    s = torch.ones(10, 4)
    pdqn.replay_insert(buf, s, torch.zeros(10, dtype=torch.int64),
                       torch.ones(10), s, torch.zeros(10, dtype=torch.bool))
    for seed in range(8):
        _, _, r, _, _ = pdqn.replay_sample(
            buf, torch.Generator().manual_seed(seed), batch=256)
        # unfilled slots hold r = 0
        assert float(r.min()) == 1.0


# ----------------------------------------------------------------- loss
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dqn_loss_and_gradients_match_reference(seed):
    ref_on, port_on = _qnet_pair(seed)
    ref_tg, port_tg = _qnet_pair(seed + 10)
    batch = _batch(seed)
    loss_r, grads_r = jax.value_and_grad(rdqn.dqn_loss)(
        jax.tree.map(jnp.asarray, ref_on), jax.tree.map(jnp.asarray, ref_tg),
        *map(jnp.asarray, batch))
    loss_p, grads_p = pdqn.loss_and_grads(port_on, port_tg,
                                          _port_batch(batch))
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=1e-5,
                               atol=1e-6)
    for layer in ref_on:
        for k in ref_on[layer]:
            np.testing.assert_allclose(grads_p[layer][k].numpy(),
                                       np.asarray(grads_r[layer][k]),
                                       rtol=1e-5, atol=1e-6)


def test_double_dqn_target_uses_online_argmax():
    """Online and target nets disagree on s2's best action: the loss is
    the one whose target evaluates the ONLINE net's argmax."""
    ref_on, online = _qnet_pair(0, 4, 3)
    _, target = _qnet_pair(1, 4, 3)
    s, a, r, s2, d = _port_batch(_batch(3, n=32, state_dim=4, n_act=3))
    q_on = pdqn.q_forward(online, s2)
    q_tg = pdqn.q_forward(target, s2)
    assert (q_on.argmax(1) != q_tg.argmax(1)).any()
    q_sa = pdqn.q_forward(online, s).gather(1, a[:, None])[:, 0]

    def loss_with(next_action):
        y = r + pdqn.GAMMA * q_tg.gather(1, next_action[:, None])[:, 0] \
            * (1.0 - d.float())
        return float(pdqn.huber(q_sa - y).mean())

    got = float(pdqn.dqn_loss(online, target, s, a, r, s2, d))
    assert got == pytest.approx(loss_with(q_on.argmax(1)), rel=1e-6)
    assert got != pytest.approx(loss_with(q_tg.argmax(1)), rel=1e-3)


def test_huber_matches_reference():
    x = np.linspace(-3, 3, 61).astype(np.float32)
    np.testing.assert_allclose(pdqn.huber(torch.as_tensor(x)).numpy(),
                               np.asarray(rdqn.huber(jnp.asarray(x))),
                               rtol=1e-6)


# ------------------------------------------------------- training loop
def _pool():
    return ppol.make_params_pool([pcm.CostModelParams()], device="cpu")


def test_target_sync_gated_on_gradient_steps():
    """The reference test's arithmetic: no sync during warmup, the first
    one TARGET_SYNC_EVERY gradient steps after updates begin."""
    n_envs, min_replay = 8, 64
    first_grad_iter = -(-min_replay // n_envs) - 1   # replay full here
    iterations = first_grad_iter + pdqn.TARGET_SYNC_EVERY + 14
    cfg = pdqn.DQNConfig(n_envs=n_envs, iterations=iterations,
                         min_replay=min_replay, eps_decay_iters=64, seed=0,
                         device="cpu")
    res = pdqn.train_dqn(cfg, psim.EnvConfig(schedule=0), _pool())
    synced = np.flatnonzero(res["metrics"]["synced"].numpy())
    grad_steps = res["metrics"]["grad_steps"].numpy()
    expected_iter = first_grad_iter + pdqn.TARGET_SYNC_EVERY - 1
    np.testing.assert_array_equal(synced, [expected_iter])
    assert grad_steps[expected_iter] == pdqn.TARGET_SYNC_EVERY
    assert res["grad_steps"] == iterations - first_grad_iter
    assert grad_steps[first_grad_iter - 1] == 0
    eps = res["metrics"]["eps"].numpy()
    assert eps[0] == 1.0 and eps[-1] == np.float32(pdqn.EPS_END)
    assert int(res["episodes"]) == int(res["metrics"]["episodes"][-1])


@pytest.mark.parametrize("env", [psim, ptab], ids=["analytic", "table"])
def test_training_is_bitwise_reproducible(env):
    """Same-seed train_dqn twice -> identical metrics and weights."""
    if env is ptab:
        rng = np.random.default_rng(0)
        tables = {k: rng.random((8, 4, 3)) * s for k, s in (
            ("miss_rows", 40), ("miss_active", 1), ("rebuild_rows", 800),
            ("rebuild_active", 1), ("hit", 1))}
        pool = ppol.make_params_pool([ptab.make_table_params(tables)],
                                     device="cpu")
    else:
        pool = _pool()
    cfg = pdqn.DQNConfig(n_envs=4, iterations=40, min_replay=16,
                         eps_decay_iters=20, seed=3, device="cpu")
    env_cfg = psim.EnvConfig(schedule=0, n_epochs=4, steps_per_epoch=32)
    r1 = pdqn.train_dqn(cfg, env_cfg, pool, env=env)
    r2 = pdqn.train_dqn(cfg, env_cfg, pool, env=env)
    for k in ("loss", "reward", "episodes"):
        assert torch.equal(r1["metrics"][k], r2["metrics"][k])
    for layer in r1["qnet"]:
        for k in r1["qnet"][layer]:
            assert torch.equal(r1["qnet"][layer][k], r2["qnet"][layer][k])
    assert int(r1["episodes"]) > 0
    assert not torch.equal(r1["qnet"]["l3"]["w"],
                           pdqn.init_qnet(torch.Generator().manual_seed(3),
                                          23, 32)["l3"]["w"])


@pytest.mark.parametrize("headroom", [False, True])
def test_state_size_follows_observe_headroom(headroom):
    """As the reference's ``train_dqn``: the env config's
    ``observe_headroom`` adds the state's trailing headroom entry, in the
    replay and the qnet's input."""
    from repro_torch.core import queue_sim as pqs

    env_cfg = pqs.QueueEnvConfig(n_epochs=2, steps_per_epoch=16,
                                 mem_budget_frac=0.3,
                                 observe_headroom=headroom)
    cfg = pdqn.DQNConfig(n_envs=2, iterations=3, min_replay=4,
                         eps_decay_iters=2, seed=0, device="cpu")
    res = pdqn.train_dqn(cfg, env_cfg, _pool(), env=pqs)
    dim = 23 + int(headroom)
    assert res["qnet"]["l1"]["w"].shape == (dim, pdqn.HIDDEN)
    assert rdqn.init_qnet(jax.random.PRNGKey(0), dim, 32)["l1"]["w"].shape \
        == res["qnet"]["l1"]["w"].shape
    assert np.all(np.isfinite(res["metrics"]["loss"].numpy()))


def test_train_dqn_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pdqn.train_dqn(pdqn.DQNConfig(iterations=1), psim.EnvConfig(),
                       _pool())


def _mean_energy(qnet_np, params, n_episodes, first_key):
    """Mean episode energy of a qnet's greedy policy through the
    REFERENCE's rollout, on held-out keys. Every episode runs to its end
    (W = 1 takes ``total_steps`` decisions): the rollout's default 1,024
    decisions would cut a small-window policy's episode short, and so
    its energy."""
    env_cfg = rsim.EnvConfig(schedule=0)
    qnet = jax.tree.map(jnp.asarray, qnet_np)
    out = []
    for s in range(n_episodes):
        r = rsim.rollout_policy(env_cfg, jax.random.PRNGKey(first_key + s),
                                params, rpol.dqn_policy(qnet),
                                max_decisions=env_cfg.total_steps)
        trace = r["trace"]
        assert float(jnp.sum(trace["window"] * trace["active"])) \
            >= env_cfg.total_steps
        out.append(float(r["total_energy"]))
    return float(np.mean(out))


def test_short_training_beats_the_fresh_qnet():
    """A short port training run (16 envs, 800 iterations) beats the
    fresh qnet on 4 held-out episodes, both rolled out by the reference."""
    cfg = pdqn.DQNConfig(n_envs=16, iterations=800, min_replay=256,
                         eps_decay_iters=400, seed=0, device="cpu")
    res = pdqn.train_dqn(cfg, psim.EnvConfig(schedule=0), _pool())
    fresh = convert.qnet_to_jax(pdqn.init_qnet(
        torch.Generator().manual_seed(99), 23, 32))
    trained = convert.qnet_to_jax(res["qnet"])
    params = rcm.CostModelParams()
    assert _mean_energy(trained, params, 4, 100) \
        < _mean_energy(fresh, params, 4, 100)


@pytest.mark.slow
def test_port_policy_within_5pct_of_a_reference_policy():
    """Same budget (16 envs, 1,500 iterations) in both packages; the
    port-trained policy's mean energy over 8 held-out episodes is within
    5% of the reference-trained one's (one-sided: not worse)."""
    params = rcm.CostModelParams()
    ref = rdqn.train_dqn(
        rdqn.DQNConfig(n_envs=16, iterations=1500, min_replay=256,
                       eps_decay_iters=800, seed=0),
        rsim.EnvConfig(schedule=0),
        jax.tree.map(lambda x: jnp.asarray(x)[None], params))
    port = pdqn.train_dqn(
        pdqn.DQNConfig(n_envs=16, iterations=1500, min_replay=256,
                       eps_decay_iters=800, seed=0, device="cpu"),
        psim.EnvConfig(schedule=0), _pool())
    e_ref = _mean_energy(_np_tree(ref["qnet"]), params, 8, 200)
    e_port = _mean_energy(convert.qnet_to_jax(port["qnet"]), params, 8, 200)
    assert e_port <= 1.05 * e_ref
