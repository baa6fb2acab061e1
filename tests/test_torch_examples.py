"""The port's examples (``repro_torch.examples``) against the reference's
``examples/``, on the CPU.

- quickstart: the energy-optimal windows equal the reference's, and the
  baselines' episode energies under the reference's own draws
  (``PRNGKey(0)``, replayed through ``ReferenceDraws`` with its noise
  jitted, within rtol 1e-6 of the eager draws) agree within rtol 1e-5
  (the simulator's float32 tensor laws; its DQN is not trained here);
- serve_lm: with the reference's weights and prompts carried across, the
  greedy ids are equal and the logits agree within atol/rtol 1e-4;
- train_distributed_gnn: the reference's script and the port's, 2 epochs
  of 4 steps under one seeded ``qnet_example``, the port's model started
  from the reference's parameters: digest-equal runs, losses within rtol
  1e-5, and the checkpoints equal byte for byte and read back bit for
  bit;
- congestion_adaptation_demo: the reference's script and the port's,
  digest-equal runs and the same printed table, with the heuristic on a
  fabric scenario and with the seeded qnet on the closed form.

No test trains a policy: the seeded qnet stands in the artifact
directory of both packages.
"""
import contextlib
import importlib.util
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import digest as dg
from repro.configs import qwen3_1p7b as rqwen
from repro.core import controller as rctl
from repro.core import cost_model as rcm
from repro.core import dqn as rdqn
from repro.core import policies as rpol
from repro.core import simulator as rsim
from repro.models.lm import transformer as rtf
from repro.train import gnn_trainer as rgt
from repro.train import policy as rpolicy
from repro_torch import convert
from repro_torch.configs import qwen3_1p7b as pqwen
from repro_torch.core import cost_model as pcm
from repro_torch.core import simulator as psim
from repro_torch.examples import congestion_adaptation_demo as pdemo
from repro_torch.examples import quickstart as pquick
from repro_torch.examples import serve_lm as pserve
from repro_torch.examples import train_distributed_gnn as ptdg
from repro_torch.train import checkpoint as pckpt
from repro_torch.train import gnn_trainer as pgt
from repro_torch.train import policy as ppolicy
from repro.core import domain_rand as rdr
from test_torch_simulator import ReferenceDraws
from _jax_release import release_jax_executables  # noqa: F401

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
ENERGY = dict(rtol=1e-5, atol=0.0)
DRAWS = dict(rtol=1e-6, atol=0.0)
LOGITS = dict(atol=1e-4, rtol=1e-4)
LOSSES = dict(rtol=1e-5, atol=0.0)


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(name, argv, monkeypatch):
    """The reference example's ``main`` under ``argv``: (its results in
    run order, what it printed)."""
    mod = _reference_example(name)
    runs = []
    run = rgt.run

    def recording(cfg, bundle=None):
        runs.append(run(cfg, bundle))
        return runs[-1]

    monkeypatch.setattr(rgt, "run", recording)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    monkeypatch.setattr(rgt, "run", run)
    return runs, out.getvalue()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A directory holding the seeded ``qnet_example``, in the npz format
    both packages read."""
    path = tmp_path_factory.mktemp("artifacts")
    qnet = rdqn.init_qnet(jax.random.PRNGKey(1), rctl.state_dim(3),
                          rctl.n_actions(3))
    rdqn.save_qnet(str(path / "qnet_example.npz"), qnet)
    return str(path)


@pytest.fixture
def seeded_policy(artifacts, monkeypatch):
    monkeypatch.setattr(rpolicy, "ARTIFACT_DIR", artifacts)
    monkeypatch.setattr(ppolicy, "ARTIFACT_DIR", artifacts)


# ---------------------------------------------------------------- quickstart
@jax.jit
def _split_keys(keys):
    k = jax.vmap(jax.random.split)(keys)
    return k[:, 0], k[:, 1]


@jax.jit
def _noise_of(k_obs):
    def one(ko):
        k_sig, k_e, k_h = jax.random.split(ko, 3)
        return (rdr.observation_noise(k_sig, (3,)),
                rdr.observation_noise(k_e, ()),
                rdr.observation_noise(k_h, (3,)))

    return jax.vmap(one)(k_obs)


class JittedReferenceDraws(ReferenceDraws):
    """``ReferenceDraws`` at 3 owners with its per-step key splits and
    noise jitted: the same draws, without an eager dispatch a decision."""

    def noise(self, cfg, n):
        assert cfg.n_owners == 3
        if self._reset_obs is not None:
            k_obs, self._reset_obs = self._reset_obs, None
        else:
            self.keys, k_obs = _split_keys(self.keys)
        return tuple(torch.as_tensor(np.array(x)) for x in _noise_of(k_obs))


def test_quickstart_optimal_windows():
    rparams = rcm.CostModelParams()
    got = pquick.optimal_windows(pcm.CostModelParams())
    for (delta, w, e), d in zip(got, pquick.DELTAS_MS):
        sigma = jnp.array([rcm.sigma_from_delta(rparams, d), 1.0, 1.0])
        rw, re = rcm.optimal_window(rparams, sigma)
        assert (delta, w, e) == (d, int(rw), float(re))


def test_jitted_draws_are_the_reference_draws():
    """To float32 rounding: jit fuses the noise's arithmetic."""
    cfg = psim.EnvConfig(schedule=1)
    key = jax.random.PRNGKey(0)[None]
    plain, jitted = ReferenceDraws(key), JittedReferenceDraws(key)
    plain.profile(cfg, 1)
    jitted.profile(cfg, 1)
    for _ in range(3):
        for a, b in zip(plain.noise(cfg, 1), jitted.noise(cfg, 1)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), **DRAWS)


def test_quickstart_baselines_on_the_reference_draws():
    """static W=16, RapidGNN's W=128, the heuristic and the oracle, each
    rolled out from the reference's ``PRNGKey(0)``."""
    rparams = rcm.CostModelParams()
    got = pquick.evaluate(
        pcm.CostModelParams(), None,
        lambda: JittedReferenceDraws(jax.random.PRNGKey(0)[None]), "cpu")
    ref_policies = {
        "static W=16 (w/o RL)": rpol.static_policy(16),
        "epoch-level (RapidGNN)": rpol.static_policy(128),
        "heuristic (Eq. 7)": rpol.heuristic_policy(rparams),
        "oracle": rpol.oracle_policy(rparams),
    }
    assert list(got) == list(ref_policies)
    for name, policy in ref_policies.items():
        out = rsim.rollout_policy(rsim.EnvConfig(schedule=1),
                                  jax.random.PRNGKey(0), rparams, policy)
        np.testing.assert_allclose(got[name], float(out["total_energy"]),
                                   **ENERGY, err_msg=name)


def test_quickstart_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pquick.main([])


# ------------------------------------------------------------------ serve_lm
@pytest.fixture
def one_thread():
    """Small tensors: torch's thread pool only adds wake-up latency."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serve_lm_ids_equal_the_reference(one_thread):
    """The reference example's weights (``PRNGKey(0)``) and prompts
    (``PRNGKey(1)``), its prefill-by-decode and its greedy loop."""
    rcfg = rqwen.make_smoke_config()
    params, _ = rtf.init(jax.random.PRNGKey(0), rcfg)
    b, p, g, m = (pserve.BATCH, pserve.PROMPT_LEN, pserve.GEN_LEN,
                  pserve.MAX_LEN)
    prompts = jax.random.randint(jax.random.PRNGKey(1), (b, p), 0,
                                 rcfg.vocab)
    decode = jax.jit(lambda pr, t, c, i: rtf.decode_step(pr, rcfg, t, c, i))
    cache = rtf.init_cache(rcfg, b, m)
    for i in range(p):
        logits, cache = decode(params, prompts[:, i:i + 1], cache,
                               jnp.asarray(i, jnp.int32))
    tokens = jnp.argmax(logits, axis=-1)[:, None]
    ids, seen = [tokens], [logits]
    for s in range(g - 1):
        logits, cache = decode(params, tokens, cache,
                               jnp.asarray(p + s, jnp.int32))
        tokens = jnp.argmax(logits, axis=-1)[:, None]
        ids.append(tokens)
        seen.append(logits)

    out = pserve.generate(
        convert.lm_params_from_jax(jax.tree.map(np.asarray, params)),
        pqwen.make_smoke_config(), np.array(prompts), g, m, "cpu")
    np.testing.assert_array_equal(out.ids.numpy(),
                                  np.asarray(jnp.concatenate(ids, axis=1)))
    np.testing.assert_allclose(out.logits.numpy(),
                               np.stack([np.asarray(x) for x in seen], 1),
                               **LOGITS)


# ----------------------------------------------------- train_distributed_gnn
def test_train_distributed_gnn_equals_the_reference(seeded_policy,
                                                    monkeypatch, tmp_path):
    ref_states, ref_init = [], rgt._init_model
    ref_step = rgt._model_step
    ref_params = []

    def init(graph, cfg):
        ref_states.append(ref_init(graph, cfg))
        ref_params.append(jax.tree.map(np.asarray,
                                       ref_states[-1]["params"]))
        return ref_states[-1]

    def step(state, mb):
        ref_states.append(ref_step(state, mb))
        return ref_states[-1]

    monkeypatch.setattr(rgt, "_init_model", init)
    monkeypatch.setattr(rgt, "_model_step", step)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    argv = ["--epochs", "2", "--steps", "4"]
    (ref,), _ = _run_reference("train_distributed_gnn",
                               argv + ["--ckpt-dir", str(ref_dir)],
                               monkeypatch)

    port_states, port_init = [], pgt._init_model

    def carried(graph, cfg, params=None):
        port_states.append(port_init(graph, cfg, params=ref_params[0]))
        return port_states[-1]

    monkeypatch.setattr(pgt, "_init_model", carried)
    with contextlib.redirect_stdout(io.StringIO()):
        port = ptdg.main(argv + ["--ckpt-dir", str(port_dir),
                                 "--device", "cpu"])
    dg.assert_results_equal(ref, port)
    assert len(port_states[0]["losses"]) == 8
    np.testing.assert_allclose(port_states[0]["losses"],
                               ref_states[-1]["losses"], **LOSSES)

    step_dir = "step_0000000002"
    names = sorted(os.listdir(ref_dir / step_dir))
    assert sorted(os.listdir(port_dir / step_dir)) == names
    for name in names:
        assert (port_dir / step_dir / name).read_bytes() \
            == (ref_dir / step_dir / name).read_bytes(), name
    want = ptdg.checkpoint_tree(port)
    back, at = pckpt.restore_checkpoint(
        str(ref_dir), {k: torch.zeros_like(v) for k, v in want.items()})
    assert at == 2
    for key, value in want.items():
        assert torch.equal(back[key], value), key


# ------------------------------------------------ congestion_adaptation_demo
@pytest.mark.parametrize("flags", [[], ["--rl", "--closed-form"]],
                         ids=["heuristic_fabric", "rl_closed_form"])
def test_congestion_demo_equals_the_reference(seeded_policy, monkeypatch,
                                              flags):
    argv = ["--epochs", "5", "--batch", "600"] + flags
    ref_runs, printed = _run_reference("congestion_adaptation_demo", argv,
                                       monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runs = pdemo.main(argv + ["--device", "cpu"])
    assert list(runs) == ["rapidgnn", "greendygnn" if flags else "heuristic"]
    for ref, port in zip(ref_runs, runs.values()):
        dg.assert_results_equal(ref, port)
    assert out.getvalue() == printed
