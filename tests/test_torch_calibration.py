"""The port's Algorithm-1 calibration and policy pipeline against the JAX
reference's, on the CPU.

Calibration is numpy on both sides over bit-equal substrates (the cache,
the fabric, the trainer's modeled lane), so every fit, table and
calibrated parameter set must be bit-equal. The policy module is checked
for its env registry, its artifact cache (a corrupt npz retrains, a good
one loads) and a short training run on the CPU.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core import calibration as rcal
from repro.core import cost_model as rcm
from repro.core import table_sim as rtab
from repro.train import gnn_trainer as rgt
from repro.train import policy as rpolicy
from repro_torch import envs as penvs
from repro_torch.core import calibration as pcal
from repro_torch.core import cost_model as pcm
from repro_torch.core import dqn as pdqn
from repro_torch.core import queue_sim as pqs
from repro_torch.core import simulator as psim
from repro_torch.core import table_sim as ptab
from repro_torch.envs import cluster_sim as pclu
from repro_torch.train import gnn_trainer as pgt
from repro_torch.train import policy as ppolicy
from _jax_release import release_jax_executables  # noqa: F401

SMALL = dict(method="static_w", batch_size=600, n_epochs=2,
             steps_per_epoch=4, seed=0)


@pytest.fixture(scope="module")
def bundles():
    ref_cfg = rgt.RunConfig(**SMALL)
    port_cfg = pgt.RunConfig(**SMALL, device="cpu")
    return (rgt.build_trace(ref_cfg), ref_cfg,
            pgt.build_trace(port_cfg), port_cfg)


def _synthetic_trace(seed=2, n_nodes=2000, steps=256):
    rng = np.random.default_rng(seed)
    owner_of = rng.integers(0, 3, n_nodes)
    perm = rng.permutation(n_nodes)
    batches = []
    for t in range(steps):
        if t % 8 == 0:
            perm = np.roll(perm, 29)
        ranks = rng.zipf(1.4, 64).clip(1, n_nodes) - 1
        batches.append(perm[ranks])
    return batches, owner_of


def _fields(x):
    return {k: (np.asarray(v) if not isinstance(v, (int, float)) else v)
            for k, v in dataclasses.asdict(x).items()}


def _assert_fields_equal(got, want):
    got, want = _fields(got), _fields(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


# ----------------------------------------------------------- the fits
def test_nelder_mead_bit_equal():
    def f(x):
        return float((1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2)

    for x0, it in (([-1.0, 1.0], 5000), ([2.0, -0.5], 300)):
        np.testing.assert_array_equal(
            pcal.nelder_mead(f, np.array(x0), max_iter=it),
            rcal.nelder_mead(f, np.array(x0), max_iter=it))


def test_fits_bit_equal():
    rng = np.random.default_rng(0)
    payload = 10 ** rng.uniform(3, 7, 400)
    delta = rng.choice([0.0, 2.0, 4.0, 6.0, 8.0], 400)
    rtt = 4.67e-3 + 1.40e-9 * payload + 2.01e-10 * payload * delta
    rtt *= 1 + 0.02 * rng.standard_normal(400)
    assert pcal.fit_rpc_model(payload, delta, rtt).__dict__ \
        == rcal.fit_rpc_model(payload, delta, rtt).__dict__
    w = np.array([1, 2, 4, 8, 16, 32, 64, 128], float)
    h = 0.35 + 0.6 / (1 + (w / 32) ** 1.25) + 0.01 * rng.random(8)
    assert pcal.fit_hit_rate(w, h).__dict__ == rcal.fit_hit_rate(w, h).__dict__
    t = 0.04 + 0.18 * w ** 0.62 + 0.001 * rng.random(8)
    assert pcal.fit_rebuild(w, t).__dict__ == rcal.fit_rebuild(w, t).__dict__
    edges = rng.integers(1000, 30000, 50).astype(float)
    step_s = 1e-3 + 2e-8 * edges + 1e-5 * rng.random(50)
    assert pcal.fit_compute_model(edges, step_s) \
        == rcal.fit_compute_model(edges, step_s)
    p_theta, p_fit = pcal.calibrate_compute(edges, step_s)
    r_theta, r_fit = rcal.calibrate_compute(edges, step_s)
    assert p_fit.__dict__ == r_fit.__dict__
    _assert_fields_equal(p_theta, r_theta)
    with pytest.raises(ValueError):
        pcal.calibrate_compute(edges, step_s[:3])


def test_fabric_rpc_sweep_bit_equal():
    """Phase 1 against the port's event fabric: the sweep and the refit
    of Eq. 4 equal the reference's, and recover the fabric's law."""
    pm, rm = (pcal.measure_fabric_rpc(pcm.CostModelParams()),
              rcal.measure_fabric_rpc(rcm.CostModelParams()))
    for k in rm:
        np.testing.assert_array_equal(pm[k], rm[k], err_msg=k)
    fit = pcal.calibrate_fabric_rpc(pcm.CostModelParams())
    assert fit.__dict__ == rcal.calibrate_fabric_rpc(
        rcm.CostModelParams()).__dict__
    assert fit.gamma_c == pytest.approx(pcm.PAPER_GAMMA_C, rel=1e-6)


def test_calibrate_on_synthetic_trace_bit_equal():
    batches, owner_of = _synthetic_trace()
    p_theta, p_diag = pcal.calibrate(batches, owner_of, 3, capacity=300)
    r_theta, r_diag = rcal.calibrate(batches, owner_of, 3, capacity=300)
    _assert_fields_equal(p_theta, r_theta)
    for k in r_diag["measurements"]:
        np.testing.assert_array_equal(p_diag["measurements"][k],
                                      r_diag["measurements"][k])
    assert p_diag["hit_fit"].__dict__ == r_diag["hit_fit"].__dict__


@pytest.mark.parametrize("n_owners", [1, 3])
def test_measure_table_bit_equal(n_owners):
    batches, owner_of = _synthetic_trace(seed=4, steps=96)
    owner_of = owner_of % n_owners
    got = ptab.measure_table(batches, owner_of, 300, n_owners)
    want = rtab.measure_table(batches, owner_of, 300, n_owners)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------- calibration on bundles
def test_calibrate_table_from_bundle_bit_equal(bundles):
    rb, rcfg, pb, pcfg = bundles
    got = ppolicy.calibrate_table_from_bundle(pb, pcfg)
    want = rpolicy.calibrate_table_from_bundle(rb, rcfg)
    _assert_fields_equal(got, want)
    assert float(got.miss_rows.sum()) > 0


def test_calibrate_from_bundle_bit_equal(bundles):
    """The (W, delta) stall grid runs the port's trainer: nine modeled
    runs whose times equal the reference's, so theta does too."""
    rb, rcfg, pb, pcfg = bundles
    p_theta, p_diag = ppolicy.calibrate_from_bundle(pb, pcfg)
    r_theta, r_diag = rpolicy.calibrate_from_bundle(rb, rcfg)
    _assert_fields_equal(p_theta, r_theta)
    assert p_diag["miss_grid"] == r_diag["miss_grid"]
    assert p_diag["t_miss0"] == r_diag["t_miss0"]


def test_params_pool_stacks_float32(bundles):
    _, _, pb, pcfg = bundles
    tables = ppolicy.calibrate_table_from_bundle(pb, pcfg)
    pool = ppolicy.make_params_pool([tables, tables], device="cpu")
    assert pool.miss_rows.shape == (2, ptab.N_W, 4, 3)
    assert pool.t_base.dtype == torch.float32 and pool.t_base.shape == (2,)
    ref = rpolicy.make_params_pool([rcm.CostModelParams()] * 2)
    got = ppolicy.make_params_pool([pcm.CostModelParams()] * 2,
                                   device="cpu")
    for k, v in dataclasses.asdict(ref).items():
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(v), err_msg=k)


# --------------------------------------------------------- policy module
def test_resolve_env_names_and_refusals():
    assert penvs.ENVS == ("analytic", "table", "queue", "cluster")
    assert ppolicy.resolve_env("analytic") is psim
    assert ppolicy.resolve_env("table") is ptab
    assert ppolicy.resolve_env(psim) is psim
    assert ppolicy.resolve_env(None, None) is psim
    tables = ptab.make_table_params(
        {k: np.zeros((8, 4, 3)) for k in ("miss_rows", "miss_active",
                                          "rebuild_rows", "rebuild_active",
                                          "hit")})
    assert ppolicy.resolve_env(None, tables) is ptab
    assert ppolicy.resolve_env("queue") is pqs
    assert ppolicy.resolve_env("cluster") is pclu
    with pytest.raises(ValueError, match="unknown training env"):
        ppolicy.resolve_env("nope")
    # refused before any training, as the reference refuses it
    with pytest.raises(ValueError, match="n_workers"):
        ppolicy.train_policy(None, env="cluster", n_workers=4, n_owners=2,
                             device="cpu")


def test_artifacts_cache_and_retrain_on_corrupt(tmp_path, monkeypatch):
    """A corrupt npz retrains and is rewritten; a good one loads without
    training; ``force`` retrains; named envs get their own artifact."""
    monkeypatch.setattr(ppolicy, "ARTIFACT_DIR", str(tmp_path))
    path = tmp_path / "qnet_test.npz"
    path.write_bytes(b"not an npz at all")
    qnet0 = pdqn.init_qnet(torch.Generator().manual_seed(0), 23, 32)
    calls = []

    def fake_train(pool, iterations=0, **kw):
        calls.append(kw)
        return {"qnet": qnet0, "episodes": torch.tensor(3), "grad_steps": 7,
                "metrics": {"reward": torch.zeros(4)}}

    monkeypatch.setattr(ppolicy, "train_policy", fake_train)
    q_fn, qnet = ppolicy.get_or_train_policy(None, name="qnet_test",
                                             iterations=1, device="cpu")
    assert len(calls) == 1 and calls[0]["device"] == "cpu"
    q_fn2, _ = ppolicy.get_or_train_policy(None, name="qnet_test",
                                           iterations=1, device="cpu")
    assert len(calls) == 1
    s = np.zeros(23, np.float32)
    np.testing.assert_array_equal(q_fn(s), q_fn2(s))
    ppolicy.get_or_train_policy(None, name="qnet_test", iterations=1,
                                device="cpu", force=True)
    assert len(calls) == 2
    ppolicy.get_or_train_policy(None, name="qnet_test", env="table",
                                iterations=1, device="cpu")
    assert (tmp_path / "qnet_test_table.npz").is_file()
    assert (tmp_path / "qnet_test_table.json").is_file()
    # the directory is the port's own: a reference npz is never read
    assert ppolicy.ARTIFACT_DIR != rpolicy.ARTIFACT_DIR


def test_default_artifact_dir_is_the_ports_own():
    assert os.path.normpath(ppolicy.ARTIFACT_DIR).endswith(
        os.path.join(".artifacts", "torch")) \
        or "REPRO_TORCH_ARTIFACTS" in os.environ


def test_get_or_train_policy_trains_on_the_cpu(tmp_path, monkeypatch):
    """A tiny real run through train_policy on the table env: the q_fn
    runs on the qnet's device and the summary records the run."""
    monkeypatch.setattr(ppolicy, "ARTIFACT_DIR", str(tmp_path))
    rng = np.random.default_rng(0)
    tables = {k: rng.random((8, 4, 3)) * s for k, s in (
        ("miss_rows", 40), ("miss_active", 1), ("rebuild_rows", 800),
        ("rebuild_active", 1), ("hit", 1))}
    pool = ppolicy.make_params_pool([ptab.make_table_params(tables)],
                                    device="cpu")
    q_fn, qnet = ppolicy.get_or_train_policy(
        pool, name="tiny", iterations=30, n_envs=4, n_epochs=2,
        device="cpu")
    assert qnet["l1"]["w"].device.type == "cpu"
    assert q_fn(np.zeros(23, np.float32)).shape == (32,)
    meta = json.loads((tmp_path / "tiny.json").read_text())
    assert meta["iterations"] == 30 and meta["grad_steps"] > 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        ppolicy.get_or_train_policy(pool, name="tiny")


def test_export_script_writes_the_ports_artifact(tmp_path):
    """``scripts/export_qnet_torch.py`` on the CPU at a tiny budget:
    calibrates, trains and writes ``<name>_table.npz`` under
    ``$REPRO_TORCH_ARTIFACTS``, loadable by the port."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, REPRO_TORCH_ARTIFACTS=str(tmp_path))
    out = subprocess.run(
        [sys.executable, os.path.join(root, "scripts", "export_qnet_torch.py"),
         "--device", "cpu", "--env", "table", "--name", "tiny",
         "--batch-sizes", "600", "--n-epochs", "2", "--iterations", "20"],
        capture_output=True, text=True, timeout=300, cwd=root, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    qnet = pdqn.load_qnet(str(tmp_path / "tiny_table.npz"))
    assert qnet["l3"]["w"].shape == (256, 32)
    assert "policy artifact ready" in out.stdout
