"""The port's P=1 trainer against the JAX reference, end to end on the CPU.

The reference runs are built once per module: with device payloads each
one spends most of its time in the EmbeddingBag Pallas interpreter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import digest as dg
from repro.core import controller as rctl
from repro.core import dqn as rdqn
from repro.store import MemoryBudget as RefBudget
from repro.train import gnn_trainer as rgt
from repro.train.worker import TrainerWorker as RefWorker
from repro_torch.core import dqn as pdqn
from repro_torch.store import MemoryBudget
from repro_torch.train import gnn_trainer as pgt
from repro_torch.train.worker import TrainerWorker
from _jax_release import release_jax_executables  # noqa: F401

# the reference measurement the port is held to: 3 epochs of 4 steps,
# one warmup epoch, W=2 until the controller takes over
MOTIVATION = dict(method="greendygnn", batch_size=600, n_epochs=3,
                  warmup_epochs=1, steps_per_epoch=4, static_window=2)


def _drive(worker, cfg):
    """Drive a TrainerWorker the way ``gnn_trainer.run`` does."""
    for epoch in range(cfg.n_epochs):
        worker.begin_epoch(epoch)
        for step in range(cfg.steps_per_epoch):
            worker.step(epoch, step)
        worker.end_epoch(epoch)
    return worker.result()


@pytest.fixture(scope="module")
def qnet_npz(tmp_path_factory):
    qnet = rdqn.init_qnet(jax.random.PRNGKey(0), rctl.state_dim(3),
                          rctl.n_actions(3))
    path = str(tmp_path_factory.mktemp("qnet") / "qnet.npz")
    rdqn.save_qnet(path, qnet)
    fwd = jax.jit(rdqn.q_forward)

    def ref_q(state):
        return np.asarray(fwd(qnet, jnp.asarray(state, jnp.float32)))

    return ref_q, path


@pytest.fixture(scope="module")
def modeled_runs(qnet_npz):
    ref_q, path = qnet_npz
    cfg = rgt.RunConfig(**MOTIVATION, q_fn=ref_q,
                        mem_budget=RefBudget(device_payloads=True))
    ref = rgt.run(cfg, rgt.build_trace(cfg))
    pcfg = pgt.RunConfig(**MOTIVATION, q_fn=pdqn.q_fn_of(pdqn.load_qnet(path)),
                         mem_budget=MemoryBudget(device_payloads=True),
                         device="cpu")
    return ref, pgt.run(pcfg, pgt.build_trace(pcfg))


@pytest.fixture(scope="module")
def measured_runs():
    kw = dict(MOTIVATION, method="static_w", compute="measured")
    cfg = rgt.RunConfig(**kw, mem_budget=RefBudget(device_payloads=True))
    rw = RefWorker(cfg, rgt.build_trace(cfg))
    params = jax.tree.map(np.asarray, rw.engine.params)
    ref = _drive(rw, cfg)
    pcfg = pgt.RunConfig(**kw, mem_budget=MemoryBudget(device_payloads=True),
                         device="cpu")
    pw = TrainerWorker(pcfg, pgt.build_trace(pcfg))
    pw.engine.load_params(params)
    return ref, _drive(pw, pcfg)


@pytest.fixture(scope="module")
def measured_fabric_runs():
    """static_w, measured, over the paper schedule's fabric (its delta
    follows the step count, not the measured clock), the reference's
    parameters carried over."""
    kw = dict(MOTIVATION, method="static_w", compute="measured",
              scenario="paper_schedule", n_epochs=5, steps_per_epoch=2,
              warmup_epochs=1)
    cfg = rgt.RunConfig(**kw, mem_budget=RefBudget(device_payloads=False))
    rw = RefWorker(cfg, rgt.build_trace(cfg), fabric=_fabric(cfg, "ref"))
    params = jax.tree.map(np.asarray, rw.engine.params)
    ref = _drive(rw, cfg)
    pcfg = pgt.RunConfig(**kw, mem_budget=MemoryBudget(device_payloads=False),
                         device="cpu")
    pw = TrainerWorker(pcfg, pgt.build_trace(pcfg),
                       fabric=_fabric(pcfg, "port"))
    pw.engine.load_params(params)
    return ref, _drive(pw, pcfg)


def _fabric(cfg, side):
    from repro.net import build_scenario as ref_build
    from repro_torch.net import build_scenario as port_build

    build = ref_build if side == "ref" else port_build
    return build(cfg.scenario, params=cfg.params, n_owners=cfg.n_parts - 1,
                 seed=cfg.seed, n_epochs=cfg.n_epochs,
                 steps_per_epoch=cfg.steps_per_epoch)


class TestMeasuredUnderFabric:
    def test_discrete_streams_equal(self, measured_fabric_runs):
        ref, port = measured_fabric_runs
        for name in ("step_hits", "step_misses", "fetched_rows_by_owner",
                     "window_per_epoch", "hit_rate_per_epoch"):
            np.testing.assert_array_equal(getattr(port, name),
                                          getattr(ref, name), err_msg=name)
        # the schedule congests epochs 3 on: sigma above 1 there
        assert port.sigma_trace.shape == (5, 3)
        assert (port.sigma_trace[3] > 1).any()
        np.testing.assert_array_equal(port.sigma_trace, ref.sigma_trace)

    def test_losses_within_tolerance(self, measured_fabric_runs):
        ref, port = measured_fabric_runs
        np.testing.assert_allclose(port.compute_report["losses"],
                                   ref.compute_report["losses"], rtol=1e-4)
        assert port.compute_report["step_edges"] \
            == ref.compute_report["step_edges"]


class TestModeledGreenDyGNN:
    def test_result_digest_equal(self, modeled_runs):
        ref, port = modeled_runs
        dg.assert_results_equal(ref, port)

    def test_controller_took_over_after_warmup(self, modeled_runs):
        _, port = modeled_runs
        assert port.window_per_epoch[0] == 2.0
        assert list(port.window_per_epoch) == [2.0, 128.0, 128.0]

    def test_device_tier_counts_equal(self, modeled_runs):
        ref, port = modeled_runs
        assert port.tier_counts == ref.tier_counts
        assert port.tier_counts["device_hits"] > 0


class TestMeasuredStaticW:
    def test_discrete_streams_equal(self, measured_runs):
        ref, port = measured_runs
        for name in ("step_hits", "step_misses", "fetched_rows_by_owner",
                     "window_per_epoch", "hit_rate_per_epoch"):
            np.testing.assert_array_equal(getattr(port, name),
                                          getattr(ref, name), err_msg=name)
        assert port.compute_report["step_edges"] \
            == ref.compute_report["step_edges"]
        assert port.compute_report["n_steps"] == ref.compute_report["n_steps"]

    def test_losses_within_tolerance(self, measured_runs):
        ref, port = measured_runs
        np.testing.assert_allclose(port.compute_report["losses"],
                                   ref.compute_report["losses"], rtol=1e-4)

    def test_parity_and_timing_recorded(self, measured_runs):
        _, port = measured_runs
        rep = port.compute_report
        assert rep["parity_max_diff"] < 2e-3
        assert len(rep["step_s"]) == rep["n_steps"] == 12
        assert all(t > 0 for t in rep["step_s"])


def _drive_port(monkeypatch, warm: bool):
    """A measured static_w run of the port (MOTIVATION's steps, device
    payloads) with the untimed warm-up on or off: (its result, its engine,
    the shape signatures its steps prepared, in order)."""
    from repro_torch.train import compute as pcomp

    sigs = []
    prepare = pcomp.ComputeEngine.prepare

    def recorded(self, mb, key=None):
        layers, x_rows, n_edges = prepare(self, mb, key)
        sigs.append((x_rows,) + tuple(
            (int(layer["counts"].shape[0]), layer["fwd"].n_cols)
            for layer in layers))
        return layers, x_rows, n_edges

    monkeypatch.setattr(pcomp.ComputeEngine, "prepare", recorded)
    if not warm:
        monkeypatch.setattr(pcomp.ComputeEngine, "_warm_up",
                            lambda self, x_pad, layers: None)
    kw = dict(MOTIVATION, method="static_w", compute="measured")
    pcfg = pgt.RunConfig(**kw, mem_budget=MemoryBudget(device_payloads=True),
                         device="cpu")
    pw = TrainerWorker(pcfg, pgt.build_trace(pcfg))
    res = _drive(pw, pcfg)
    monkeypatch.undo()
    return res, pw.engine, sigs


class TestComputeWarmUp:
    """A new shape signature's untimed first run (the reference compiles
    it ahead of time) leaves the run's state and streams as they were."""

    def test_report_has_the_reference_keys(self, measured_runs):
        ref, port = measured_runs
        rep = port.compute_report
        assert set(ref.compute_report) <= set(rep)
        assert rep["agg_impl"] == "plain"
        assert rep["n_compiles"] >= 1 and rep["compile_s"] > 0.0
        assert rep["n_compiles"] == ref.compute_report["n_compiles"]

    def test_losses_params_and_streams_bit_equal(self, monkeypatch):
        on, engine_on, sigs = _drive_port(monkeypatch, warm=True)
        off, engine_off, _ = _drive_port(monkeypatch, warm=False)
        assert on.compute_report["losses"] == off.compute_report["losses"]
        assert on.compute_report["step_edges"] \
            == off.compute_report["step_edges"]
        for name in ("step_hits", "step_misses", "fetched_rows_by_owner"):
            np.testing.assert_array_equal(getattr(on, name),
                                          getattr(off, name))
        for layer, sub in engine_on.params.items():
            for k, v in sub.items():
                assert torch.equal(v, engine_off.params[layer][k]), (layer, k)
        for a, b in zip(engine_on.opt_state.mu["layer_1"].values(),
                        engine_off.opt_state.mu["layer_1"].values()):
            assert torch.equal(a, b)
        assert engine_on.opt_state.step == engine_off.opt_state.step == 12
        # one untimed run a distinct signature; none with it off
        assert engine_on.n_compiles == len(set(sigs)) >= 1
        assert engine_off.n_compiles == 0
        edges, secs = engine_on.calibration_samples()
        assert edges.dtype == secs.dtype == np.float64
        assert edges.tolist() == on.compute_report["step_edges"]
        assert secs.tolist() == on.compute_report["step_s"]
