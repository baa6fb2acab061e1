"""The port's trainer methods, scenarios, budgets and refused
configurations, on the CPU.

Each modeled run of a small trace must give the reference's
``result_digest``: every method over the closed form and over the event
fabric's scenarios, the heuristic among them, and budgeted host tiers
(with their ``tier_counts``); the configurations later slices port must
raise.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import digest as dg
from repro.core import controller as rctl
from repro.core import dqn as rdqn
from repro.graph import datasets as rds
from repro.store import MemoryBudget as RefBudget
from repro.train import gnn_trainer as rgt
from repro_torch.core import dqn as pdqn
from repro_torch.store import MemoryBudget
from repro_torch.train import gnn_trainer as pgt
from _jax_release import release_jax_executables  # noqa: F401


@pytest.fixture(scope="module")
def qnet_npz(tmp_path_factory):
    qnet = rdqn.init_qnet(jax.random.PRNGKey(1), rctl.state_dim(3),
                          rctl.n_actions(3))
    path = str(tmp_path_factory.mktemp("qnet") / "qnet.npz")
    rdqn.save_qnet(path, qnet)
    fwd = jax.jit(rdqn.q_forward)

    def ref_q(state):
        return np.asarray(fwd(qnet, jnp.asarray(state, jnp.float32)))

    return ref_q, path


SWEEP = dict(batch_size=600, n_epochs=2, steps_per_epoch=4,
             static_window=2, seed=1)

# the reference's modeled-lane pin (tests/test_compute.py::_PIN_CFG)
PIN_CFG = dict(method="static_w", dataset="reddit", batch_size=600,
               n_epochs=2, steps_per_epoch=8, scenario="clean", seed=0)
PIN_DIGEST = "04bf2d292b6290a0ada5117655575d508b78d3f2dee64ea93de3c24b15157ac4"

GRID_METHODS = ["dgl", "bgl", "rapidgnn", "static_w", "heuristic",
                "greendygnn"]
# "trace" replays a seeded delta-vs-time trace written by the fixture
# below (the committed results/traces/*.json are greentrace exports, which
# both sides refuse as delta traces: tests/test_torch_net.py)
GRID_SCENARIOS = ["clean", "paper_schedule", "bursty_markov", "incast",
                  "arch_switch", "trace"]


@pytest.fixture(scope="module")
def delta_trace(tmp_path_factory):
    rng = np.random.default_rng(21)
    t = np.concatenate([[0.0], np.cumsum(rng.uniform(0.005, 0.03, 39))])
    d = (rng.random((40, 3)) < 0.4) * rng.uniform(2.0, 25.0, (40, 3))
    path = tmp_path_factory.mktemp("trace") / "hot_owner_delta.json"
    path.write_text(json.dumps({"time_s": t.tolist(),
                                "delta_ms": d.tolist()}))
    return f"trace:{path}"


def _both(kw, ref_q=None, port_q=None, ref_budget=None, port_budget=None):
    cfg = rgt.RunConfig(**kw, q_fn=ref_q, mem_budget=ref_budget)
    pcfg = pgt.RunConfig(**kw, q_fn=port_q, mem_budget=port_budget,
                         device="cpu")
    return (rgt.run(cfg, rgt.build_trace(cfg)),
            pgt.run(pcfg, pgt.build_trace(pcfg)))


class TestMethods:
    @pytest.mark.parametrize("method", ["dgl", "bgl", "rapidgnn", "static_w"])
    @pytest.mark.parametrize("congested", [True, False])
    def test_modeled_digest_equal(self, method, congested):
        kw = dict(SWEEP, method=method, congested=congested)
        if congested:
            kw["fixed_delta_ms"] = (4.0, 0.0, 12.5)
        cfg = rgt.RunConfig(**kw)
        pcfg = pgt.RunConfig(**kw, device="cpu")
        dg.assert_results_equal(rgt.run(cfg, rgt.build_trace(cfg)),
                                pgt.run(pcfg, pgt.build_trace(pcfg)))

    def test_nocw_keeps_uniform_allocation(self, qnet_npz):
        ref_q, path = qnet_npz
        kw = dict(SWEEP, method="greendygnn_nocw", warmup_epochs=1)
        cfg = rgt.RunConfig(**kw, q_fn=ref_q)
        pcfg = pgt.RunConfig(**kw, q_fn=pdqn.q_fn_of(pdqn.load_qnet(path)),
                             device="cpu")
        dg.assert_results_equal(rgt.run(cfg, rgt.build_trace(cfg)),
                                pgt.run(pcfg, pgt.build_trace(pcfg)))


class TestScenarios:
    """Every method over the event fabric's scenarios, modeled lane."""

    @pytest.mark.parametrize("scenario", GRID_SCENARIOS)
    @pytest.mark.parametrize("method", GRID_METHODS)
    def test_modeled_digest_equal(self, method, scenario, qnet_npz,
                                  delta_trace):
        ref_q, path = qnet_npz
        if scenario == "trace":
            scenario = delta_trace
        kw = dict(SWEEP, method=method, scenario=scenario, warmup_epochs=1)
        q = (ref_q, pdqn.q_fn_of(pdqn.load_qnet(path))) \
            if method == "greendygnn" else (None, None)
        ref, port = _both(kw, *q)
        dg.assert_results_equal(ref, port)
        assert port.scenario == scenario
        # a fabric run logs the epoch's mean sigma, one row per epoch
        assert port.sigma_trace.shape == (SWEEP["n_epochs"], 3)

    def test_pin_cfg_digest(self):
        """The reference's P=1 pin through the port: static_w on reddit
        over the clean fabric."""
        cfg = pgt.RunConfig(**PIN_CFG, device="cpu")
        assert dg.result_digest(pgt.run(cfg, pgt.build_trace(cfg))) \
            == PIN_DIGEST

    def test_closed_form_spec_is_the_analytic_path(self):
        ref, port = _both(dict(SWEEP, method="heuristic",
                               scenario="closed_form",
                               fixed_delta_ms=(4.0, 0.0, 12.5)))
        dg.assert_results_equal(ref, port)
        assert port.scenario == "closed_form"


class TestBudgetedHostTier:
    """A budgeted host tier (the reference's out-of-core configuration):
    equal digests and ``tier_counts``."""

    @pytest.mark.parametrize("device_payloads", [False, True],
                             ids=["host_only", "device_payloads"])
    def test_ooc_community_tier_counts_equal(self, device_payloads):
        graph = rds.materialize("ooc_community", seed=0)
        host = 0.3 * graph.n_nodes * graph.feature_source.n_feat * 4
        kw = dict(SWEEP, method="static_w", dataset="ooc_community",
                  scenario="clean")
        ref, port = _both(
            kw, ref_budget=RefBudget(host_bytes=host, chunk_rows=256,
                                     device_payloads=device_payloads),
            port_budget=MemoryBudget(host_bytes=host, chunk_rows=256,
                                     device_payloads=device_payloads))
        dg.assert_results_equal(ref, port)
        assert port.tier_counts == ref.tier_counts
        tc = port.tier_counts
        assert tc["block_fetches"] > 0 and tc["evictions"] > 0
        assert (tc["device_hits"] > 0) == device_payloads
        assert (tc["peak_resident_bytes"] <= host
                or tc["pinned_over_budget"] > 0)

    @pytest.mark.parametrize("method,scenario", [
        ("heuristic", "paper_schedule"), ("rapidgnn", None),
        ("dgl", "bursty_markov"),
    ])
    def test_in_ram_budget_digest_equal(self, method, scenario):
        host = 0.2 * 24_000 * 64 * 4        # reddit stand-in's matrix
        kw = dict(SWEEP, method=method, scenario=scenario, warmup_epochs=1)
        ref, port = _both(
            kw, ref_budget=RefBudget(host_bytes=host, chunk_rows=256,
                                     device_payloads=False),
            port_budget=MemoryBudget(host_bytes=host, chunk_rows=256,
                                     device_payloads=False))
        dg.assert_results_equal(ref, port)
        assert port.tier_counts == ref.tier_counts

    def test_heuristic_observes_headroom(self):
        """With a budgeted tier the controller's state carries the
        headroom entry (state_dim + 1), as the reference's."""
        from repro_torch.train.worker import TrainerWorker

        host = 0.2 * 24_000 * 64 * 4
        cfg = pgt.RunConfig(**dict(SWEEP, method="heuristic",
                                   warmup_epochs=1),
                            mem_budget=MemoryBudget(host_bytes=host,
                                                    chunk_rows=256),
                            device="cpu")
        w = TrainerWorker(cfg, pgt.build_trace(cfg))
        assert w.tiered and w.controller.observe_headroom
        for e in range(cfg.n_epochs):
            w.begin_epoch(e)
            for s in range(cfg.steps_per_epoch):
                w.step(e, s)
            w.end_epoch(e)
        assert w.controller.last_state.shape == (rctl.state_dim(3) + 1,)
        assert 0.0 <= w.controller.last_state[-1] <= 1.0


class TestRefused:
    """Configurations later slices port raise instead of running."""

    @pytest.mark.parametrize("override,exc", [
        (dict(grad_compression="zfp", compute="measured"), ValueError),
        (dict(grad_compression="zfp"), ValueError),
        (dict(compute="sampled"), ValueError),
        (dict(method="greendygnn", q_fn=None), ValueError),
        (dict(scenario="no_such_scenario"), KeyError),
    ])
    def test_raises(self, override, exc):
        cfg = pgt.RunConfig(**dict(SWEEP, method="static_w", device="cpu"))
        cfg = dataclasses.replace(cfg, **override)
        with pytest.raises(exc):
            pgt.run(cfg)

    @pytest.mark.parametrize("override", [
        # seed 0: under seed 1 a batch's seeds repeat a node, and both
        # packages' model step fails on its labels/logits mismatch
        dict(run_model=True, seed=0),
        dict(grad_compression="int8", compute="measured"),
        dict(grad_compression="topk", compute="measured", topk_frac=0.25),
        dict(grad_compression="topk"),
    ], ids=["run_model", "int8", "topk_measured", "topk_modeled"])
    def test_once_refused_runs(self, override):
        """The modeled-lane model and the compressed schemes, once refused
        here, run: the model logs an accuracy per epoch, a compressed
        measured run its scheme's wire bytes."""
        cfg = pgt.RunConfig(**dict(SWEEP, method="static_w", device="cpu"))
        res = pgt.run(dataclasses.replace(cfg, **override))
        assert len(res.step_hits) == cfg.n_epochs * cfg.steps_per_epoch
        if override.get("run_model"):
            assert res.accuracy_per_epoch.shape == (cfg.n_epochs,)
        rep = res.compute_report
        if rep is not None:
            from repro_torch.graph import datasets
            from repro_torch.train.compute import model_wire_bytes

            graph = datasets.materialize(cfg.dataset, seed=0)
            scheme = override["grad_compression"]
            assert rep["grad_compression"] == scheme
            assert rep["sync_wire_bytes"] == model_wire_bytes(
                graph, scheme, override.get("topk_frac", 0.05)) \
                < model_wire_bytes(graph)

    def test_trace_runs(self):
        """``trace=True``, once refused here, traces: the payload is the
        reference's in canonical JSON and reconciles bit for bit."""
        from repro.obs import dumps_canonical as ref_dumps
        from repro_torch.obs import dumps_canonical, reconcile

        kw = dict(SWEEP, method="static_w", trace=True)
        port = pgt.run(pgt.RunConfig(**kw, device="cpu"))
        ref = rgt.run(rgt.RunConfig(**kw))
        assert dumps_canonical(port.trace) == ref_dumps(ref.trace)
        assert reconcile(port.trace)[0]["gpu_j"] == port.meter.gpu_j

    def test_async_pipeline_runs(self):
        """``async_pipeline=True``, once refused here, runs: the threaded
        builder and prefetcher, with a measured pipeline report."""
        cfg = pgt.RunConfig(**dict(SWEEP, method="static_w", device="cpu"),
                            async_pipeline=True)
        res = pgt.run(cfg)
        assert res.pipeline is not None and res.pipeline.n_rebuilds > 0
        assert len(res.step_hits) == cfg.n_epochs * cfg.steps_per_epoch

    def test_cuda_requested_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = pgt.RunConfig(**dict(SWEEP, method="static_w"))
        assert cfg.device == "cuda"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pgt.run(cfg)
