"""The port's trainer methods and refused configurations, on the CPU.

Each modeled run of a small trace must give the reference's
``result_digest``; the configurations later slices port must raise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import digest as dg
from repro.core import controller as rctl
from repro.core import dqn as rdqn
from repro.train import gnn_trainer as rgt
from repro_torch.core import dqn as pdqn
from repro_torch.store import MemoryBudget
from repro_torch.train import gnn_trainer as pgt


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


class TestRefused:
    """Configurations later slices port raise instead of running."""

    @pytest.mark.parametrize("override,exc", [
        (dict(method="heuristic"), NotImplementedError),
        (dict(scenario="clean"), NotImplementedError),
        (dict(async_pipeline=True), NotImplementedError),
        (dict(trace=True), NotImplementedError),
        (dict(run_model=True), NotImplementedError),
        (dict(grad_compression="int8", compute="measured"),
         NotImplementedError),
        (dict(grad_compression="zfp", compute="measured"), ValueError),
        (dict(compute="sampled"), ValueError),
        (dict(mem_budget=MemoryBudget(host_bytes=1e6)), NotImplementedError),
        (dict(method="greendygnn", q_fn=None), ValueError),
    ])
    def test_raises(self, override, exc):
        cfg = pgt.RunConfig(**dict(SWEEP, method="static_w", device="cpu"))
        cfg = dataclasses.replace(cfg, **override)
        with pytest.raises(exc):
            pgt.run(cfg)

    def test_cuda_requested_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = pgt.RunConfig(**dict(SWEEP, method="static_w"))
        assert cfg.device == "cuda"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pgt.run(cfg)
