"""The port's host-side modules against the JAX reference, on the CPU.

Where both sides compute in numpy (graph substrate, cost laws, energy,
closed-form fetch laws) they must agree bit for bit; the float32 host
quantities the reference computes in jnp (sigma, the paper schedule, the
controller's state and action codec) must agree bit for bit too. Float
kernels (the SAGE step, the qnet) agree within stated tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.analysis import digest as dg
from repro.core import controller as rctl
from repro.core import cost_model as rcm
from repro.core import domain_rand as rdr
from repro.core import dqn as rdqn
from repro.core.energy import EnergyMeter as RefMeter
from repro.core.energy import StepSample as RefSample
from repro.models.gnn.common import cross_entropy as ref_cross_entropy
from repro.train import compute as rcompute
from repro.train import gnn_trainer as rgt
from repro_torch import convert
from repro_torch.core import controller as pctl
from repro_torch.core import cost_model as pcm
from repro_torch.core import domain_rand as pdr
from repro_torch.core import dqn as pdqn
from repro_torch.core.energy import EnergyMeter, StepSample
from repro_torch.optim import optimizers as poptim
from repro_torch.train import compute as pcompute
from repro_torch.train import gnn_trainer as pgt
from _jax_release import release_jax_executables  # noqa: F401

SMALL = dict(method="static_w", batch_size=600, n_epochs=2,
             steps_per_epoch=4, seed=0)


@pytest.fixture(scope="module")
def bundles():
    ref = rgt.build_trace(rgt.RunConfig(**SMALL))
    port = pgt.build_trace(pgt.RunConfig(**SMALL, device="cpu"))
    return ref, port


# ------------------------------------------------------------- substrate
class TestGraphSubstrate:
    def test_graph_and_partition_digest_equal(self, bundles):
        (rg, ro, _, _), (pg, po, _, _) = bundles

        def surface(g, owner):
            return {"edge_index": g.edge_index, "features": g.features,
                    "labels": g.labels, "n_nodes": int(g.n_nodes),
                    "owner": owner}

        assert dg.digest(surface(pg, po)) == dg.digest(surface(rg, ro))

    def test_trace_bundle_digest_equal(self, bundles):
        (_, _, rt, rm), (_, _, pt, pm) = bundles
        assert dg.digest(pt) == dg.digest(rt)
        assert dg.digest(pm) == dg.digest(rm)

    def test_same_seed_same_bundle(self, bundles):
        again = pgt.build_trace(pgt.RunConfig(**SMALL, device="cpu"))
        assert dg.digest(again[2:]) == dg.digest(bundles[1][2:])


# ------------------------------------------------------------ cost laws
class TestCostLaws:
    def test_params_defaults_equal(self):
        ref, port = rcm.CostModelParams(), pcm.CostModelParams()
        for name in ref.__dataclass_fields__:
            assert getattr(port, name) == getattr(ref, name), name
        assert pcm.WINDOW_CHOICES == rcm.WINDOW_CHOICES
        assert pcm.PROP_RTT_BULK_S_PER_MS == rcm.PROP_RTT_BULK_S_PER_MS
        assert pcm.PROP_RTT_CHUNKED_S_PER_MS == rcm.PROP_RTT_CHUNKED_S_PER_MS

    def test_rpc_and_compute_laws_bit_equal(self):
        p = rcm.CostModelParams()
        rng = np.random.default_rng(0)
        payload = rng.uniform(0, 1e6, 64)
        delta = rng.uniform(0, 50, 64).astype(np.float32)
        args = (float(p.alpha_rpc), float(p.beta), float(p.gamma_c),
                payload, delta)
        np.testing.assert_array_equal(pcm.rpc_wall_s(*args),
                                      rcm.rpc_wall_s(*args))
        np.testing.assert_array_equal(pcm.rpc_cpu_s(*args),
                                      rcm.rpc_cpu_s(*args))
        np.testing.assert_array_equal(
            pcm.compute_step_s(1e-3, 2e-9, payload),
            rcm.compute_step_s(1e-3, 2e-9, payload),
        )

    @pytest.mark.parametrize("delta", [0.0, 2.0, 4.0, 17.5, 25.0, 40.0,
                                       np.float32(12.25), 1e-3])
    def test_sigma_from_delta_float32_bit_equal(self, delta):
        p = rcm.CostModelParams()
        got = pcm.sigma_from_delta(pcm.CostModelParams(), delta)
        want = np.asarray(rcm.sigma_from_delta(p, delta))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)

    def test_paper_schedule_bit_equal_not_the_float64_twin(self):
        hit_float64_gap = False
        for n_epochs in (3, 12, 30):
            for epoch in range(n_epochs):
                got = pdr.paper_schedule_delta(epoch, n_epochs, 3)
                want = np.asarray(rdr.paper_schedule_delta(epoch, n_epochs, 3))
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
                twin = rdr.paper_schedule_delta_np(epoch, n_epochs, 3)
                hit_float64_gap |= not np.array_equal(got, twin)
        assert hit_float64_gap  # e.g. 0.7 * 17.5 rounds differently

    def test_closed_form_fetch_laws_bit_equal(self):
        p = rcm.CostModelParams()
        rng = np.random.default_rng(1)
        for _ in range(20):
            rows = rng.integers(0, 3000, 3).astype(np.float64)
            delta = np.asarray(rdr.paper_schedule_delta(5, 30, 3))
            assert pgt._fetch_time(p, rows, delta, 256.0) \
                == rgt._fetch_time(p, rows, delta, 256.0)
            assert pgt._chunked_fetch_time(p, rows, delta, 256.0, 512, 2) \
                == rgt._chunked_fetch_time(p, rows, delta, 256.0, 512, 2)

    def test_meter_totals_bit_equal_over_a_sample_stream(self):
        rng = np.random.default_rng(2)
        ref, port = RefMeter(rcm.CostModelParams()), \
            EnergyMeter(pcm.CostModelParams())
        for i in range(200):
            s = dict(t_compute=float(rng.uniform(0, 0.02)),
                     t_stall=float(rng.uniform(0, 0.05)),
                     t_cpu_comm=float(rng.uniform(0, 0.03)),
                     remote_bytes=float(rng.uniform(0, 1e6)),
                     n_rpcs=int(rng.integers(0, 4)),
                     gpu_overlap=float(rng.choice([0.0, 0.75])))
            ref.record_step(RefSample(**s))
            port.record_step(StepSample(**s))
            if i % 7 == 0:
                ref.record_background(s["t_cpu_comm"], 1e5, 3)
                port.record_background(s["t_cpu_comm"], 1e5, 3)
            if i % 50 == 49:
                ref.mark_epoch()
                port.mark_epoch()
        assert port.totals_kj() == ref.totals_kj()
        np.testing.assert_array_equal(port.cumulative_kj(),
                                      ref.cumulative_kj())


# ------------------------------------------- Eq. 3, Eq. 4 and Fig. 1
def _param_pair(seed: int):
    """The default parameters (seed 0) or a seeded draw around them, as
    the reference's and the port's parameter sets."""
    if seed == 0:
        return rcm.CostModelParams(), pcm.CostModelParams()
    rng = np.random.default_rng(seed)
    kw = {name: float(getattr(rcm.CostModelParams(), name)
                      * rng.uniform(0.5, 2.0))
          for name in ("alpha_rpc", "beta", "gamma_c", "t_miss0",
                       "feature_bytes", "p_cpu_rpc")}
    return rcm.CostModelParams(**kw), pcm.CostModelParams(**kw)


class TestEq3Eq4Fig1:
    """``rpc_time``, ``congested_miss_latency`` and
    ``rpc_energy_breakdown`` bit-equal to the reference's, then the
    reference's own cases on the port."""

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_bit_equal_on_a_seeded_grid(self, seed):
        ref, port = _param_pair(seed)
        rng = np.random.default_rng(100 + seed)
        n_nodes = np.concatenate([
            rng.uniform(0, 1e5, 64), rng.integers(0, 5000, 64),
            [0.0, 1.0, 10.0, 1000.0, 50_000.0]]).astype(np.float32)
        delta = rng.uniform(0, 50, n_nodes.shape).astype(np.float32)
        got = pcm.rpc_time(port, n_nodes, delta)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(
            got, np.asarray(rcm.rpc_time(ref, n_nodes, delta)))
        for want, have in zip(rcm.rpc_energy_breakdown(ref, n_nodes),
                              pcm.rpc_energy_breakdown(port, n_nodes)):
            assert have.dtype == np.float32
            np.testing.assert_array_equal(have, np.asarray(want))
        for n_owners in (1, 3, 7):
            sigma = rng.uniform(1.0, 8.0, (64, n_owners)).astype(np.float32)
            got = pcm.congested_miss_latency(port, sigma)
            assert got.dtype == np.float32 and got.shape == (64,)
            np.testing.assert_array_equal(
                got, np.asarray(rcm.congested_miss_latency(ref, sigma)))

    def test_scalars_bit_equal(self):
        ref, port = _param_pair(0)
        for n, d in ((1000.0, 0.0), (2000.0, 0.0), (1000.0, 5.0), (3, 2)):
            assert pcm.rpc_time(port, n, d) == \
                np.asarray(rcm.rpc_time(ref, n, d))
            for want, have in zip(rcm.rpc_energy_breakdown(ref, n),
                                  pcm.rpc_energy_breakdown(port, n)):
                assert have == np.asarray(want)

    def test_exported_from_core(self):
        import repro_torch.core as core

        assert core.rpc_time is pcm.rpc_time
        assert core.congested_miss_latency is pcm.congested_miss_latency
        assert core.rpc_energy_breakdown is pcm.rpc_energy_breakdown

    # the reference's cases (tests/test_cost_model.py), on the port
    def test_straggler_max_semantics(self):
        """Eq. (3): only the worst link matters for the miss latency."""
        params = pcm.CostModelParams()
        t_lo = float(pcm.congested_miss_latency(params, [1.0, 1.0, 1.0]))
        t_hi = float(pcm.congested_miss_latency(params, [3.0, 1.0, 1.0]))
        t_hi2 = float(pcm.congested_miss_latency(params, [3.0, 2.0, 1.0]))
        assert t_hi == pytest.approx(3 * t_lo)
        assert t_hi2 == pytest.approx(t_hi)

    def test_initiation_dominates_at_gnn_sizes(self):
        """Fig. 1: at 10-100 remote nodes, initiation is 90-99% of
        energy."""
        params = pcm.CostModelParams()
        for n in [10, 50, 100]:
            e_init, e_pay = pcm.rpc_energy_breakdown(params, float(n))
            share = float(e_init / (e_init + e_pay))
            assert share > 0.89, (n, share)

    def test_payload_dominates_past_10k(self):
        e_init, e_pay = pcm.rpc_energy_breakdown(pcm.CostModelParams(),
                                                 50_000.0)
        assert float(e_pay) > float(e_init)

    def test_crossover_near_1000_plus(self):
        """Paper: crossover does not occur until batch > ~1000 nodes."""
        e_init, e_pay = pcm.rpc_energy_breakdown(pcm.CostModelParams(),
                                                 1000.0)
        assert float(e_init) > 0.4 * (float(e_init) + float(e_pay))

    def test_rpc_time_linear_in_payload_and_delta(self):
        params = pcm.CostModelParams()
        t0 = float(pcm.rpc_time(params, 1000.0, 0.0))
        t1 = float(pcm.rpc_time(params, 2000.0, 0.0))
        t2 = float(pcm.rpc_time(params, 1000.0, 5.0))
        assert t1 > t0 and t2 > t0


# ------------------------------------------------------------ controller
@pytest.fixture(scope="module")
def shared_qnet(tmp_path_factory):
    qnet = rdqn.init_qnet(jax.random.PRNGKey(3), rctl.state_dim(3),
                          rctl.n_actions(3))
    path = str(tmp_path_factory.mktemp("qnet") / "qnet.npz")
    rdqn.save_qnet(path, qnet)
    return qnet, path


def _recorded_stats(rng):
    return dict(
        owner_hit_rates=rng.uniform(0, 1, 3),
        global_hit_rate=float(rng.uniform(0, 1)),
        t_step=float(rng.uniform(5e-3, 0.2)),
        f_rebuild=float(rng.uniform(0, 0.3)),
        f_miss=float(rng.uniform(0, 0.8)),
        e_step=float(rng.uniform(1, 80)),
        e_baseline=float(rng.uniform(1, 80)),
        batches_remaining=float(rng.uniform(0, 1)),
    )


class TestController:
    def test_action_codec_bit_equal(self):
        for n_owners in (1, 2, 3):
            for a in range(rctl.n_actions(n_owners)):
                rw, rweights = rctl.decode_action(jnp.asarray(a), n_owners)
                pw, pweights = pctl.decode_action(a, n_owners)
                assert float(pw) == float(rw)
                assert pweights.dtype == np.float32
                np.testing.assert_array_equal(pweights, np.asarray(rweights))
            assert pctl.state_dim(n_owners) == rctl.state_dim(n_owners)
            assert pctl.n_actions(n_owners) == rctl.n_actions(n_owners)

    def test_eq8_inversion_bit_equal(self):
        p = rcm.CostModelParams()
        ratios = np.concatenate([
            np.linspace(0.5, 12.0, 301), [1.1, 1.0999999, 1.1000001],
        ]).astype(np.float32)
        got = pctl.sigma_from_fetch_ratio(ratios, pcm.CostModelParams())
        want = np.asarray(jax.vmap(
            lambda r: rctl.sigma_from_fetch_ratio(r, p)
        )(jnp.asarray(ratios)))
        np.testing.assert_array_equal(got, want)

    def test_decisions_match_over_recorded_stats(self, shared_qnet):
        qnet, path = shared_qnet
        fwd = jax.jit(rdqn.q_forward)

        def ref_q(s):
            return np.asarray(fwd(qnet, jnp.asarray(s, jnp.float32)))

        port_q = pdqn.q_fn_of(pdqn.load_qnet(path))
        ref = rctl.AdaptiveController(ref_q, rcm.CostModelParams(), 3)
        port = pctl.AdaptiveController(port_q, pcm.CostModelParams(), 3)
        rng = np.random.default_rng(11)
        for _ in range(120):  # warmup fetch-time observations
            o, t = int(rng.integers(0, 3)), float(rng.uniform(1e-3, 3e-3))
            ref.deque.append(o, t)
            port.deque.append(o, t)
        ref.observe_warmup()
        port.observe_warmup()
        actions = set()
        for i in range(60):
            for _ in range(int(rng.integers(1, 12))):  # congested owners
                o = int(rng.integers(0, 3))
                t = float(rng.uniform(1e-3, 3e-3) * (1 + 3 * (o == i % 3)))
                ref.deque.append(o, t)
                port.deque.append(o, t)
            s = _recorded_stats(rng)
            rw, rweights, ra = ref.decide(rctl.ControllerStats(**s))
            pw, pweights, pa = port.decide(pctl.ControllerStats(**s))
            np.testing.assert_array_equal(port.last_sigma, ref.last_sigma)
            np.testing.assert_array_equal(port.last_state, ref.last_state)
            q_ref = ref_q(ref.last_state)
            np.testing.assert_allclose(
                port_q(port.last_state), q_ref, rtol=1e-5,
                atol=1e-5 * float(np.abs(q_ref).max()),
            )
            assert (pw, pa) == (rw, ra)
            np.testing.assert_array_equal(pweights, rweights)
            actions.add(pa)
        assert len(actions) > 1  # the sweep exercises several actions


# ------------------------------------------------------------------- dqn
class TestQnet:
    def test_npz_layout_round_trips_both_ways(self, shared_qnet, tmp_path):
        qnet, path = shared_qnet
        port = pdqn.load_qnet(path)
        for layer in qnet:
            for name in qnet[layer]:
                np.testing.assert_array_equal(port[layer][name].numpy(),
                                              np.asarray(qnet[layer][name]))
        out = str(tmp_path / "port.npz")
        pdqn.save_qnet(out, port)
        back = rdqn.load_qnet(out)
        assert dg.digest(jax.tree.map(np.asarray, back)) \
            == dg.digest(jax.tree.map(np.asarray, qnet))
        carried = convert.qnet_from_jax(jax.tree.map(np.asarray, qnet))
        assert dg.digest(convert.qnet_to_jax(carried)) \
            == dg.digest(jax.tree.map(np.asarray, qnet))

    def test_init_shapes_and_seeded(self):
        g = torch.Generator().manual_seed(0)
        q = pdqn.init_qnet(g, 23, 32)
        assert q["l1"]["w"].shape == (23, 256) and q["l3"]["b"].shape == (32,)
        q2 = pdqn.init_qnet(torch.Generator().manual_seed(0), 23, 32)
        assert torch.equal(q["l2"]["w"], q2["l2"]["w"])
        std = float(q["l2"]["w"].std())
        assert abs(std - (2.0 / 256) ** 0.5) < 0.01


# ------------------------------------------------------- measured step
@pytest.fixture(scope="module")
def engines(bundles):
    """Reference and port engines on the same batch, same parameters."""
    (graph, _, _, mbs), (pgraph, _, _, pmbs) = bundles
    cfg = rgt.RunConfig(**SMALL, compute="measured")
    ref = rcompute.ComputeEngine(graph, cfg)
    port = pcompute.ComputeEngine(
        pgraph, pgt.RunConfig(**SMALL, compute="measured", device="cpu")
    )
    port.load_params(jax.tree.map(np.asarray, ref.params))
    mb, pmb = mbs[0][0], pmbs[0][0]
    x_in = np.asarray(graph.features[mb.input_nodes], np.float32)
    return ref, port, mb, pmb, x_in


class TestComputeStep:
    def test_one_step_loss_and_gradients(self, engines):
        ref, port, mb, pmb, x_in = engines
        layers, x_rows, _ = ref.prepare(mb)
        last = layers[-1]
        x_pad = jnp.asarray(ref.pad_input(x_in, x_rows))

        def loss_fn(p):
            logits = ref._forward(p, x_pad, layers)
            return ref_cross_entropy(logits, last["labels"], last["lmask"])

        r_loss, r_grads = jax.value_and_grad(loss_fn)(ref.params)
        p_layers, p_rows, _ = port.prepare(pmb)
        assert p_rows == x_rows
        p_loss, p_grads = port.loss_and_grads(
            port.pad_input(x_in, p_rows), p_layers
        )
        np.testing.assert_allclose(float(p_loss), float(r_loss), rtol=1e-5)
        for layer, sub in r_grads.items():
            for name, g in sub.items():
                g = np.asarray(g)
                np.testing.assert_allclose(
                    p_grads[layer][name].numpy(), g, rtol=0,
                    atol=1e-5 * float(np.abs(g).max()),
                    err_msg=f"{layer}.{name}",
                )

    def test_parity_check_and_step_stream(self, engines):
        _, port, _, pmb, x_in = engines
        dt = port.step(pmb, x_in, key=(0, 0))
        rep = port.report()
        assert dt > 0 and rep["n_steps"] == 1
        assert rep["parity_max_diff"] < 2e-3
        assert rep["step_edges"] == [int(sum(b.edge_mask.sum()
                                             for b in pmb.blocks))]
        assert np.isfinite(rep["losses"]).all()
        assert rep["device"] == "cpu"

    def test_adamw_matches_reference_on_identical_gradients(self):
        rng = np.random.default_rng(5)
        shapes = {"layer_0": {"w": (7, 5), "b": (5,)}, "layer_1": {"w": (5,)}}
        params = {k: {n: rng.standard_normal(s).astype(np.float32)
                      for n, s in v.items()} for k, v in shapes.items()}
        r_opt, p_opt = ref_optim.adamw(3e-3), poptim.adamw(3e-3)
        r_params = jax.tree.map(jnp.asarray, params)
        p_params = convert.sage_params_from_jax(params)
        r_state, p_state = r_opt.init(r_params), p_opt.init(p_params)
        for _ in range(5):
            grads = {k: {n: rng.standard_normal(s).astype(np.float32)
                         * rng.choice([1e-6, 1.0])
                         for n, s in v.items()} for k, v in shapes.items()}
            r_upd, r_state = r_opt.update(jax.tree.map(jnp.asarray, grads),
                                          r_state, r_params)
            p_upd, p_state = p_opt.update(
                convert.sage_params_from_jax(grads), p_state, p_params)
            for k in shapes:
                for n in shapes[k]:
                    np.testing.assert_allclose(
                        p_upd[k][n].numpy(), np.asarray(r_upd[k][n]),
                        rtol=0, atol=1e-7)
            r_params = ref_optim.apply_updates(r_params, r_upd)
            p_params = poptim.apply_updates(p_params, p_upd)

    def test_model_wire_bytes_equal(self, bundles):
        graph = bundles[0][0]
        assert pcompute.model_wire_bytes(bundles[1][0], "none") \
            == rcompute.model_wire_bytes(graph, "none")
