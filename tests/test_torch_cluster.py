"""The port's P-worker cluster against the JAX reference, on the CPU.

The modeled lane is held to the reference's ``report_digest`` (every
rank's result fields, the barrier waits, the collective times, the
fabric's queueing), at the reference's pinned P=4 configuration and over
a set of cluster shapes; the measured lane at P=2 holds each rank's hit
and miss streams equal and its losses within rtol 1e-4, with the
reference's SAGE parameters loaded into every rank's engine. The pieces
the driver stands on (the ring cost, fault tolerance, the counter merges,
the per-worker streams, the modeled-lane model) are held one by one.
"""
import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import digest as dg
from repro.core import controller as rctl
from repro.core import cost_model as rcm
from repro.core import dqn as rdqn
from repro.distributed import collectives as rcoll
from repro.distributed import fault_tolerance as rft
from repro.models.gnn import sage as rsage
from repro.obs import reduce as rreduce
from repro.store import budget as rbudget
from repro.train import cluster as rcluster
from repro.train import compute as rcompute
from repro.train import gnn_trainer as rgt
from repro.train import worker as rworker
from repro_torch.analysis import digest as pdg
from repro_torch.analysis import runtime as pruntime
from repro_torch.core import cost_model as pcm
from repro_torch.core import dqn as pdqn
from repro_torch.distributed import collectives as pcoll
from repro_torch.distributed import fault_tolerance as pft
from repro_torch.obs import reduce as preduce
from repro_torch.store import budget as pbudget
from repro_torch.train import cluster as pcluster
from repro_torch.train import compute as pcompute
from repro_torch.train import gnn_trainer as pgt
from repro_torch.train import worker as pworker
from _jax_release import release_jax_executables  # noqa: F401

# the reference's modeled-lane pin (tests/test_compute.py::_PIN_CFG)
PIN_CFG = dict(method="static_w", dataset="reddit", batch_size=600,
               n_epochs=2, steps_per_epoch=8, scenario="clean", seed=0)
P4_DIGEST = "41d1a2d4d2a3e26dac2bfcd3618cab19fa12ffb53b1db759670fece305fbce28"
SMALL = dict(PIN_CFG, steps_per_epoch=4, static_window=2, warmup_epochs=1)
MEASURED = dict(SMALL, steps_per_epoch=3, compute="measured")


def _cfgs(kw, ref_q=None, port_q=None):
    return (rgt.RunConfig(**kw, q_fn=ref_q),
            pgt.RunConfig(**kw, q_fn=port_q, device="cpu"))


def _threads_left():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("trainer-worker-", "cache-builder",
                                  "prefetcher"))]


@pytest.fixture(scope="module")
def qnet(tmp_path_factory):
    """One qnet in both packages: the reference's jitted q_fn and the
    port's, loaded from the same file."""
    net = rdqn.init_qnet(jax.random.PRNGKey(2), rctl.state_dim(3),
                         rctl.n_actions(3))
    path = str(tmp_path_factory.mktemp("qnet") / "qnet.npz")
    rdqn.save_qnet(path, net)
    fwd = jax.jit(rdqn.q_forward)

    def ref_q(state):
        return np.asarray(fwd(net, jnp.asarray(state, jnp.float32)))

    return ref_q, pdqn.q_fn_of(pdqn.load_qnet(path))


# ------------------------------------------------------------------ pieces
@pytest.mark.parametrize("scatter", [False, True])
@pytest.mark.parametrize("n_workers", [1, 2, 3, 4, 8])
def test_ring_collective_cost_equal(n_workers, scatter):
    graph_bytes = pcluster.default_grad_bytes(
        pgt.build_trace(pgt.RunConfig(**SMALL, device="cpu"))[0])
    for nbytes in (0.0, graph_bytes):
        port = pcoll.ring_collective_cost(n_workers, nbytes,
                                          pcm.CostModelParams(),
                                          scatter=scatter)
        ref = rcoll.ring_collective_cost(n_workers, nbytes,
                                         rcm.CostModelParams(),
                                         scatter=scatter)
        assert port == ref
        assert type(port[3]) is type(ref[3])


class TestFaultTolerance:
    """The reference's ``tests/test_train_substrate.py`` cases through the
    port."""

    def test_heartbeat_detects_dead(self):
        t = [0.0]
        hb = pft.HeartbeatMonitor(4, timeout_s=10, clock=lambda: t[0])
        for w in range(4):
            hb.beat(w)
        assert hb.healthy()
        t[0] = 15.0
        hb.beat(0)
        hb.beat(1)
        hb.beat(2)
        assert hb.dead_workers() == [3]

    def test_retry_step_recovers(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise pft.WorkerFailure("transient")
            return "ok"

        assert pft.retry_step(flaky) == "ok"
        assert len(calls) == 3

    def test_retry_exhausts(self):
        def always_fail():
            raise pft.WorkerFailure("down")

        with pytest.raises(pft.WorkerFailure):
            pft.retry_step(always_fail, max_retries=2)

    def test_elastic_plan_pod_loss(self):
        kw = dict(old_shape=(2, 16, 16), axis_names=("pod", "data", "model"),
                  lost_axis="pod", lost_count=1, checkpoint_step=900,
                  failed_step=957, global_batch=256)
        plan = pft.plan_elastic_restart(**kw)
        assert plan.new_shape == (1, 16, 16)
        assert plan.data_skip_batches == 57
        assert dataclasses.asdict(plan) == dataclasses.asdict(
            rft.plan_elastic_restart(**kw))

    def test_elastic_plan_cannot_lose_all(self):
        with pytest.raises(ValueError):
            pft.plan_elastic_restart((1, 16, 16), ("pod", "data", "model"),
                                     "pod", 1, 0, 0, 256)

    def test_bounded_staleness(self):
        bar = pft.BoundedStalenessBarrier(4, max_stale=1, max_lag=1)
        for w in range(4):
            bar.report(w, 10)
        assert bar.can_proceed(11)
        bar.report(3, 8)  # one straggler 3 behind
        assert bar.can_proceed(11)  # tolerated (1 allowed)
        bar.report(2, 8)
        assert not bar.can_proceed(11)  # two stragglers -> block


def _items(d):
    return None if d is None else list(d.items())


class TestMerges:
    ROWS = [
        {"device_hits": 5, "host_hits": 2, "peak_resident_bytes": 10.0,
         "evictions": 1},
        None,
        {},
        {"host_hits": 3, "device_hits": 1, "peak_resident_bytes": 30.0,
         "extra": 7},
        {"device_hits": 4, "peak_resident_bytes": 20.0},
    ]

    @pytest.mark.parametrize("max_keys", [(), ("peak_resident_bytes",),
                                          ("host_hits", "missing")])
    def test_merge_counters_equal(self, max_keys):
        port = preduce.merge_counters(self.ROWS, max_keys=max_keys)
        ref = rreduce.merge_counters(self.ROWS, max_keys=max_keys)
        assert _items(port) == _items(ref)
        assert preduce.merge_counters([None, {}]) is None \
            is rreduce.merge_counters([None, {}])

    def test_tier_counts_merge_equal(self):
        stats = []
        for i in range(3):
            kw = dict(device_hits=3 * i, host_hits=i, host_misses=2 * i,
                      block_fetches=i + 1, remote_block_rows=5 * i,
                      local_block_rows=i, evictions=i % 2,
                      peak_resident_bytes=float(100 - 7 * i),
                      pinned_over_budget=i // 2)
            stats.append((pbudget.TierStats(**kw), rbudget.TierStats(**kw)))
        port = pbudget.TierStats.merge([p for p, _ in stats] + [None])
        ref = rbudget.TierStats.merge([r for _, r in stats] + [None])
        assert _items(port) == _items(ref)
        counts = [p.counts() for p, _ in stats]
        assert _items(pbudget.merge_tier_counts(counts)) \
            == _items(rbudget.merge_tier_counts(counts))
        assert pbudget.merge_tier_counts([]) is None
        arr = pbudget.tier_counts_array(port)
        assert arr.dtype == np.float64
        np.testing.assert_array_equal(arr, rbudget.tier_counts_array(ref))


@pytest.mark.parametrize("seed,n", [(0, 1), (0, 4), (3, 3), (11, 8)])
def test_worker_rngs_equal(seed, n):
    port, ref = pworker.worker_rngs(seed, n), rworker.worker_rngs(seed, n)
    assert len(port) == len(ref) == n
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.random(16), r.random(16))
        np.testing.assert_array_equal(p.integers(0, 1000, 8),
                                      r.integers(0, 1000, 8))


@pytest.mark.parametrize("obj", [
    None, True, 1, 1.0, "s", b"b", (1, 2), [1, 2], {"b": 1, "a": [1.5]},
    np.arange(6, dtype=np.float32).reshape(2, 3), np.float64(2.5),
    pbudget.TierStats(device_hits=3), torch.arange(4.0),
], ids=lambda o: type(o).__name__)
def test_port_digest_equals_reference(obj):
    """The port's copy of the digest hashes as the reference's does (a
    tensor hashes as its array); equal objects, equal digests."""
    from repro.analysis.digest import digest as rdigest

    ref_obj = obj.numpy() if torch.is_tensor(obj) else obj
    assert pdg.digest(obj) == rdigest(ref_obj)


def test_monotonic_clock():
    clock = pruntime.MonotonicClock("cluster clock")
    clock.observe(0, 1.0)
    clock.observe(1, 0.5)
    clock.observe(0, 1.0)
    with pytest.raises(pruntime.SanitizerError, match="backwards"):
        clock.observe(0, 0.999)


# ---------------------------------------------------- the modeled-lane model
class TestModeledLaneModel:
    def test_model_steps_match_reference(self):
        """The reference's ``_init_model`` parameters loaded through
        ``convert``: losses within rtol 1e-5, accuracy equal."""
        cfg, pcfg = _cfgs(dict(SMALL, run_model=True))
        graph, _, _, mbs = rgt.build_trace(cfg)
        ref = rgt._init_model(graph, cfg)
        port = pgt._init_model(graph, pcfg, params=jax.tree.map(
            np.asarray, ref["params"]))
        for epoch in mbs:
            for mb in epoch:
                ref = rgt._model_step(ref, mb)
                port = pgt._model_step(port, mb)
        np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)
        assert pgt._model_eval(port["params"], port["cfg"], graph,
                               port["device"]) \
            == rgt._model_eval(ref, graph)

    def test_run_model_modeled_lane_runs(self):
        """``run_model=True`` with ``compute="modeled"``, once refused,
        runs through ``gnn_trainer.run``: the digest is the reference's
        (the model does not touch the trainer's streams) and each epoch
        logs an accuracy."""
        cfg, pcfg = _cfgs(dict(SMALL, run_model=True))
        ref = rgt.run(cfg, rgt.build_trace(cfg))
        port = pgt.run(pcfg, pgt.build_trace(pcfg))
        dg.assert_results_equal(ref, port)
        assert port.accuracy_per_epoch.shape == (cfg.n_epochs,)
        assert np.all((port.accuracy_per_epoch >= 0)
                      & (port.accuracy_per_epoch <= 1))


# ------------------------------------------------------- modeled-lane digests
class TestModeledDigests:
    def test_p1_cluster_equals_run_and_reference(self):
        cfg, pcfg = _cfgs(SMALL)
        cc = dict(n_workers=1, sync="none")
        port = pcluster.run_cluster(pcfg, pcluster.ClusterConfig(**cc))
        ref = rcluster.run_cluster(cfg, rcluster.ClusterConfig(**cc))
        single = pgt.run(pcfg, pgt.build_trace(pcfg))
        dg.assert_results_equal(port.results[0], single)
        assert dg.report_digest(port) == dg.report_digest(ref)

    def test_pin_cfg_p4_digest(self):
        """The reference's pinned P=4 cluster, through the port, by both
        packages' digests."""
        cfg = pgt.RunConfig(**PIN_CFG, device="cpu")
        report = pcluster.run_cluster(cfg, pcluster.ClusterConfig(n_workers=4))
        assert dg.report_digest(report) == P4_DIGEST
        assert pdg.report_digest(report) == P4_DIGEST
        assert report.total_queue_s > 0
        assert sum(m["queue_s"] for m in report.requester_metrics) \
            == pytest.approx(report.total_queue_s)

    @pytest.mark.parametrize("case,kw,cc", [pytest.param(*c, id=c[0]) for c in [
        ("p2_clean", {}, dict(n_workers=2)),
        ("p3_clean", {}, dict(n_workers=3)),
        ("p4_paper_heuristic", dict(scenario="paper_schedule",
                                    method="heuristic"), dict(n_workers=4)),
        ("p4_bursty", dict(scenario="bursty_markov"), dict(n_workers=4)),
        ("p4_hot_owner", {}, dict(n_workers=4,
                                  link_rate_scale=(0.25, 1.0, 1.0, 1.0))),
        ("p4_straggler", {}, dict(n_workers=4,
                                  compute_scale=(2.0, 1, 1, 1))),
        ("p4_max_stale", {}, dict(n_workers=4, compute_scale=(2.0, 1, 1, 1),
                                  max_stale=1, max_lag=2)),
        ("p3_silent", {}, dict(n_workers=3, silent_ranks=(1,))),
        ("p4_reduce_scatter", {}, dict(n_workers=4, sync="reduce_scatter")),
        ("p2_sync_none", {}, dict(n_workers=2, sync="none")),
        ("p4_int8", {}, dict(n_workers=4, grad_compression="int8")),
        ("p4_topk", {}, dict(n_workers=4, grad_compression="topk",
                             topk_frac=0.25)),
    ]])
    def test_report_digest_equal(self, case, kw, cc):
        cfg, pcfg = _cfgs(dict(SMALL, **kw))
        ref = rcluster.run_cluster(cfg, rcluster.ClusterConfig(**cc))
        port = pcluster.run_cluster(pcfg, pcluster.ClusterConfig(**cc))
        for a, b in zip(ref.results, port.results):
            dg.assert_results_equal(a, b)
        assert dg.report_digest(port) == dg.report_digest(ref)
        assert port.grad_wire_bytes == ref.grad_wire_bytes
        assert port.totals_kj() == ref.totals_kj()
        assert _items(port.requester_totals()) \
            == _items(ref.requester_totals())
        assert port.per_worker() == ref.per_worker()
        if case in ("p4_straggler", "p4_max_stale"):
            assert port.sync_wait_s[1:].sum() > 0
        if case == "p4_int8":
            none = pcluster.run_cluster(
                pcfg, pcluster.ClusterConfig(n_workers=4))
            assert 3.5 < none.grad_wire_bytes / port.grad_wire_bytes < 4.0

    def test_mixed_fleet_per_rank_q_fns(self, qnet):
        """greendygnn on rank 1 under one qnet loaded into both packages,
        static_w elsewhere, over the paper schedule."""
        ref_q, port_q = qnet
        cfg, pcfg = _cfgs(dict(SMALL, scenario="paper_schedule"))
        methods = ("static_w", "greendygnn", "static_w")
        ref = rcluster.run_cluster(cfg, rcluster.ClusterConfig(
            n_workers=3, methods=methods, q_fns=(None, ref_q, None)))
        port = pcluster.run_cluster(pcfg, pcluster.ClusterConfig(
            n_workers=3, methods=methods, q_fns=(None, port_q, None)))
        assert port.methods == methods
        assert dg.report_digest(port) == dg.report_digest(ref)

    def test_straggler_drags_and_staleness_cuts(self):
        _, pcfg = _cfgs(SMALL)
        full = pcluster.ClusterConfig(n_workers=4,
                                      compute_scale=(2.0, 1, 1, 1))
        a = pcluster.run_cluster(pcfg, full)
        b = pcluster.run_cluster(pcfg, dataclasses.replace(
            full, max_stale=1, max_lag=2))
        assert a.sync_wait_s[1:].min() > 0
        assert b.sync_wait_s[1:].sum() < a.sync_wait_s[1:].sum()

    def test_hot_owner_raises_queueing(self):
        _, pcfg = _cfgs(SMALL)
        clean = pcluster.run_cluster(pcfg, pcluster.ClusterConfig(4))
        hot = pcluster.run_cluster(pcfg, pcluster.ClusterConfig(
            4, link_rate_scale=(0.25, 1.0, 1.0, 1.0)))
        assert hot.total_queue_s > clean.total_queue_s


# --------------------------------------------------------- the measured lane
@pytest.mark.parametrize("scheme", ["none", "int8", "topk"])
def test_measured_p2_static_w_matches_reference(scheme, monkeypatch):
    """P=2 measured lane: each rank's hit and miss streams equal, losses
    within rtol 1e-4 (the reference's block path against the CSR path,
    its jitted compression against the port's), with the reference's
    parameters in every rank's engine."""
    cfg, pcfg = _cfgs(dict(MEASURED, grad_compression=scheme))
    graph = pgt.build_trace(pcfg)[0]
    ref_params = jax.tree.map(np.asarray, rsage.init(
        jax.random.PRNGKey(cfg.seed), rcompute.sage_config(graph))[0])
    init = pcompute.ComputeEngine.__init__

    def loaded(self, graph, cfg):
        init(self, graph, cfg)
        self.load_params(ref_params)

    monkeypatch.setattr(pcompute.ComputeEngine, "__init__", loaded)
    cc = dict(n_workers=2, grad_compression=scheme)
    ref = rcluster.run_cluster(cfg, rcluster.ClusterConfig(**cc))
    port = pcluster.run_cluster(pcfg, pcluster.ClusterConfig(**cc))
    assert port.grad_wire_bytes == ref.grad_wire_bytes
    for a, b in zip(ref.results, port.results):
        np.testing.assert_array_equal(b.step_hits, a.step_hits)
        np.testing.assert_array_equal(b.step_misses, a.step_misses)
        np.testing.assert_array_equal(b.fetched_rows_by_owner,
                                      a.fetched_rows_by_owner)
        np.testing.assert_allclose(b.compute_report["losses"],
                                   a.compute_report["losses"], rtol=1e-4)
        assert b.compute_report["sync_wire_bytes"] \
            == a.compute_report["sync_wire_bytes"]
    if scheme != "none":
        assert port.grad_wire_bytes < pcompute.model_wire_bytes(graph)


# ------------------------------------------------------------------ refusals
class TestRefusals:
    """Each of the reference's refusals raises the same exception type in
    the port."""

    @pytest.mark.parametrize("cc,match", [
        (dict(n_workers=9), "n_workers"),
        (dict(n_workers=0), "n_workers"),
        (dict(n_workers=2, sync="psync"), "sync"),
        (dict(n_workers=2, link_rate_scale=(1.0, 1.0)), "link_rate_scale"),
        (dict(n_workers=2, max_stale=2), "max_stale"),
        (dict(n_workers=3, silent_ranks=(0,), max_stale=2), "max_stale"),
        (dict(n_workers=2, methods=("static_w",)), "methods needs 2"),
        (dict(n_workers=2, methods=("static_w", "zen")),
         "unknown per-rank methods"),
        (dict(n_workers=2, q_fns=(None,)), "q_fns needs 2"),
        (dict(n_workers=2, methods=("greendygnn", "static_w")), "no q_fn"),
        (dict(n_workers=2, grad_compression="zfp"), "grad_compression"),
    ])
    def test_same_exception_type(self, cc, match):
        cfg, pcfg = _cfgs(SMALL)
        with pytest.raises(ValueError, match=match):
            rcluster.run_cluster(cfg, rcluster.ClusterConfig(**cc))
        with pytest.raises(ValueError, match=match):
            pcluster.run_cluster(pcfg, pcluster.ClusterConfig(**cc))
        assert not _threads_left()

    def test_bundle_count_mismatch(self):
        cfg, pcfg = _cfgs(SMALL)
        with pytest.raises(ValueError, match="trace bundles"):
            rcluster.run_cluster(cfg, rcluster.ClusterConfig(n_workers=2),
                                 trace_bundles=rcluster.build_cluster_traces(
                                     cfg, 3))
        with pytest.raises(ValueError, match="trace bundles"):
            pcluster.run_cluster(pcfg, pcluster.ClusterConfig(n_workers=2),
                                 trace_bundles=pcluster.build_cluster_traces(
                                     pcfg, 3))

    def test_unknown_scenario(self):
        cfg, pcfg = _cfgs(dict(SMALL, scenario="no_such_scenario"))
        with pytest.raises(KeyError):
            rcluster.run_cluster(cfg, rcluster.ClusterConfig(n_workers=2))
        with pytest.raises(KeyError):
            pcluster.run_cluster(pcfg, pcluster.ClusterConfig(n_workers=2))

    def test_trace_runs(self):
        """``trace=True``, once refused here, traces: the P=2 payload is
        the reference's in canonical JSON and reconciles bit for bit on
        every rank, and no worker thread is left."""
        from repro.obs import dumps_canonical as ref_dumps
        from repro_torch.obs import dumps_canonical, reconcile

        cfg, pcfg = _cfgs(dict(SMALL, trace=True))
        port = pcluster.run_cluster(pcfg, pcluster.ClusterConfig(n_workers=2))
        ref = rcluster.run_cluster(cfg, rcluster.ClusterConfig(n_workers=2))
        assert dumps_canonical(port.trace) == ref_dumps(ref.trace)
        assert sorted(reconcile(port.trace)) == [0, 1]
        assert not _threads_left()

    def test_cuda_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pcluster.run_cluster(pgt.RunConfig(**SMALL),
                                 pcluster.ClusterConfig(n_workers=2))
        assert not _threads_left()


# ------------------------------------------------------------------ failures
class TestFailures:
    def test_corrupt_trace_propagates(self):
        """A rank whose trace ends early fails mid-run: the driver
        re-raises, and no worker thread is left."""
        _, pcfg = _cfgs(SMALL)
        bad = pcluster.build_cluster_traces(pcfg, 2)
        graph, owner, traces, mbs = bad[1]
        bad[1] = (graph, owner, traces[:1], mbs)
        with pytest.raises(RuntimeError, match="cluster worker failed"):
            pcluster.run_cluster(pcfg, pcluster.ClusterConfig(n_workers=2),
                                 trace_bundles=bad)
        assert not _threads_left()

    @pytest.mark.parametrize("where", ["step", "end_epoch"])
    def test_raising_rank_is_reraised(self, where, monkeypatch):
        """A rank whose step (or its last end_epoch, after the driver's
        last publish) raises: ``run_cluster`` re-raises that error as the
        cause, and no thread (worker, builder or prefetcher) is left."""
        class Boom(RuntimeError):
            pass

        orig = getattr(pworker.TrainerWorker, where)
        last = SMALL["n_epochs"] - 1

        def failing(self, epoch, *args):
            if self.rank == 1 and (where == "step" or epoch == last):
                raise Boom(f"rank 1 {where}")
            return orig(self, epoch, *args)

        monkeypatch.setattr(pworker.TrainerWorker, where, failing)
        _, pcfg = _cfgs(dict(SMALL, async_pipeline=True))
        with pytest.raises(RuntimeError, match="cluster worker failed") as ei:
            pcluster.run_cluster(pcfg, pcluster.ClusterConfig(n_workers=3))
        assert isinstance(ei.value.__cause__, Boom)
        assert not _threads_left()


def test_gate_under_fast_thread_switching():
    """Eight ranks (more than the cores) and a thread switch every
    microsecond: the gate's lockstep release keeps the run bit-identical
    to one at the default interval and to the reference's (a lost update
    in the gate would move a rank's turn or charge)."""
    cfg, pcfg = _cfgs(dict(SMALL, n_parts=8))
    cc = dict(n_workers=8)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        fast = pcluster.run_cluster(pcfg, pcluster.ClusterConfig(**cc))
    finally:
        sys.setswitchinterval(old)
    assert not _threads_left()
    calm = pcluster.run_cluster(pcfg, pcluster.ClusterConfig(**cc))
    ref = rcluster.run_cluster(cfg, rcluster.ClusterConfig(**cc))
    assert dg.report_digest(fast) == dg.report_digest(calm) \
        == dg.report_digest(ref)


# ----------------------------------------------------------------- reporting
def test_report_totals_and_pipeline(qnet):
    """The report's merges over a threaded, budgeted P=3 run equal the
    reference's (the threaded pipeline's timings are measured, so the
    merged counters that do not hold time are compared)."""
    from repro.store import MemoryBudget as RefBudget
    from repro_torch.store import MemoryBudget

    host = 0.2 * 24_000 * 64 * 4
    kw = dict(SMALL)
    cfg = rgt.RunConfig(**kw, mem_budget=RefBudget(
        host_bytes=host, chunk_rows=256, device_payloads=True))
    pcfg = pgt.RunConfig(**kw, mem_budget=MemoryBudget(
        host_bytes=host, chunk_rows=256, device_payloads=True), device="cpu")
    ref = rcluster.run_cluster(cfg, rcluster.ClusterConfig(n_workers=3))
    port = pcluster.run_cluster(pcfg, pcluster.ClusterConfig(n_workers=3))
    assert dg.report_digest(port) == dg.report_digest(ref)
    assert _items(port.tier_counts()) == _items(ref.tier_counts())
    assert port.tier_counts()["block_fetches"] > 0
    assert port.pipeline_totals() is None

    asyn = pcluster.run_cluster(dataclasses.replace(pcfg, async_pipeline=True),
                                pcluster.ClusterConfig(n_workers=3))
    totals = asyn.pipeline_totals()
    rows = [r.pipeline.summary() for r in asyn.results]
    assert totals["n_rebuilds"] == sum(r["n_rebuilds"] for r in rows)
    assert totals["swap_latency_max_s"] == max(r["swap_latency_max_s"]
                                               for r in rows)
    assert 0.0 <= totals["overlap_efficiency"]
    for a, b in zip(asyn.results, port.results):
        np.testing.assert_array_equal(a.step_hits, b.step_hits)
        np.testing.assert_array_equal(a.step_misses, b.step_misses)
    assert not _threads_left()
