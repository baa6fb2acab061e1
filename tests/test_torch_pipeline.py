"""The port's threaded pipeline on the CPU: ``repro_torch.pipeline``
(builder, prefetch queue, report, parity), the worker's threaded branches
against the reference's threaded runs on the same inputs, the device
tier's double-buffered tables, the thread-safe launch counter and the
threads' lifetime.

Adaptive controllers decide one boundary earlier on the threaded path, so
threaded-vs-synchronous parity is claimed for ``static_w`` only, as the
reference claims it. Under a fabric the builder reads the consumer's
virtual clock from its own thread, so fabric timings and joules depend on
thread scheduling in both packages: the cross-package cases compare
streams and counts, never energies.
"""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.windowed_cache import DoubleBufferedCache as RefCache
from repro.graph import datasets as rds
from repro.store import DevicePayloadTier as RefTier
from repro.store import MemoryBudget as RefBudget
from repro.train import gnn_trainer as rgt
from repro_torch.analysis.runtime import SanitizerError, ThreadAffinity
from repro_torch.core.windowed_cache import DoubleBufferedCache
from repro_torch.kernels import _build
from repro_torch.pipeline import CacheBuilder, PipelineReport, PrefetchQueue
from repro_torch.pipeline.parity import check_parity, compare_runs
from repro_torch.store import DevicePayloadTier, MemoryBudget
from repro_torch.train import gnn_trainer as pgt
from repro_torch.train.worker import TrainerWorker
from _jax_release import release_jax_executables  # noqa: F401

PIPELINE_THREADS = ("cache-builder", "prefetcher")


def make_setup(n_nodes=2000, n_owners=3, capacity=120, seed=0):
    rng = np.random.default_rng(seed)
    owner_of = rng.integers(0, n_owners, n_nodes)
    features = rng.standard_normal((n_nodes, 8)).astype(np.float32)
    cache = DoubleBufferedCache(capacity, owner_of, n_owners)
    return cache, features, rng


def pipeline_threads() -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.name in PIPELINE_THREADS]


class TestCacheBuilder:
    def test_background_build_matches_sync_plan(self):
        cache, features, rng = make_setup()
        batches = [rng.integers(0, 2000, 128) for _ in range(8)]
        w = np.full(3, 1 / 3)
        sync_plan = cache.plan_window(batches, w)
        with CacheBuilder(cache, lambda ids: features[ids]) as b:
            buf, exposed = b.build_sync(batches, w)
        np.testing.assert_array_equal(buf.plan.hot_nodes, sync_plan.hot_nodes)
        np.testing.assert_array_equal(
            buf.plan.per_owner_fetched, sync_plan.per_owner_fetched
        )
        # fetched payload rows are the remotely-fetched hot nodes' features
        np.testing.assert_array_equal(
            buf.features, features[buf.plan.hot_nodes[buf.plan.fetched]]
        )
        assert exposed >= 0 and buf.t_total_s > 0
        assert buf.table is None

    def test_swap_promotes_and_tags_generation(self):
        cache, features, rng = make_setup()
        batches = [rng.integers(0, 2000, 128)]
        with CacheBuilder(cache, lambda ids: features[ids]) as b:
            buf, _ = b.build_sync(batches, np.full(3, 1 / 3))
            g0 = cache.generation
            b.swap(buf)
            assert cache.generation == g0 + 1
            hit, _ = cache.lookup(buf.plan.hot_nodes)
            assert hit.all()

    def test_stale_buffer_rejected(self):
        cache, features, rng = make_setup()
        batches = [rng.integers(0, 2000, 128)]
        w = np.full(3, 1 / 3)
        with CacheBuilder(cache, lambda ids: features[ids]) as b:
            buf1, _ = b.build_sync(batches, w)
            b.swap(buf1)
            buf2, _ = b.build_sync([rng.integers(0, 2000, 128)], w)
            b.swap(buf2)  # fine: built against generation after first swap
            # a buffer diffed against an older generation must be refused
            with pytest.raises(RuntimeError, match="stale"):
                b.swap(buf1)

    def test_build_error_propagates_to_consumer(self):
        cache, _, rng = make_setup()

        def boom(ids):
            raise ValueError("fetch failed")

        with CacheBuilder(cache, boom) as b:
            with pytest.raises(ValueError, match="fetch failed"):
                b.build_sync([rng.integers(0, 2000, 64)], np.full(3, 1 / 3))

    def test_overlap_is_measured(self):
        """A build submitted before consumer work should be (mostly)
        hidden."""
        cache, features, rng = make_setup(capacity=400)
        batches = [rng.integers(0, 2000, 256) for _ in range(16)]
        with CacheBuilder(cache, lambda ids: features[ids]) as b:
            ticket = b.submit(batches, np.full(3, 1 / 3))
            time.sleep(0.05)  # consumer "compute" overlapping the build
            buf, exposed = b.wait(ticket)
        assert exposed < buf.t_total_s  # some of the build was hidden
        rep = PipelineReport.from_components(b, None)
        assert rep.n_rebuilds == 1
        assert 0.0 <= rep.overlap_efficiency <= 1.0

    def test_build_table_runs_on_the_builder_thread(self):
        """``build_table`` gets the plan and its fetched rows, on the
        builder thread, and its result is published on the buffer."""
        cache, features, rng = make_setup()
        seen = []

        def build_table(plan, rows):
            seen.append(threading.current_thread().name)
            return plan.hot_nodes[plan.fetched], rows

        with CacheBuilder(cache, lambda ids: features[ids],
                          build_table=build_table) as b:
            buf, _ = b.build_sync([rng.integers(0, 2000, 128)],
                                  np.full(3, 1 / 3))
        assert seen == ["cache-builder"]
        ids, rows = buf.table
        np.testing.assert_array_equal(rows, features[ids])

    def test_tracer_gets_pipeline_spans(self):
        """``CacheBuilder(tracer=...)``, once refused here, traces: a build
        gives the reference's span names and argument keys, the plan and
        fetch spans from the builder thread and the exposed wait and swap
        from the consumer, all at the consumer's virtual clock."""
        from repro.core.cost_model import CostModelParams as RefParams
        from repro.obs import Tracer as RefTracer
        from repro.pipeline import CacheBuilder as RefBuilder
        from repro_torch.core.cost_model import CostModelParams
        from repro_torch.net.fabric import NetClock
        from repro_torch.obs import Tracer

        cache, features, rng = make_setup()
        # make_setup's owner map, the first draw of its generator
        ref_cache = RefCache(120, np.random.default_rng(0).integers(0, 3, 2000),
                             3)
        batches = [rng.integers(0, 2000, 128)]
        weights = np.full(3, 1 / 3)
        spans = {}
        for name, builder, tracer in [
            ("port", CacheBuilder, Tracer(rank=0, params=CostModelParams())),
            ("ref", RefBuilder, RefTracer(rank=0, params=RefParams())),
        ]:
            threads = []
            span = tracer.span

            def recording(*a, _span=span, **k):
                threads.append(threading.current_thread().name)
                return _span(*a, **k)

            tracer.span = recording
            c = cache if name == "port" else ref_cache
            with builder(c, lambda ids: features[ids], tracer=tracer,
                         clock_fn=lambda: NetClock(1.5, 3, 0)) as b:
                buf, _ = b.build_sync(batches, weights)
                b.swap(buf)
            spans[name] = tracer.events
            if name == "port":
                assert threads == ["cache-builder", "cache-builder",
                                   threading.current_thread().name,
                                   threading.current_thread().name]
        for ev_p, ev_r in zip(spans["port"], spans["ref"], strict=True):
            assert (ev_p["component"], ev_p["name"]) \
                == (ev_r["component"], ev_r["name"])
            assert set(ev_p["args"]) == set(ev_r["args"])
            assert ev_p["t0"] == 1.5 or ev_p["name"] == "fetch"
            assert ev_p["t1"] >= ev_p["t0"]
        assert [e["name"] for e in spans["port"]] \
            == ["plan", "fetch", "exposed-wait", "swap"]

    def test_sanitizer_binds_the_consumer_thread(self):
        cache, features, rng = make_setup()
        with CacheBuilder(cache, lambda ids: features[ids],
                          sanitize=True) as b:
            ticket = b.submit([rng.integers(0, 2000, 64)], np.full(3, 1 / 3))
            errors = []

            def other():
                try:
                    b.wait(ticket)
                except SanitizerError as e:
                    errors.append(e)

            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10.0)
            assert not t.is_alive()
            assert len(errors) == 1 and "single-consumer" in str(errors[0])
            b.wait(ticket)  # the owning thread still may


def test_thread_affinity_binds_the_first_caller():
    aff = ThreadAffinity("consumer")
    aff.check("first")
    aff.check("again")
    errors = []

    def other():
        try:
            aff.check("from another thread")
        except SanitizerError as e:
            errors.append(str(e))

    t = threading.Thread(target=other, name="intruder")
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert len(errors) == 1 and "'intruder'" in errors[0]


class TestPrefetchQueue:
    def test_in_order_delivery(self):
        with PrefetchQueue(lambda x: x * 10, depth=3) as pq:
            pq.schedule(range(20))
            got = [pq.get()[0] for _ in range(20)]
        assert got == [i * 10 for i in range(20)]

    def test_never_runs_more_than_depth_ahead(self):
        resolved = []

        def resolve(x):
            resolved.append(x)
            return x

        with PrefetchQueue(resolve, depth=2) as pq:
            pq.schedule(range(10))
            deadline = time.time() + 2.0
            # resolver fills the bounded queue: depth + the one in flight
            while len(resolved) < 3 and time.time() < deadline:
                time.sleep(0.005)
            time.sleep(0.05)  # would run further ahead if unbounded
            assert len(resolved) <= 3
            for _ in range(10):
                pq.get()
        assert len(resolved) == 10

    def test_measures_wait_and_lead(self):
        with PrefetchQueue(lambda x: x, depth=4) as pq:
            pq.schedule(range(8))
            time.sleep(0.02)  # let the resolver run ahead
            for _ in range(8):
                pq.get()
            assert pq.n_got == 8
            assert pq.lead_s > 0.0  # first items were resolved ahead
            assert pq.wait_s >= 0.0

    def test_bad_depth_rejected(self):
        with pytest.raises(ValueError):
            PrefetchQueue(lambda x: x, depth=0)


def test_launch_counter_is_exact_across_threads():
    """``count_launch`` from more threads than cores, with the interpreter
    switching threads as often as it can: no increment is lost, in the
    total or in any thread's own count."""
    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.launches_by_thread = {}
    n_threads, n_each = 16, 5000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count_launch(wrapper)
                            for _ in range(n_each)], name=f"launcher-{i}")
            for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == n_threads * n_each
    assert wrapper.launches_by_thread == {
        f"launcher-{i}": n_each for i in range(n_threads)}


# ------------------------------------------------------------------ parity
PARITY = dict(method="static_w", dataset="reddit", batch_size=600,
              n_epochs=3, steps_per_epoch=10, static_window=4)


@pytest.fixture(scope="module")
def parity_bundle():
    return pgt.build_trace(pgt.RunConfig(**PARITY, device="cpu"))


class TestParity:
    @pytest.mark.parametrize("device_payloads", [False, True],
                             ids=["no_payloads", "device_payloads"])
    @pytest.mark.parametrize("window", [4, 7])
    def test_threaded_matches_sync(self, parity_bundle, window,
                                   device_payloads):
        """Identical hit/miss stream and per-owner fetched rows; W = 7
        does not divide 10 steps, so windows straddle epochs and the
        lookahead build reads the next epoch's trace."""
        cfg = pgt.RunConfig(**dict(PARITY, static_window=window),
                            mem_budget=MemoryBudget(
                                device_payloads=device_payloads),
                            device="cpu")
        rep = check_parity(cfg, parity_bundle)
        assert rep.ok, rep.describe()
        assert rep.n_steps == cfg.n_epochs * cfg.steps_per_epoch
        assert rep.sync_hits == rep.async_hits
        np.testing.assert_array_equal(
            rep.sync_fetched_rows, rep.async_fetched_rows
        )

    def test_async_run_reports_pipeline(self, parity_bundle):
        cfg = pgt.RunConfig(**PARITY, async_pipeline=True, device="cpu")
        res = pgt.run(cfg, parity_bundle)
        rep = res.pipeline
        assert rep is not None and rep.n_rebuilds > 0
        assert 0.0 <= rep.overlap_efficiency <= 1.0
        assert rep.prefetch_batches == len(res.step_hits)
        assert rep.builder_wall_s > 0
        assert set(rep.summary()) >= {"exposed_wait_s", "overlap_efficiency",
                                      "swap_latency_mean_s"}
        # sync runs carry no pipeline report
        res_sync = pgt.run(dataclasses.replace(cfg, async_pipeline=False),
                           parity_bundle)
        assert res_sync.pipeline is None
        assert compare_runs(res_sync, res).ok

    def test_adaptive_method_runs_async(self, parity_bundle):
        """The threaded path also drives the heuristic controller
        (decisions one boundary ahead; parity not claimed)."""
        cfg = pgt.RunConfig(**dict(PARITY, method="heuristic"),
                            async_pipeline=True, device="cpu")
        res = pgt.run(cfg, parity_bundle)
        assert res.pipeline is not None and res.pipeline.n_rebuilds > 0
        assert len(res.step_hits) == cfg.n_epochs * cfg.steps_per_epoch

    def test_measured_lane_matches_sync(self):
        """The card's configuration at a small size: measured compute and
        device payloads, threaded against synchronous."""
        kw = dict(method="static_w", batch_size=600, n_epochs=2,
                  steps_per_epoch=4, static_window=2, compute="measured")
        cfg = pgt.RunConfig(**kw, mem_budget=MemoryBudget(
            device_payloads=True), device="cpu")
        bundle = pgt.build_trace(cfg)
        sync = pgt.run(cfg, bundle)
        asyn = pgt.run(dataclasses.replace(cfg, async_pipeline=True), bundle)
        assert compare_runs(sync, asyn).ok
        np.testing.assert_array_equal(sync.window_per_epoch,
                                      asyn.window_per_epoch)
        assert asyn.compute_report["n_steps"] == 8
        assert all(np.isfinite(asyn.compute_report["losses"]))


# -------------------------------------------------------- against reference
@pytest.fixture(scope="module")
def ref_bundle():
    return rgt.build_trace(rgt.RunConfig(**PARITY))


@pytest.mark.parametrize("scenario", [None, "bursty_markov"],
                         ids=["closed_form", "bursty_markov"])
def test_async_streams_equal_reference(scenario, ref_bundle, parity_bundle):
    """static_w threaded in both packages, one RunConfig and trace: the
    streams, windows and per-owner fetched rows are equal. Under
    ``bursty_markov`` the builder's bulk fetch goes through the fabric."""
    kw = dict(PARITY, scenario=scenario, async_pipeline=True)
    ref = rgt.run(rgt.RunConfig(**kw), ref_bundle)
    port = pgt.run(pgt.RunConfig(**kw, device="cpu"), parity_bundle)
    for name in ("step_hits", "step_misses", "window_per_epoch",
                 "fetched_rows_by_owner"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name),
                                      err_msg=name)
    assert port.pipeline.n_rebuilds == ref.pipeline.n_rebuilds
    assert port.pipeline.prefetch_batches == ref.pipeline.prefetch_batches
    if scenario is not None:
        assert port.meter.n_rpcs > 0


@pytest.mark.parametrize("device_payloads", [False, True],
                         ids=["host_only", "device_payloads"])
def test_async_budgeted_tier_counts_equal_reference(device_payloads):
    """ooc_community threaded under a host budget of 0.3 of its matrix:
    the consumer's pins and touches at each swap give the reference's
    ``tier_counts``."""
    graph = rds.materialize("ooc_community", seed=0)
    host = 0.3 * graph.n_nodes * graph.feature_source.n_feat * 4
    kw = dict(method="static_w", dataset="ooc_community", batch_size=600,
              n_epochs=2, steps_per_epoch=4, static_window=2, seed=1,
              scenario="clean", async_pipeline=True)
    cfg = rgt.RunConfig(**kw, mem_budget=RefBudget(
        host_bytes=host, chunk_rows=256, device_payloads=device_payloads))
    pcfg = pgt.RunConfig(**kw, mem_budget=MemoryBudget(
        host_bytes=host, chunk_rows=256, device_payloads=device_payloads),
        device="cpu")
    ref = rgt.run(cfg, rgt.build_trace(cfg))
    port = pgt.run(pcfg, pgt.build_trace(pcfg))
    assert port.tier_counts == ref.tier_counts
    np.testing.assert_array_equal(port.step_hits, ref.step_hits)
    tc = port.tier_counts
    assert tc["block_fetches"] > 0
    assert (tc["device_hits"] > 0) == device_payloads


# ------------------------------------------------------------- device tier
def _plans(n_nodes=3000, n_owners=3, capacity=400, n_windows=5, seed=2):
    """A sequence of windows' remote-id batches over one owner map."""
    rng = np.random.default_rng(seed)
    owner_of = rng.integers(0, n_owners, n_nodes)
    windows = []
    for k in range(n_windows):
        lo = 200 * k
        windows.append([rng.integers(lo, lo + 1500, 300) for _ in range(3)])
    return owner_of, windows, capacity


def test_load_with_fetched_rows_equals_reference():
    """The same plans and the same fetched rows through both tiers' ``load``:
    the host payload is bit-equal to the reference's after every rebuild,
    and the port's device table holds the same rows."""
    owner_of, windows, capacity = _plans()
    features = np.random.default_rng(3).standard_normal(
        (len(owner_of), 16)).astype(np.float32)
    rcache = RefCache(capacity, owner_of, 3)
    pcache = DoubleBufferedCache(capacity, owner_of, 3)
    rtier = RefTier(rcache, 16)
    ptier = DevicePayloadTier(pcache, 16, device="cpu")

    def never(ids):
        raise AssertionError("fetched rows were handed over")

    w = np.array([0.5, 0.3, 0.2])
    n_persisted = 0
    for batches in windows:
        rplan = rcache.plan_window(batches, w)
        pplan = pcache.plan_window(batches, w)
        np.testing.assert_array_equal(pplan.hot_nodes, rplan.hot_nodes)
        rows = features[pplan.hot_nodes[pplan.fetched]] * 1.5
        rtier.load(rplan, never, fetched_rows=rows)
        ptier.load(pplan, never, fetched_rows=rows)
        n_persisted += int(pplan.persisted.sum())
        rcache.swap(rplan)
        pcache.swap(pplan)
        assert ptier._payload.tobytes() == rtier._payload.tobytes()
        assert torch.equal(ptier._table, torch.from_numpy(rtier._payload))
        assert ptier.resident_bytes == rtier.resident_bytes
    assert n_persisted > 0
    assert ptier.n_loads == rtier.n_loads == len(windows)


def test_stale_table_refused():
    owner_of, windows, capacity = _plans()
    features = np.zeros((len(owner_of), 4), np.float32)
    cache = DoubleBufferedCache(capacity, owner_of, 3)
    tier = DevicePayloadTier(cache, 4, device="cpu")
    w = np.full(3, 1 / 3)
    pending = tier.build(cache.plan_window(windows[0], w),
                         lambda ids: features[ids])
    cache.swap(cache.plan_window(windows[1], w))
    with pytest.raises(RuntimeError, match="stale pending table"):
        tier.install(pending)


def test_threaded_tables_equal_host_payload(parity_bundle, monkeypatch):
    """Across a threaded run's rebuilds, at every swap: the pending table
    equals its host payload, the active table is untouched by the build
    that read it, and after the flip every active slot gathers its host
    row."""
    install = DevicePayloadTier.install
    checked = []

    def checked_install(self, pending):
        assert torch.equal(self._table, torch.from_numpy(self._payload))
        assert torch.equal(pending.table, torch.from_numpy(pending.payload))
        install(self, pending)
        n = len(self._payload)
        assert torch.equal(self.gather_rows(np.arange(n)),
                           torch.from_numpy(self._payload))
        checked.append(n)

    monkeypatch.setattr(DevicePayloadTier, "install", checked_install)
    cfg = pgt.RunConfig(**PARITY, async_pipeline=True,
                        mem_budget=MemoryBudget(device_payloads=True),
                        device="cpu")
    res = pgt.run(cfg, parity_bundle)
    assert len(checked) == res.pipeline.n_rebuilds > 2
    assert all(n > 0 for n in checked)


# --------------------------------------------------------------- lifecycle
def test_run_failing_mid_epoch_leaves_no_threads(parity_bundle, monkeypatch):
    step = TrainerWorker.step

    def failing_step(self, epoch, s):
        if (epoch, s) == (1, 3):
            raise RuntimeError("step failed")
        step(self, epoch, s)

    monkeypatch.setattr(TrainerWorker, "step", failing_step)
    cfg = pgt.RunConfig(**PARITY, async_pipeline=True, device="cpu")
    with pytest.raises(RuntimeError, match="step failed"):
        pgt.run(cfg, parity_bundle)
    assert pipeline_threads() == []


def test_failed_build_fails_the_run(parity_bundle, monkeypatch):
    """A build that raises on the builder thread raises from ``run``: no
    fallback to the synchronous path or the host payload."""
    plan_window = DoubleBufferedCache.plan_window

    def failing_plan(self, batches, weights):
        if threading.current_thread().name == "cache-builder" \
                and self.generation >= 2:
            raise ValueError("build failed")
        return plan_window(self, batches, weights)

    monkeypatch.setattr(DoubleBufferedCache, "plan_window", failing_plan)
    cfg = pgt.RunConfig(**PARITY, async_pipeline=True,
                        mem_budget=MemoryBudget(device_payloads=True),
                        device="cpu")
    with pytest.raises(ValueError, match="build failed"):
        pgt.run(cfg, parity_bundle)
    assert pipeline_threads() == []
