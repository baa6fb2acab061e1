"""One partition's trainer runtime.

Port of ``repro/train/worker.py``: a :class:`TrainerWorker` is the
substrate of ONE partition (its feature store rank, hot cache, controller,
energy meter, device payload tier and measured compute engine), assembled
from small pure builders, with explicit per-epoch/per-step methods that
``gnn_trainer.run`` drives in a plain loop (P=1) and
``train/cluster.py`` interleaves for P workers over one shared fabric
(``cluster=True``: transfers carry ``requester=rank`` and the worker's own
virtual clock, the fabric's ticked clock is left alone, and the driver
charges each step's gradient-sync barrier through :meth:`apply_sync`).

The worker runs over either network substrate: the closed-form
Eq. 4 law, or the ``net/`` event fabric of a ``RunConfig.scenario``
(delta and sigma refreshed every step from the worker's virtual clock,
transfers queueing on the owner links). It runs every method, the
heuristic (Eq. 7) among them, a budgeted host tier
(``MemoryBudget.host_bytes``: block residency charged on the network
substrate, pinned at each rebuild, observed by the controller as
headroom), and either rebuild path: the synchronous one, which models
the builder thread (the alpha_crit leak), or the threaded pipeline
(``async_pipeline=True``, ``pipeline/``), whose builder thread plans,
fetches and, with device payloads, builds the next window's device table
on a CUDA stream of its own while the consumer steps, and whose measured
exposed wait is charged instead. The measured lane compresses its
gradients (int8 or top-k with error feedback) when ``grad_compression``
asks; ``run_model=True`` in the modeled lane trains the model beside the
trainer (``gnn_trainer._model_step``). ``trace=True`` records the
greentrace events of ``repro_torch.obs``: a charge event beside each meter
record (the same charge law, so the ledger reconciles bit for bit), the
controller's decisions, the rebuild windows, the host tier's counters, the
fabric's per-owner spans, the pipeline's spans and, in the measured lane,
the step's roofline terms at the card's peaks.

The worker keeps a virtual clock (``meter.wall_s``); nothing here reads
the OS clock on the timing path except the measured compute lane, whose
step time advances that clock (so a measured run's time-driven
congestion depends on the machine, as the reference's does), and the
threaded pipeline, whose measured build and wait times are charged.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import controller as ctl
from repro_torch.core import cost_model as cm
from repro_torch.core.energy import EnergyMeter, StepSample
from repro_torch.core.windowed_cache import CacheStats, DoubleBufferedCache
from repro_torch.device import resolve
from repro_torch.graph.features import ShardedFeatureStore
from repro_torch.launch.roofline import device_peaks
from repro_torch.net.fabric import NetClock
from repro_torch.obs.tracer import NULL_TRACER, Tracer
from repro_torch.train import grad_compression as gc
from repro_torch.train.compute import ComputeEngine, InputRows

WINDOWED_METHODS = ("static_w", "heuristic", "greendygnn", "greendygnn_nocw")
ADAPTIVE_METHODS = ("heuristic", "greendygnn", "greendygnn_nocw")


def check_supported(cfg) -> None:
    """Refuse the configurations the trainer does not run."""
    if cfg.compute not in ("modeled", "measured"):
        raise ValueError(
            f"compute must be 'modeled' or 'measured', got {cfg.compute!r}"
        )
    gc.check_scheme(cfg.grad_compression)


# --------------------------------------------------------------------------
# Pure builders: each assembles one piece of a worker's substrate from the
# run config. No hidden state, no I/O — a worker is just their composition.
# --------------------------------------------------------------------------

def build_store(graph, owner: np.ndarray, rank: int, n_parts: int,
                budget=None) -> ShardedFeatureStore:
    """The partition-``rank`` view of the owner-sharded feature store
    (the tiered store when a budget or a streaming source is given)."""
    source = getattr(graph, "feature_source", None)
    if budget is None and source is None:
        return ShardedFeatureStore(graph.features, owner, rank, n_parts)
    from repro_torch.store import TieredFeatureStore

    # locality storage layout: rows sorted by (owner, community) so one
    # window's working set lands in few contiguous host-tier blocks
    layout = None
    labels = getattr(graph, "labels", None)
    if labels is not None:
        layout = np.lexsort((
            np.arange(graph.n_nodes), np.asarray(labels), np.asarray(owner),
        ))
    return TieredFeatureStore(
        graph.features, owner, rank, n_parts, budget=budget, source=source,
        layout=layout,
    )


def build_cache(cfg, graph, owner_idx_map: np.ndarray
                ) -> DoubleBufferedCache | None:
    """Hot-set cache for cached methods (None for dgl/bgl)."""
    windowed = cfg.method in WINDOWED_METHODS
    if not (windowed or cfg.method == "rapidgnn"):
        return None
    capacity = int(cfg.cache_frac * graph.n_nodes)
    return DoubleBufferedCache(capacity, owner_idx_map, cfg.n_parts - 1)


def build_controller(cfg, params, n_owners: int,
                     observe_headroom: bool = False
                     ) -> ctl.AdaptiveController | None:
    """Per-boundary W/weights controller (the Eq. 7 heuristic rule or a
    trained DQN's q_fn). ``observe_headroom=True`` (budgeted tiered store)
    appends the cache-headroom entry to the state; a DQN's q_fn must then
    be sized for ``state_dim(n_owners, headroom=True)``."""
    if cfg.method not in ADAPTIVE_METHODS:
        return None
    if cfg.method == "heuristic":
        from repro_torch.core import policies as pol

        policy = pol.heuristic_policy(params, cfg.static_window, n_owners)
        q_fn = pol.as_q_fn(policy, ctl.n_actions(n_owners))
        return ctl.AdaptiveController(
            q_fn, params, n_owners, observe_headroom=observe_headroom
        )
    if cfg.q_fn is None:
        raise ValueError("greendygnn methods need a trained q_fn")
    if cfg.method == "greendygnn_nocw":
        base = cfg.q_fn
        n_a = n_owners + 1

        def q_fn(state, _base=base, _na=n_a):
            q = np.asarray(_base(state), np.float64).copy()
            mask = (np.arange(len(q)) % _na) != 0
            q[mask] = -1e18  # uniform-allocation actions only
            return q
    else:
        q_fn = cfg.q_fn
    return ctl.AdaptiveController(
        q_fn, params, n_owners, observe_headroom=observe_headroom
    )


def build_meter(cfg) -> EnergyMeter:
    return EnergyMeter(params=cfg.params, n_nodes=cfg.n_parts)


def build_pipeline(cfg, cache, store, fabric, requester: int, clock_fn,
                   device_tier=None, tracer=NULL_TRACER):
    """Threaded Stage-2 builder + Stage-3 prefetcher (async pipeline).

    With a device tier the builder also builds each window's device
    payload table, on the tier's own CUDA stream."""
    from repro_torch.pipeline import CacheBuilder, PrefetchQueue

    build_table = None
    if device_tier is not None:
        def build_table(plan, features):
            return device_tier.build(plan, store.peek_rows,
                                     fetched_rows=features, background=True)

    builder = CacheBuilder(
        cache, store.peek_rows,
        fabric=fabric, bytes_per_row=store.bytes_per_row,
        requester=requester, clock_fn=clock_fn, build_table=build_table,
        tracer=tracer,
    ).start()
    prefetcher = PrefetchQueue(
        store.peek_rows,
        depth=max(int(cfg.prefetch_depth), 1),
    ).start()
    return builder, prefetcher


def worker_rngs(seed: int, n_workers: int) -> list[np.random.Generator]:
    """Independent per-worker RNG streams via ``SeedSequence.spawn``.

    Rank 0 consumes the ROOT stream, the single trainer's
    ``default_rng(seed + 17)`` trace stream, so a P=1 cluster replays the
    single-trainer run bit for bit; ranks >= 1 consume spawned children,
    independent of the root and of each other whatever the spawn order or
    thread scheduling.
    """
    root = np.random.SeedSequence(seed + 17)
    children = root.spawn(max(n_workers - 1, 0))
    return [np.random.default_rng(root)] + [
        np.random.default_rng(c) for c in children
    ]


class TrainerWorker:
    """One partition's training substrate with explicit step methods.

    Drive it as::

        w = TrainerWorker(cfg, bundle, rank=0, fabric=fabric)
        try:
            for epoch in range(cfg.n_epochs):
                w.begin_epoch(epoch)
                for step in range(cfg.steps_per_epoch):
                    w.step(epoch, step)
                w.end_epoch(epoch)
        finally:
            w.close()
        result = w.result()

    ``cluster=True`` marks the worker as one of P trainers sharing the
    fabric: transfers carry ``requester=rank`` and the worker's own
    virtual clock, and the shared fabric's ticked clock is left alone.
    """

    def __init__(self, cfg, trace_bundle, rank: int = 0, fabric=None,
                 cluster: bool = False):
        check_supported(cfg)
        self.cfg = cfg
        self.rank = int(rank)
        self.device = resolve(cfg.device)
        self.fabric = fabric
        self.cluster = bool(cluster)
        self.requester = self.rank if cluster else 0
        # the one requester of a P=1 run ticks the fabric's own clock (the
        # builder thread may read it); a cluster worker never does
        self._owns_clock = fabric is not None and not cluster

        graph, owner, traces, mbs = trace_bundle
        self.graph, self.owner = graph, owner
        self.traces, self.mbs = traces, mbs
        params = cfg.params
        self.params = params
        self.n_owners = cfg.n_parts - 1

        self.mem_budget = getattr(cfg, "mem_budget", None)
        self.store = build_store(
            graph, owner, self.rank, cfg.n_parts, budget=self.mem_budget
        )
        # tiered = the host tier is budgeted (an unlimited budget keeps the
        # monolithic accounting bit for bit: no touches, no block traffic,
        # a constant 1.0 headroom that is never observed)
        self.tiered = getattr(self.store, "host", None) is not None
        self.owner_idx_map = self.store.owner_index(np.arange(graph.n_nodes))
        self.bytes_per_row = self.store.bytes_per_row

        self.windowed = cfg.method in WINDOWED_METHODS
        self.cache = build_cache(cfg, graph, self.owner_idx_map)
        self.controller = build_controller(
            cfg, params, self.n_owners, observe_headroom=self.tiered
        )
        self.meter = build_meter(cfg)

        # greentrace: null object when disabled; every hot-path emission
        # site guards on the single `tracer.enabled` attribute, so the
        # untraced modeled lane does no event work
        self.tracer = NULL_TRACER
        self._trace_tiers: dict = {}
        if cfg.trace:
            self.tracer = Tracer(rank=self.rank, params=params)
            if fabric is not None:
                fabric.set_tracer(self.requester, self.tracer)

        # device payload tier: real capacity-bounded rows over the hot
        # cache, hit path served through the embedding_bag kernel
        self.device_tier = None
        if (
            self.mem_budget is not None
            and getattr(self.mem_budget, "device_payloads", False)
            and self.cache is not None
        ):
            from repro_torch.store import DevicePayloadTier

            n_feat = (
                graph.features.shape[1]
                if graph.features is not None
                else graph.feature_source.n_feat
            )
            self.device_tier = DevicePayloadTier(
                self.cache, n_feat, device=self.device
            )

        self.engine = None
        if cfg.compute == "measured" and self.mbs is not None:
            # measured lane: a real SAGE step each trainer step; its time
            # replaces the modeled t_base charge below
            self.engine = ComputeEngine(graph, cfg)
        # the card whose peaks price a traced measured step (None on the
        # CPU; a CUDA card missing from the table raises here)
        self._peaks = (
            device_peaks(self.device)
            if self.tracer.enabled and self.engine is not None else None
        )
        self.model_state = None
        if cfg.run_model and self.engine is None:
            from repro_torch.train import gnn_trainer as gt

            self.model_state = gt._init_model(graph, cfg)

        self.t_base = float(params.t_base)
        self.window = (
            cfg.static_window if self.windowed else cfg.steps_per_epoch
        )
        self.weights = np.full(self.n_owners, 1.0 / self.n_owners)

        self.hit_rates: list = []
        self.windows_log: list = []
        self.acc_log: list = []
        self.sigma_log: list = []
        self.wall_log: list = []
        self.e_baseline = None
        self.window_left = 0
        self.pending_rebuild_cost = 0.0
        self.window_stats = CacheStats()
        self.meter_snapshot: dict = {}
        self.step_hits: list[int] = []
        self.step_misses: list[int] = []
        self.fetched_rows_by_owner = np.zeros(self.n_owners, np.float64)
        self.sync_wait_s = 0.0       # cluster: cumulative barrier wait
        self.sync_coll_s = 0.0       # cluster: cumulative collective time

        # per-epoch scratch
        self._clk = NetClock()
        self.delta = np.zeros(self.n_owners)
        self.sigma_true = np.ones(self.n_owners)
        self.epoch_stats = CacheStats()
        self.epoch_windows: list = []
        self.epoch_sigmas: list = []
        self._wall0 = 0.0

        # threaded pipeline
        self.use_async = (
            bool(cfg.async_pipeline) and self.windowed
            and self.cache is not None
        )
        self.builder = self.prefetcher = None
        self.pending_ticket = None
        self.pending_window, self.pending_weights = self.window, self.weights
        if self.use_async:
            self.builder, self.prefetcher = build_pipeline(
                cfg, self.cache, self.store, fabric, self.requester,
                self._current_clock, self.device_tier, self.tracer,
            )

    # --------------------------------------------------------------- clocks
    def _current_clock(self) -> NetClock:
        """The worker's virtual clock (for builder-thread fabric calls)."""
        return self._clk

    def _tick(self, gstep: int, epoch: int) -> NetClock:
        """Advance the worker's virtual network clock to its meter's wall
        time (and tick the fabric with it when the worker owns it)."""
        clk = NetClock(self.meter.wall_s, gstep, epoch)
        self._clk = clk
        if self._owns_clock:
            self.fabric.tick(clk.t_s, clk.step, clk.epoch)
        return clk

    # ------------------------------------------------------ network substrate
    def _net_bulk(self, per_owner_rows, delta):
        """ONE consolidated bulk RPC per owner through the active substrate.

        Returns (raw, cpu, bytes, n_rpcs, per_owner_s): ``per_owner_s`` is
        the fabric's per-owner wall latency (None on the closed form, which
        reconstructs it from Eq. 4 where needed)."""
        from repro_torch.train import gnn_trainer as gt

        rows = np.asarray(per_owner_rows, np.float64)
        if self.fabric is not None:
            tr = self.fabric.transfer(
                rows, self.bytes_per_row,
                requester=self.requester, clock=self._clk,
            )
            return (*tr.astuple(), tr.per_owner_s)
        return (
            *gt._fetch_time(self.params, rows, delta, self.bytes_per_row),
            None,
        )

    def _net_chunked(self, per_owner_rows, delta, at_s=None):
        """Fine-grained DistTensor round (DGL/BGL) through the substrate;
        ``at_s`` issues it at a later virtual time on the fabric."""
        from repro_torch.train import gnn_trainer as gt

        cfg = self.cfg
        rows = np.asarray(per_owner_rows, np.float64)
        if self.fabric is not None:
            tr = self.fabric.transfer(
                rows, self.bytes_per_row, at_s=at_s,
                chunk=cfg.dgl_chunk, concurrency=cfg.dgl_concurrency,
                requester=self.requester, clock=self._clk,
            )
            return (*tr.astuple(), tr.per_owner_s)
        return (
            *gt._chunked_fetch_time(
                self.params, rows, delta, self.bytes_per_row,
                cfg.dgl_chunk, cfg.dgl_concurrency,
            ),
            None,
        )

    def _block_charge(self, node_ids, delta, raw=0.0, cpu=0.0, nbytes=0.0,
                      nrpc=0):
        """Stage ``node_ids``'s host-tier blocks and add their traffic to
        the running (raw, cpu, bytes, n_rpcs): remote blocks as one bulk
        fetch on the substrate, then local blocks as a host read at
        ``host_read_factor`` of the wire byte cost, in the reference's
        order of additions."""
        charge = self.store.touch(node_ids)
        if charge is not None and not charge.empty:
            if charge.per_owner_rows.any():
                braw, bcpu, bb, br, _ = self._net_bulk(
                    charge.per_owner_rows, delta
                )
                raw += braw
                cpu += bcpu
                nbytes += bb
                nrpc += br
            if charge.local_rows:
                t_local = (
                    charge.local_rows * self.bytes_per_row
                    * float(self.params.beta)
                    * float(self.mem_budget.host_read_factor)
                )
                raw += t_local
                cpu += t_local
        return raw, cpu, nbytes, nrpc

    def _stage_plan(self, plan, delta, raw, cpu, nbytes, nrpc):
        """Pin the plan's blocks FIRST (so staging its own fetch rows can
        never evict them), then stage the fetched rows' blocks, adding
        their traffic to the rebuild's."""
        self.store.pin_window(plan.hot_nodes)
        return self._block_charge(plan.hot_nodes[plan.fetched], delta,
                                  raw, cpu, nbytes, nrpc)

    # ------------------------------------------------------------- controller
    def _decide(self, exposed_stall: float, step: int):
        """Controller decision from the just-finished window."""
        from repro_torch.train import gnn_trainer as gt

        cfg = self.cfg
        obs_stats = (
            self.window_stats
            if self.window_stats.hits + self.window_stats.misses
            else self.epoch_stats
        )
        stats = gt._controller_stats(
            obs_stats, self.meter, self.t_base, self.e_baseline,
            step, cfg.steps_per_epoch, self.n_owners,
            snapshot=self.meter_snapshot,
            rebuild_stall=exposed_stall,
            headroom=(self.store.headroom() if self.tiered else 1.0),
        )
        w, ww, action = self.controller.decide(stats)
        if cfg.method == "greendygnn_nocw":
            ww = np.full(self.n_owners, 1.0 / self.n_owners)
        if self.tracer.enabled:
            # the observation the policy saw and the (W, allocation) it
            # chose
            self.tracer.instant(
                "controller", "decide", self.meter.wall_s, step=step,
                args={
                    "action": int(action),
                    "window": int(w),
                    "weights": [float(x) for x in ww],
                    "sigma_hat": [
                        float(x) for x in np.atleast_1d(
                            self.controller.last_sigma
                        )
                    ],
                    "obs": [
                        float(x) for x in np.atleast_1d(
                            self.controller.last_state
                        )
                    ],
                },
            )
        return w, ww

    # -------------------------------------------------------------- tracing
    def _trace_step(self, epoch, step, t_compute, stall, rebuild_stall,
                    ar_penalty, cpu_comm, nbytes, nrpc, gpu_overlap,
                    fetch_raw) -> None:
        """Emit the step's charge event (and the measured compute span).

        Builds the exact :class:`StepSample` the meter is about to record,
        from the same expressions in the same order, so the ledger replay
        reconciles bit for bit. Only reached when ``tracer.enabled``.
        """
        t0 = self.meter.wall_s
        gstep = epoch * self.cfg.steps_per_epoch + step
        if self.engine is not None and self.engine.step_edges:
            # the reference's per-edge estimate of the measured SAGE step
            # (order-of-magnitude attribution, not a fitted law), priced at
            # the card's fp32 peaks: the step runs in float32
            n_edges = int(self.engine.step_edges[-1])
            width = float(self.engine.mcfg.d_in + self.engine.mcfg.d_hidden)
            flops = 2.0 * n_edges * width
            nbyte = 4.0 * n_edges * width
            args = {"n_edges": n_edges, "flops_est": flops,
                    "bytes_est": nbyte, "roof_device": "cpu"}
            if self._peaks is not None:
                comp_s, mem_s = self._peaks.terms(flops, nbyte)
                args.update(
                    roof_device=self._peaks.name, roof_compute_s=comp_s,
                    roof_memory_s=mem_s,
                    bound="memory" if mem_s >= comp_s else "compute",
                )
            self.tracer.span(
                "compute", "measured", t0, t0 + t_compute, step=gstep,
                epoch=epoch, args=args,
            )
        self.tracer.charge_step(
            t0,
            StepSample(
                t_compute=t_compute,
                t_stall=stall + rebuild_stall + ar_penalty,
                t_cpu_comm=cpu_comm,
                remote_bytes=nbytes,
                n_rpcs=nrpc,
                gpu_overlap=gpu_overlap,
            ),
            step=gstep, epoch=epoch,
            args={"fetch_s": float(fetch_raw), "exposed_s": float(stall),
                  "rebuild_s": float(rebuild_stall),
                  "ar_s": float(ar_penalty)},
        )

    def _trace_tier_counters(self, t0, step, epoch) -> None:
        """Per-window tier counter deltas (device-hit / host-hit /
        CLOCK-eviction / remote-miss attribution between boundaries).
        Only reached when ``tracer.enabled``."""
        if not self.tiered:
            return
        counts = self.store.tier_stats.counts()
        delta = {
            k: (v if k == "peak_resident_bytes"
                else v - self._trace_tiers.get(k, 0))
            for k, v in counts.items()
        }
        self._trace_tiers = counts
        self.tracer.counter("store", "tier-window", t0, step=step,
                            epoch=epoch, args=delta)

    # ------------------------------------------------------------ epoch hooks
    def begin_epoch(self, epoch: int) -> None:
        from repro_torch.train import gnn_trainer as gt

        cfg = self.cfg
        if self.fabric is not None:
            # fabric path: delta/sigma vary within the epoch; refreshed per
            # step, the epoch log gets the step mean
            clk = self._tick(epoch * cfg.steps_per_epoch, epoch)
            self.delta = self.fabric.delta_ms(clk, requester=self.requester)
            self.sigma_true = self.fabric.sigma(clk, requester=self.requester)
            self.epoch_sigmas = []
        else:
            self.delta = gt._closed_form_delta(cfg, epoch, self.n_owners)
            self.sigma_true = np.asarray(
                [float(cm.sigma_from_delta(self.params, d))
                 for d in self.delta]
            )
            self.sigma_log.append(self.sigma_true)
        self.epoch_stats = CacheStats()
        self.epoch_windows = []
        self._wall0 = self.meter.wall_s
        trace = self.traces[epoch]

        if cfg.method == "rapidgnn" and self.cache is not None:
            # epoch-level rebuild from the full presampled epoch trace
            remote = [self.store.remote_ids_of(t) for t in trace]
            plan = self.cache.plan_window(remote, self.weights)
            raw, cpu_rb, nbytes, nrpc, _ = self._net_bulk(
                plan.per_owner_fetched.astype(np.float64), self.delta
            )
            if self.tiered:
                raw, cpu_rb, nbytes, nrpc = self._stage_plan(
                    plan, self.delta, raw, cpu_rb, nbytes, nrpc
                )
            if self.device_tier is not None:
                self.device_tier.load(plan, self.store.peek_rows)
            if self.tracer.enabled:
                # the same charge laws in the order of the two meter calls
                # below (ledger order == meter order)
                t0 = self.meter.wall_s
                self.tracer.charge_background(
                    t0, cpu_rb, component="epoch-cache", name="epoch-rebuild",
                    epoch=epoch,
                    args={"bytes": float(nbytes), "rpcs": int(nrpc),
                          "fetch_s": float(raw),
                          "rows": float(plan.per_owner_fetched.sum())},
                )
                self.tracer.charge_step(
                    t0,
                    StepSample(0.0, float(self.params.alpha_crit) * raw, 0.0),
                    component="epoch-cache", name="leak", epoch=epoch,
                )
                self._trace_tier_counters(t0, 0, epoch)
            self.meter.record_background(cpu_rb, nbytes, nrpc)
            self.meter.record_step(
                StepSample(0.0, float(self.params.alpha_crit) * raw, 0.0)
            )
            self.cache.swap(plan)
            self.fetched_rows_by_owner += plan.per_owner_fetched

        if self.prefetcher is not None:
            # Stage-3: resolve this epoch's batch payloads up to Q ahead
            self.prefetcher.schedule(list(trace))

    def end_epoch(self, epoch: int) -> None:
        cfg = self.cfg
        self.meter.mark_epoch()
        if self.fabric is not None:
            self.sigma_log.append(
                np.mean(self.epoch_sigmas, axis=0)
                if self.epoch_sigmas else self.sigma_true
            )
        self.hit_rates.append(self.epoch_stats.hit_rate())
        self.windows_log.append(
            float(np.mean(self.epoch_windows)) if self.epoch_windows else 0
        )
        self.wall_log.append(self.meter.wall_s - self._wall0)
        if cfg.run_model and self.model_state is not None:
            from repro_torch.train import gnn_trainer as gt

            st = self.model_state
            self.acc_log.append(gt._model_eval(st["params"], st["cfg"],
                                               self.graph, st["device"]))
        elif cfg.run_model and self.engine is not None:
            self.acc_log.append(self.engine.model_eval(self.graph))
        if self.controller is not None and epoch == cfg.warmup_epochs - 1:
            self.controller.observe_warmup()
        if epoch == cfg.warmup_epochs - 1:
            kj = self.meter.totals_kj()["total_kj"]
            steps = cfg.warmup_epochs * cfg.steps_per_epoch
            self.e_baseline = kj * 1e3 / max(steps, 1) / cfg.n_parts

    # ------------------------------------------------------------------- step
    def step(self, epoch: int, step: int) -> None:
        cfg = self.cfg
        trace = self.traces[epoch]
        input_nodes = trace[step]
        remote_ids = self.store.remote_ids_of(input_nodes)

        if self.fabric is not None:
            # advance the virtual network clock; congestion state is a
            # function of (this worker's wall time, global step) only
            clk = self._tick(epoch * cfg.steps_per_epoch + step, epoch)
            self.delta = self.fabric.delta_ms(clk, requester=self.requester)
            self.sigma_true = self.fabric.sigma(clk, requester=self.requester)
            self.epoch_sigmas.append(self.sigma_true)
        delta, sigma_true = self.delta, self.sigma_true

        # ---- windowed rebuild boundary ----
        if self.windowed and self.window_left <= 0:
            adaptive_now = (
                self.controller is not None and epoch >= cfg.warmup_epochs
            )
            if not self.use_async:
                self._rebuild_sync(adaptive_now, epoch, step, delta)
            else:
                self._rebuild_async(adaptive_now, epoch, step, delta)
            self.window_left = self.window
        self.epoch_windows.append(self.window)

        # ---- resolve features ----
        if self.prefetcher is not None:
            # real payload gather, resolved ahead by the Stage-3 queue and
            # discarded, as the reference does (its timings land in the
            # PipelineReport; classification below stays synchronous so
            # the hit/miss stream is unperturbed)
            self.prefetcher.get()
        if self.cache is not None:
            # one searchsorted probe recorded into both stat sinks
            miss_ids = self.cache.access(
                remote_ids, self.epoch_stats, self.window_stats
            )
        else:
            miss_ids = remote_ids
        self.step_hits.append(len(remote_ids) - len(miss_ids))
        self.step_misses.append(len(miss_ids))
        per_owner = np.zeros(self.n_owners, np.float64)
        if len(miss_ids):
            oi = self.owner_idx_map[miss_ids]
            per_owner += np.bincount(oi, minlength=self.n_owners)
            self.fetched_rows_by_owner += per_owner

        device_rows = None
        if self.device_tier is not None and len(remote_ids):
            # hit path: real payload rows gathered on the device tier
            # through the embedding_bag kernel, left on the device
            # (timings and the hit/miss stream above are untouched)
            device_rows = self.device_tier.gather(remote_ids)
            self.store.tier_stats.device_hits += int(device_rows[0].sum())

        # ---- host tier: stage this step's working set ----
        # blocks are touched for the rows the step reads from host memory
        # (local rows + remote misses; device hits stay on the device); the
        # block traffic is issued BEFORE the miss fetch, so memory pressure
        # queues on the same owner links as the misses
        blk_raw = blk_cpu = blk_bytes = 0.0
        blk_rpcs = 0
        if self.tiered:
            local_ids = input_nodes[
                self.owner[np.asarray(input_nodes)] == self.rank
            ]
            blk_raw, blk_cpu, blk_bytes, blk_rpcs = self._block_charge(
                np.concatenate([np.asarray(local_ids, np.int64),
                                np.asarray(miss_ids, np.int64)]),
                delta,
            )

        gpu_overlap = 0.0
        if cfg.method in ("dgl", "bgl"):
            # fine-grained per-layer rounds of small DistTensor RPCs;
            # the second layer round issues after the first completes
            rows1 = np.floor(per_owner * 0.5)
            s1, c1, b1, r1, po1 = self._net_chunked(rows1, delta)
            s2, c2, b2, r2, po2 = self._net_chunked(
                per_owner - rows1, delta,
                at_s=(
                    (self.meter.wall_s + s1)
                    if self.fabric is not None else None
                ),
            )
            raw, cpu, nbytes, nrpc = s1 + s2, c1 + c2, b1 + b2, r1 + r2
            per_owner_s = po1 + po2 if po1 is not None else None
            if cfg.method == "bgl":
                # BGL prefetches during sampling: part of the latency is
                # hidden, and GPU idle energy drops further (Section II-B)
                slack = cfg.bgl_depth * self.t_base
                gpu_overlap = cfg.bgl_overlap_frac
            else:
                slack = 0.0
        else:
            # consolidated bulk fetch of misses; the Stage-3 async queue
            # (depth Q) hides up to Q * t_base of latency (Section II-B)
            raw, cpu, nbytes, nrpc, per_owner_s = self._net_bulk(
                per_owner, delta
            )
            slack = cfg.prefetch_depth * self.t_base

        # block staging extends the exposed fetch path: the miss fetch
        # cannot complete before its blocks are resident
        stall = max(0.0, raw + blk_raw - slack)
        rebuild_stall = (
            self.pending_rebuild_cost / max(self.window, 1)
            if self.windowed else 0.0
        )
        ar_penalty = (
            float(self.params.kappa_ar) * max(sigma_true.max() - 1.0, 0)
        )
        if self.engine is not None:
            # measured lane: the real step over this batch's resolved
            # payload rows; its time is charged where the modeled lane
            # charges the t_base constant
            mb = self.mbs[epoch][step]
            x_in = self._resolve_features(input_nodes, remote_ids,
                                          device_rows)
            t_compute = self.engine.step(mb, x_in, key=(epoch, step))
        else:
            t_compute = self.t_base
        if self.tracer.enabled:
            self._trace_step(
                epoch, step, t_compute, stall, rebuild_stall, ar_penalty,
                cpu + blk_cpu, nbytes + blk_bytes, nrpc + blk_rpcs,
                gpu_overlap, raw + blk_raw,
            )
        self.meter.record_step(
            StepSample(
                t_compute=t_compute,
                t_stall=stall + rebuild_stall + ar_penalty,
                t_cpu_comm=cpu + blk_cpu,
                remote_bytes=nbytes + blk_bytes,
                n_rpcs=nrpc + blk_rpcs,
                gpu_overlap=gpu_overlap,
            )
        )

        # feed the fetch-time deque (per-owner per-RPC observations,
        # including the raw injected RTT so Eq. 8 can see congestion); the
        # fabric path uses its per-owner wall latency, so queueing delays
        # are visible to the controller too
        if self.controller is not None:
            for o in range(self.n_owners):
                if per_owner[o] > 0:
                    if per_owner_s is not None:
                        t_o = float(per_owner_s[o])
                    else:
                        payload_o = per_owner[o] * self.bytes_per_row
                        t_o = cm.rpc_wall_s(
                            float(self.params.alpha_rpc),
                            float(self.params.beta),
                            float(self.params.gamma_c),
                            payload_o,
                            delta[o],
                        )
                    self.controller.deque.append(
                        o, t_o / max(per_owner[o], 1)
                    )

        if cfg.run_model and self.model_state is not None:
            from repro_torch.train import gnn_trainer as gt

            self.model_state = gt._model_step(
                self.model_state, self.mbs[epoch][step]
            )

        self.window_left -= 1

    # ------------------------------------------------------ rebuild boundary
    def _rebuild_sync(self, adaptive_now, epoch, step, delta) -> None:
        """Analytic double-buffer model (alpha_crit leak). On the fabric the
        rebuild's wire time also occupies the owner links, so the next miss
        fetches queue behind it."""
        cfg = self.cfg
        if self.tracer.enabled:
            self.tracer.begin_window(
                self.meter.wall_s,
                step=epoch * cfg.steps_per_epoch + step, epoch=epoch,
            )
        if adaptive_now:
            self.window, self.weights = self._decide(
                self.pending_rebuild_cost / max(self.window, 1), step
            )
        else:
            self.window = cfg.static_window
        self.window_stats = CacheStats()
        self.meter_snapshot = {
            "n": self.meter.n_steps, "wall": self.meter.wall_s,
            "energy": self.meter.gpu_j + self.meter.cpu_j,
        }
        trace = self.traces[epoch]
        upcoming = [
            self.store.remote_ids_of(t)
            for t in trace[step : step + self.window]
        ]
        plan = self.cache.plan_window(upcoming, self.weights)
        raw_rb, cpu_rb, nbytes, nrpc, _ = self._net_bulk(
            plan.per_owner_fetched.astype(np.float64), delta
        )
        # the fetch runs on a hypothetical builder thread (background CPU
        # energy); alpha_crit of it leaks onto the critical path, amortized
        # over the window
        if self.tiered:
            raw_rb, cpu_rb, nbytes, nrpc = self._stage_plan(
                plan, delta, raw_rb, cpu_rb, nbytes, nrpc
            )
        if self.device_tier is not None:
            # the table is built out of the OLD active one (persisted rows
            # are gathered device-to-device, on the current stream), so
            # load before swap
            self.device_tier.load(plan, self.store.peek_rows)
        if self.tracer.enabled:
            t0 = self.meter.wall_s
            self.tracer.charge_background(
                t0, cpu_rb, component="rebuild", name="rebuild-sync",
                step=epoch * cfg.steps_per_epoch + step, epoch=epoch,
                args={"bytes": float(nbytes), "rpcs": int(nrpc),
                      "fetch_s": float(raw_rb),
                      "leak_s": float(self.params.alpha_crit) * raw_rb,
                      "window": int(self.window),
                      "rows": float(plan.per_owner_fetched.sum())},
            )
            self._trace_tier_counters(
                t0, epoch * cfg.steps_per_epoch + step, epoch
            )
        self.meter.record_background(cpu_rb, nbytes, nrpc)
        self.pending_rebuild_cost = float(self.params.alpha_crit) * raw_rb
        self.cache.swap(plan)
        self.fetched_rows_by_owner += plan.per_owner_fetched

    def _rebuild_async(self, adaptive_now, epoch, step, delta) -> None:
        """The threaded pipeline (measured wall times): wait for the build
        submitted one boundary ahead, swap to it, and submit the next."""
        from repro_torch.train import gnn_trainer as gt

        cfg = self.cfg
        trace = self.traces[epoch]
        if self.tracer.enabled:
            self.tracer.begin_window(
                self.meter.wall_s,
                step=epoch * cfg.steps_per_epoch + step, epoch=epoch,
            )
        if self.pending_ticket is None:
            # cold start: nothing was built ahead; the rebuild is fully
            # exposed, exactly like the sync path
            if adaptive_now:
                self.window, self.weights = self._decide(
                    self.pending_rebuild_cost / max(self.window, 1), step
                )
            else:
                self.window = cfg.static_window
            upcoming = [
                self.store.remote_ids_of(t)
                for t in trace[step : step + self.window]
            ]
            buf, exposed = self.builder.build_sync(upcoming, self.weights)
        else:
            buf, exposed = self.builder.wait(self.pending_ticket)
            self.window, self.weights = (
                self.pending_window, self.pending_weights
            )
            self.pending_ticket = None
        plan = buf.plan
        blk_cpu = blk_bytes = 0.0
        blk_rpcs = 0
        if self.tiered:
            # consumer-thread residency update at the swap boundary (the
            # builder's fetch itself goes through the pure peek_rows):
            # re-pin to the new plan, then stage its fetch rows; the block
            # traffic's wire time is not charged here, only its CPU time
            _, blk_cpu, blk_bytes, blk_rpcs = self._stage_plan(
                plan, delta, 0.0, 0.0, 0.0, 0
            )
        if self.device_tier is not None:
            # the builder built the table on its own stream: the compute
            # stream waits for it, then the pointer flips (before the
            # cache's swap, which the table's generation must match)
            self.device_tier.install(buf.table)
        self.builder.swap(buf)
        if buf.net is not None:
            # bulk fetch already issued through the fabric on the builder
            # thread (shared Fabric.transfer API)
            raw_rb, cpu_rb, nbytes, nrpc = buf.net.astuple()
        else:
            raw_rb, cpu_rb, nbytes, nrpc = gt._fetch_time(
                self.params,
                plan.per_owner_fetched.astype(np.float64),
                delta, self.bytes_per_row,
            )
        # measured: builder work burned real host CPU in the background;
        # only the MEASURED exposed wait leaks onto the critical path (no
        # alpha_crit approximation)
        if self.tracer.enabled:
            t0 = self.meter.wall_s
            self.tracer.charge_background(
                t0, cpu_rb + buf.t_plan_s + buf.t_fetch_s + blk_cpu,
                component="rebuild", name="rebuild-async",
                step=epoch * cfg.steps_per_epoch + step, epoch=epoch,
                args={"bytes": float(nbytes + blk_bytes),
                      "rpcs": int(nrpc + blk_rpcs),
                      "fetch_s": float(raw_rb),
                      "exposed_s": float(exposed),
                      "plan_s": float(buf.t_plan_s),
                      "build_fetch_s": float(buf.t_fetch_s),
                      "window": int(self.window),
                      "rows": float(plan.per_owner_fetched.sum())},
            )
            self._trace_tier_counters(
                t0, epoch * cfg.steps_per_epoch + step, epoch
            )
        self.meter.record_background(
            cpu_rb + buf.t_plan_s + buf.t_fetch_s + blk_cpu,
            nbytes + blk_bytes, nrpc + blk_rpcs,
        )
        self.pending_rebuild_cost = exposed
        # decide the NEXT window one boundary ahead so its rebuild can
        # overlap this window's compute
        if adaptive_now:
            nxt_window, nxt_weights = self._decide(
                exposed / max(self.window, 1), step
            )
        else:
            nxt_window, nxt_weights = cfg.static_window, self.weights
        g_next = epoch * cfg.steps_per_epoch + step + self.window
        ne, ns = divmod(g_next, cfg.steps_per_epoch)
        if ne < cfg.n_epochs:
            upcoming = [
                self.store.remote_ids_of(t)
                for t in self.traces[ne][ns : ns + nxt_window]
            ]
            self.pending_ticket = self.builder.submit(upcoming, nxt_weights)
            self.pending_window, self.pending_weights = (
                nxt_window, nxt_weights,
            )
            if self.tiered:
                # widen the pin set to ALSO cover the submitted window's
                # working set: per-step touches in the current window must
                # not evict what the in-flight rebuild is prefetching
                # (narrowed back to the new plan at the swap boundary)
                self.store.pin_window(np.concatenate(
                    [np.asarray(plan.hot_nodes, np.int64)]
                    + [np.asarray(u, np.int64) for u in upcoming]
                ))
        self.window_stats = CacheStats()
        self.meter_snapshot = {
            "n": self.meter.n_steps, "wall": self.meter.wall_s,
            "energy": self.meter.gpu_j + self.meter.cpu_j,
        }
        self.fetched_rows_by_owner += plan.per_owner_fetched

    # ------------------------------------------------------------- features
    def _resolve_features(self, input_nodes, remote_ids, device_rows):
        """The measured step's input rows: the remote ids resident on the
        device tier stay on the device, where the embedding_bag kernel
        just gathered them (bit-equal to the store's rows), and only the
        other rows are peeked from the store on the host."""
        ids = np.asarray(input_nodes, np.int64)
        dev_pos = np.empty(0, np.int64)
        rows = None
        if device_rows is not None:
            hit_mask, rows = device_rows
            # remote_ids is the order-preserving remote subset of
            # input_nodes, so remote position k sits at rpos[k]
            dev_pos = np.flatnonzero(self.owner[ids] != self.rank)[hit_mask]
        host = np.ones(len(ids), bool)
        host[dev_pos] = False
        host_pos = np.flatnonzero(host)
        return InputRows(
            np.asarray(self.store.peek_rows(ids[host_pos]), np.float32),
            host_pos, rows, dev_pos,
        )

    # ------------------------------------------------------------ cluster sync
    def apply_sync(self, wait_s: float, coll_wall_s: float,
                   coll_cpu_s: float = 0.0, coll_bytes: float = 0.0,
                   coll_msgs: int = 0) -> None:
        """Charge this step's gradient-sync barrier wait + collective cost.

        Called on the worker's own thread after the cluster driver has
        published the step's charges (no thread races this meter)."""
        if self.tracer.enabled:
            self.tracer.charge_sync(
                self.meter.wall_s, wait_s + coll_wall_s,
                cpu_comm_s=coll_cpu_s,
                step=self._clk.step, epoch=self._clk.epoch,
                args={"wait_s": float(wait_s), "coll_s": float(coll_wall_s),
                      "bytes": float(coll_bytes), "msgs": int(coll_msgs)},
            )
        self.meter.record_sync(
            wait_s + coll_wall_s, cpu_comm_s=coll_cpu_s,
            remote_bytes=coll_bytes, n_rpcs=coll_msgs,
        )
        self.sync_wait_s += wait_s
        self.sync_coll_s += coll_wall_s

    # --------------------------------------------------------------- result
    def close(self) -> None:
        """Stop the worker's threads (idempotent; safe on error paths)."""
        if self.builder is not None:
            self.builder.stop()
        if self.prefetcher is not None:
            self.prefetcher.stop()

    def result(self):
        from repro_torch.train import gnn_trainer as gt

        report = None
        if self.use_async:
            from repro_torch.pipeline import PipelineReport

            report = PipelineReport.from_components(
                self.builder, self.prefetcher
            )
        tier_counts = (
            self.store.tier_stats.counts()
            if hasattr(self.store, "tier_stats") else None
        )
        return gt.RunResult(
            meter=self.meter,
            tier_counts=tier_counts,
            hit_rate_per_epoch=np.asarray(self.hit_rates),
            window_per_epoch=np.asarray(self.windows_log),
            sigma_trace=np.asarray(self.sigma_log),
            accuracy_per_epoch=(
                np.asarray(self.acc_log) if self.acc_log else None
            ),
            wall_time_per_epoch=np.asarray(self.wall_log),
            step_hits=np.asarray(self.step_hits, np.int64),
            step_misses=np.asarray(self.step_misses, np.int64),
            fetched_rows_by_owner=self.fetched_rows_by_owner,
            pipeline=report,
            compute_report=(
                self.engine.report() if self.engine is not None else None
            ),
            scenario=(
                "closed_form" if self.fabric is None else self.cfg.scenario
            ),
            trace=(
                self.tracer.section(self.meter)
                if self.tracer.enabled else None
            ),
        )
