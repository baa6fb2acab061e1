"""Concurrent P-worker cluster driver over one shared requester-aware fabric.

Port of ``repro/train/cluster.py``: P trainer partitions, each a
:class:`repro_torch.train.worker.TrainerWorker`, run concurrently over ONE
:class:`repro_torch.net.Fabric` in cluster topology, so the paper's
phenomena emerge from real cross-worker traffic instead of injected
background schedules:

  * incast at a hot feature owner: several workers' miss fetches and
    rebuild bulk fetches serialize at the same owner NIC;
  * rebuild interference: worker B's window rebuild occupies owner links
    and inflates worker A's fine-grained miss latency;
  * straggler feedback: a slow worker (``compute_scale``) drags everyone
    through the per-step gradient-sync barrier, unless bounded staleness
    (``max_stale``/``max_lag``, ``distributed.fault_tolerance``) lets the
    fast workers proceed.

Scheduling model (determinism contract). Workers run on real threads
(``trainer-worker-{rank}``), but congestion lives in *virtual* time: each
global step, all workers park at a step gate, the driver releases them
one at a time ordered by ``(virtual wall clock, rank)``, and each executes
its whole step (fabric transfers stamped with its own clock) while the
others wait. Arrival order at every NIC is therefore a function of
virtual time, never of OS thread scheduling. In the modeled lane, on the
synchronous rebuild path, same-seed runs are bit-identical (and equal to
the reference's). In the measured lane the virtual clock holds each
rank's measured step times, so the release order, and with it the fabric's
arrival order and every time-derived charge, may differ from run to run;
what does not depend on time (a static window's hit and miss streams, the
losses) does not.

On the card every worker thread enters the run's device, and launches its
kernels (the CSR SpMM of its SAGE step, the EmbeddingBag gather of its
device tier's hits) on that thread's current stream; the ranks run one at
a time, so they share the card without sharing any state. A failure in a
worker thread (a CUDA error included) reaches the gate, and the driver
re-raises it; no worker thread outlives :func:`run_cluster`.

Per-worker RNG is threaded through ``np.random.SeedSequence.spawn``
(``worker.worker_rngs``). The per-step gradient sync is costed with
``distributed.collectives.ring_collective_cost`` and charged through
``EnergyMeter.record_sync``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from repro_torch.analysis import runtime as _sanitizer
from repro_torch.distributed.collectives import ring_collective_cost
from repro_torch.distributed.fault_tolerance import BoundedStalenessBarrier
from repro_torch.graph import datasets
from repro_torch.graph.partition import partition_graph
from repro_torch.train.worker import TrainerWorker, worker_rngs

SYNC_MODES = ("allreduce", "reduce_scatter", "none")
JOIN_TIMEOUT_S = 60.0


@dataclasses.dataclass
class ClusterConfig:
    """Shape and physics of the P-worker cluster run."""

    n_workers: int = 2               # trainer ranks 0..P-1 (<= cfg.n_parts;
                                     # the other partitions are passive
                                     # feature servers)
    sync: str = "allreduce"          # per-step gradient sync: ring
                                     # all-reduce, reduce-scatter (ZeRO,
                                     # half the wire bytes), or none
    grad_bytes: float | None = None  # gradient payload per worker per step;
                                     # None = the SAGE model's
    max_stale: int = 0               # bounded staleness: up to max_stale
                                     # workers may miss a barrier ...
    max_lag: int = 1                 # ... by up to max_lag steps before the
                                     # step blocks
    silent_ranks: tuple = ()         # workers that run empty workloads: a
                                     # rank and a clock, no traffic
    methods: tuple | None = None     # per-rank methods (len P); None =
                                     # every rank runs cfg.method
    q_fns: tuple | None = None       # per-rank policies (len P); a None
                                     # entry keeps cfg.q_fn
    link_rate_scale: tuple | None = None
                                     # per-partition NIC rate multiplier
                                     # (len n_parts): a < 1 entry makes that
                                     # owner a hot/slow feature server
    compute_scale: tuple | None = None
                                     # per-rank t_base multiplier (len P):
                                     # > 1 makes that worker a compute
                                     # straggler (modeled lane)
    grad_compression: str = "none"   # gradient sync on the wire: "none" |
                                     # "int8" | "topk"; a compressed scheme
                                     # replaces the payload in the ring cost
                                     # with its wire bytes and runs each
                                     # measured-lane engine with error-
                                     # feedback compression
    topk_frac: float = 0.05          # kept fraction for "topk"


@dataclasses.dataclass
class ClusterReport:
    """Per-worker results + cluster totals + attribution."""

    n_workers: int
    n_parts: int
    scenario: str
    sync: str
    results: list                    # per-rank RunResult
    silent_ranks: tuple
    requester_metrics: list          # Fabric.requester_metrics() per rank
    sync_wait_s: np.ndarray          # per-rank cumulative barrier wait
    sync_coll_s: np.ndarray          # per-rank cumulative collective time
    total_queue_s: float             # fabric-wide emergent queueing
    methods: tuple = ()              # per-rank method actually deployed
    grad_compression: str = "none"   # wire scheme the collective charged
    grad_wire_bytes: float = 0.0     # per-worker per-sync payload bytes fed
                                     # to ring_collective_cost

    @property
    def active_ranks(self) -> list[int]:
        return [
            r for r in range(self.n_workers) if r not in self.silent_ranks
        ]

    def totals_kj(self) -> dict:
        """Cluster totals: the raw node energy of each active worker summed
        (each meter measures ITS node, no symmetric x n_parts scaling as
        in the single trainer's ``RunResult.totals``); wall = the slowest
        worker."""
        act = self.active_ranks
        gpu = sum(self.results[r].meter.gpu_j for r in act)
        cpu = sum(self.results[r].meter.cpu_j for r in act)
        return {
            "gpu_kj": gpu / 1e3,
            "cpu_kj": cpu / 1e3,
            "total_kj": (gpu + cpu) / 1e3,
            "wall_s": max(
                (self.results[r].meter.wall_s for r in act), default=0.0
            ),
        }

    def tier_counts(self) -> dict | None:
        """Cluster-wide per-tier counts: the ranks' ``TierStats`` summed
        (the resident peak takes the max: the budget is per rank). ``None``
        when no rank ran a tiered store."""
        from repro_torch.store.budget import merge_tier_counts

        return merge_tier_counts(
            [self.results[r].tier_counts for r in self.active_ranks]
        )

    def pipeline_totals(self) -> dict | None:
        """Cluster-wide pipeline telemetry: the ranks' ``PipelineReport``
        summaries merged by the shared reduce law (sum the cumulative
        counters, MAX the watermarks), the overlap efficiency recomputed
        from the merged totals. ``None`` when no rank ran the threaded
        pipeline."""
        from repro_torch.obs.reduce import merge_counters

        summaries = [
            self.results[r].pipeline.summary() for r in self.active_ranks
            if self.results[r].pipeline is not None
        ]
        for s in summaries:
            # per-rank ratios and means do not merge; recomputed below
            s.pop("overlap_efficiency", None)
            s.pop("swap_latency_mean_s", None)
            s.pop("prefetch_mean_lead_s", None)
        out = merge_counters(
            summaries,
            max_keys=("swap_latency_max_s", "prefetch_max_wait_s"),
        )
        if out is None:
            return None
        out["overlap_efficiency"] = (
            out["hidden_s"] / out["builder_wall_s"]
            if out["builder_wall_s"] > 0 else 1.0
        )
        return out

    def requester_totals(self) -> dict | None:
        """Fabric traffic summed over the active requesters, the mean
        transfer latency recomputed from the merged totals."""
        from repro_torch.obs.reduce import merge_counters

        rows = []
        for r in self.active_ranks:
            row = dict(self.requester_metrics[r])
            row.pop("mean_transfer_s", None)
            rows.append(row)
        out = merge_counters(rows)
        if out is None:
            return None
        out["mean_transfer_s"] = (
            out["wall_s"] / out["n_transfers"]
            if out["n_transfers"] > 0 else 0.0
        )
        return out

    def per_worker(self) -> list[dict]:
        rows = []
        for r in range(self.n_workers):
            m = self.results[r].meter
            net = self.requester_metrics[r]
            cr = self.results[r].compute_report
            rows.append({
                "rank": r,
                "method": self.methods[r] if self.methods else None,
                "silent": r in self.silent_ranks,
                "grad_compression": self.grad_compression,
                "grad_wire_bytes": (
                    0.0 if r in self.silent_ranks else self.grad_wire_bytes
                ),
                "measured_step_s": (
                    float(np.mean(cr["step_s"]))
                    if cr and cr["step_s"] else None
                ),
                "total_kj": (m.gpu_j + m.cpu_j) / 1e3,
                "wall_s": m.wall_s,
                "hit_rate": float(
                    np.mean(self.results[r].hit_rate_per_epoch)
                ) if len(self.results[r].hit_rate_per_epoch) else 0.0,
                "bytes": net["bytes"],
                "queue_s": net["queue_s"],
                "mean_transfer_s": net["mean_transfer_s"],
                "sync_wait_s": float(self.sync_wait_s[r]),
                "sync_coll_s": float(self.sync_coll_s[r]),
                "tier_counts": self.results[r].tier_counts,
            })
        return rows


def default_grad_bytes(graph, d_hidden: int = 16) -> float:
    """fp32 bytes of the GraphSAGE model the trainer runs
    (d_in -> 16 -> n_classes)."""
    if graph.features is not None:
        d_in = int(graph.features.shape[1])
    else:
        d_in = int(graph.feature_source.n_feat)
    n_cls = int(graph.labels.max()) + 1
    n_params = (
        2 * d_in * d_hidden + d_hidden          # layer 1 (self+neigh) + bias
        + 2 * d_hidden * n_cls + n_cls          # layer 2
    )
    return 4.0 * n_params


def build_cluster_traces(cfg, n_workers: int, silent_ranks: tuple = (),
                         graph=None, owner=None) -> list:
    """Per-rank trace bundles over ONE shared graph/partition.

    Rank r presamples from partition r with its own SeedSequence-spawned
    stream; silent ranks get empty per-step batches (a clock and a rank,
    zero traffic)."""
    from repro_torch.train import gnn_trainer as gt

    if graph is None:
        # the graph/partition are fixtures shared by every method and seed
        graph = datasets.materialize(cfg.dataset, seed=0)
    if owner is None:
        owner = partition_graph(graph, cfg.n_parts, seed=0)
    rngs = worker_rngs(cfg.seed, n_workers)
    empty = np.empty(0, np.int64)
    bundles = []
    for r in range(n_workers):
        if r in silent_ranks:
            traces = [
                [empty for _ in range(cfg.steps_per_epoch)]
                for _ in range(cfg.n_epochs)
            ]
            bundles.append((graph, owner, traces, None))
        else:
            bundles.append(
                gt.build_trace(cfg, rank=r, rng=rngs[r], graph=graph,
                               owner=owner)
            )
    return bundles


class _ClusterAbort(RuntimeError):
    """Secondary-thread unwind after another worker already failed."""


class _StepGate:
    """Deterministic per-step turnstile for the worker threads.

    Phase A (``arrive``): all workers park; the driver releases them one
    at a time in (virtual wall, rank) order and each runs its full step.
    Phase B (``finish_step``): workers block until the driver has computed
    the step's barrier/collective charges, then apply them to their own
    meters. No worker ever touches another worker's state.
    """

    def __init__(self, ranks):
        self.ranks = frozenset(ranks)
        self.cv = threading.Condition()
        self.step = 0                 # step currently being admitted
        self.arrived: set = set()
        self.granted: int | None = None
        self.departed: set = set()
        self.sync: dict = {}
        self.sync_step = -1
        self.error: BaseException | None = None

    # ----------------------------------------------------------- worker side
    def arrive(self, rank: int, g: int) -> None:
        with self.cv:
            self.arrived.add(rank)
            self.cv.notify_all()
            self.cv.wait_for(
                lambda: self.error is not None
                or (self.step == g and self.granted == rank)
            )
            if self.error is not None:
                raise _ClusterAbort from self.error

    def depart(self, rank: int, g: int) -> None:
        with self.cv:
            self.granted = None
            self.departed.add(rank)
            self.cv.notify_all()

    def finish_step(self, rank: int, g: int):
        with self.cv:
            self.cv.wait_for(
                lambda: self.error is not None or self.sync_step >= g
            )
            if self.error is not None:
                raise _ClusterAbort from self.error
            return self.sync[rank]

    def fail(self, exc: BaseException) -> None:
        with self.cv:
            if self.error is None and not isinstance(exc, _ClusterAbort):
                self.error = exc
            self.cv.notify_all()

    # ----------------------------------------------------------- driver side
    def await_all_arrived(self) -> None:
        with self.cv:
            self.cv.wait_for(
                lambda: self.error is not None or self.arrived >= self.ranks
            )
            self._raise_if_failed()

    def run_turn(self, rank: int) -> None:
        with self.cv:
            self.granted = rank
            self.cv.notify_all()
            self.cv.wait_for(
                lambda: self.error is not None or rank in self.departed
            )
            self._raise_if_failed()

    def publish_sync(self, g: int, sync: dict) -> None:
        with self.cv:
            self.sync = sync
            self.sync_step = g
            self.arrived.clear()
            self.departed.clear()
            self.step = g + 1
            self.cv.notify_all()

    def raise_if_failed(self) -> None:
        with self.cv:
            self._raise_if_failed()

    def _raise_if_failed(self) -> None:
        # callers hold self.cv
        if self.error is not None:
            raise RuntimeError("cluster worker failed") from self.error


def _worker_configs(cfg, cluster: ClusterConfig, P: int, silent: tuple):
    """Each rank's RunConfig: its method, wire scheme, policy, a silent
    rank's empty workload and a straggler's scaled ``t_base``."""
    out = []
    for r in range(P):
        cfg_r = cfg
        if cluster.methods is not None:
            cfg_r = dataclasses.replace(cfg_r, method=cluster.methods[r])
        if cluster.grad_compression != "none":
            # the cluster's wire scheme is the source of truth: each
            # measured-lane engine compresses with error feedback so the
            # collective's wire bytes match what the step produced
            cfg_r = dataclasses.replace(
                cfg_r, grad_compression=cluster.grad_compression,
                topk_frac=cluster.topk_frac,
            )
        if cluster.q_fns is not None and cluster.q_fns[r] is not None:
            cfg_r = dataclasses.replace(cfg_r, q_fn=cluster.q_fns[r])
        if (
            cfg_r.method.startswith("greendygnn")
            and cfg_r.q_fn is None
            and r not in silent
        ):
            raise ValueError(
                f"rank {r} runs {cfg_r.method!r} but has no q_fn (set "
                f"ClusterConfig.q_fns or cfg.q_fn)"
            )
        if r in silent:
            cfg_r = dataclasses.replace(
                cfg_r, method="dgl", run_model=False, async_pipeline=False,
                q_fn=None,
            )
        if cluster.compute_scale is not None:
            cs = float(cluster.compute_scale[r])
            if cs != 1.0:
                cfg_r = dataclasses.replace(
                    cfg_r,
                    params=dataclasses.replace(
                        cfg_r.params, t_base=float(cfg_r.params.t_base) * cs
                    ),
                )
        out.append(cfg_r)
    return out


def run_cluster(cfg, cluster: ClusterConfig | None = None,
                trace_bundles=None) -> ClusterReport:
    """Run P :class:`TrainerWorker` threads over one shared fabric.

    ``cfg`` is the per-worker :class:`RunConfig` (method, epochs, cache,
    scenario, device...); ``cfg.scenario`` of ``None``/``closed_form``
    falls back to the ``clean`` fabric: a cluster *requires* a shared
    medium. ``trace_bundles`` (from :func:`build_cluster_traces`) may be
    shared across method sweeps.
    """
    from repro_torch.net import CLOSED_FORM, build_scenario
    from repro_torch.train.gnn_trainer import METHODS

    cluster = cluster or ClusterConfig()
    P = int(cluster.n_workers)
    if not 1 <= P <= cfg.n_parts:
        raise ValueError(
            f"n_workers={P} must be in [1, n_parts={cfg.n_parts}]"
        )
    if cluster.sync not in SYNC_MODES:
        raise ValueError(
            f"unknown sync mode {cluster.sync!r}; expected {SYNC_MODES}"
        )
    silent = tuple(cluster.silent_ranks)
    n_active = P - len(set(silent))
    if cluster.max_stale > 0 and cluster.max_stale >= n_active:
        # times[n_active - 1 - max_stale] would wrap negative and silently
        # invert the semantics: reject the misconfiguration instead
        raise ValueError(
            f"max_stale={cluster.max_stale} must be < the {n_active} "
            f"active workers"
        )
    scenario = "clean" if cfg.scenario in CLOSED_FORM else cfg.scenario

    if trace_bundles is None:
        trace_bundles = build_cluster_traces(cfg, P, silent)
    if len(trace_bundles) != P:
        raise ValueError(
            f"{len(trace_bundles)} trace bundles for {P} workers"
        )
    graph = trace_bundles[0][0]

    # ---- ONE fabric, cluster topology: per-partition NICs shared by all
    fabric = build_scenario(
        scenario, params=cfg.params, n_owners=cfg.n_parts - 1,
        seed=cfg.seed, n_epochs=cfg.n_epochs,
        steps_per_epoch=cfg.steps_per_epoch,
        n_parts=cfg.n_parts, n_requesters=P,
    )
    if cluster.link_rate_scale is not None:
        scale = np.asarray(cluster.link_rate_scale, np.float64)
        if scale.shape != (cfg.n_parts,):
            raise ValueError(
                f"link_rate_scale needs {cfg.n_parts} entries (one per "
                f"partition NIC), got {scale.shape}"
            )
        fabric.link_rate = fabric.link_rate * scale

    # ---- per-rank policy heterogeneity (mixed fleets) ----
    if cluster.methods is not None and len(cluster.methods) != P:
        raise ValueError(
            f"methods needs {P} entries (one per rank), got "
            f"{len(cluster.methods)}"
        )
    if cluster.q_fns is not None and len(cluster.q_fns) != P:
        raise ValueError(
            f"q_fns needs {P} entries (one per rank), got "
            f"{len(cluster.q_fns)}"
        )
    if cluster.methods is not None:
        unknown = [m for m in cluster.methods if m not in METHODS]
        if unknown:
            raise ValueError(
                f"unknown per-rank methods {unknown}; expected {METHODS}"
            )
    if cluster.grad_compression not in ("none", "int8", "topk"):
        raise ValueError(
            f"grad_compression must be 'none', 'int8' or 'topk', got "
            f"{cluster.grad_compression!r}"
        )

    workers: list[TrainerWorker] = []
    try:
        for r, cfg_r in enumerate(_worker_configs(cfg, cluster, P, silent)):
            workers.append(
                TrainerWorker(cfg_r, trace_bundles[r], rank=r,
                              fabric=fabric, cluster=True)
            )
    except BaseException:
        for w in workers:
            w.close()
        raise

    active = [r for r in range(P) if r not in silent]
    if cluster.grad_bytes is not None:
        grad_bytes = float(cluster.grad_bytes)
    elif cluster.grad_compression == "none":
        grad_bytes = default_grad_bytes(graph)
    else:
        # compressed wire bytes replace the constant payload in the ring
        # collective: compression becomes an energy-visible knob
        from repro_torch.train.compute import model_wire_bytes

        grad_bytes = model_wire_bytes(
            graph, cluster.grad_compression, cluster.topk_frac
        )
    staleness = (
        BoundedStalenessBarrier(
            n_workers=len(active), max_stale=cluster.max_stale,
            max_lag=cluster.max_lag,
        )
        if cluster.max_stale > 0 else None
    )

    gate = _StepGate(range(P))
    total_steps = cfg.n_epochs * cfg.steps_per_epoch

    def _worker_loop(w: TrainerWorker) -> None:
        # the CUDA device and stream are per thread: enter the run's device
        on_device = (torch.cuda.device(w.device) if w.device.type == "cuda"
                     else contextlib.nullcontext())
        try:
            with on_device:
                for epoch in range(cfg.n_epochs):
                    for step in range(cfg.steps_per_epoch):
                        g = epoch * cfg.steps_per_epoch + step
                        gate.arrive(w.rank, g)
                        if step == 0:
                            w.begin_epoch(epoch)
                        w.step(epoch, step)
                        gate.depart(w.rank, g)
                        w.apply_sync(*gate.finish_step(w.rank, g))
                    w.end_epoch(epoch)
        # the thread boundary: gate.fail ferries the exception to the
        # driver, which re-raises it
        except BaseException as exc:  # noqa: BLE001
            gate.fail(exc)

    def _step_sync(g: int) -> dict:
        """Barrier + collective charges for step ``g`` (virtual time)."""
        zeros = (0.0, 0.0, 0.0, 0.0, 0)
        charges = {r: zeros for r in range(P)}
        if cluster.sync == "none" or len(active) <= 1:
            return charges
        finish = {r: workers[r].meter.wall_s for r in active}
        times = sorted(finish.values())
        if staleness is None:
            t_release = times[-1]
        else:
            # the barrier tracks the ACTIVE workers densely (global ranks
            # need not be contiguous when some are silent)
            dense = {r: i for i, r in enumerate(active)}
            # up to max_stale workers may miss the barrier ...
            t_release = times[len(active) - 1 - cluster.max_stale]
            for r in active:
                if finish[r] <= t_release:
                    staleness.report(dense[r], g)
            if not staleness.can_proceed(g):
                # ... but beyond max_lag outstanding steps, the step
                # blocks and everyone resynchronizes
                t_release = times[-1]
                for r in active:
                    staleness.report(dense[r], g)
        wall, cpu, nbytes, msgs = ring_collective_cost(
            len(active), grad_bytes, cfg.params,
            scatter=cluster.sync == "reduce_scatter",
        )
        for r in active:
            wait = max(0.0, t_release - finish[r])
            charges[r] = (wait, wall, cpu, nbytes, msgs)
        return charges

    threads = [
        threading.Thread(
            target=_worker_loop, args=(w,), name=f"trainer-worker-{w.rank}",
            daemon=True,
        )
        for w in workers
    ]
    # sanitizer: every worker's virtual wall clock must be non-decreasing
    # across lockstep rounds (a rewind means a worker double-charged or
    # un-charged time, the invariant behind the deterministic release order)
    clock_check = (
        _sanitizer.MonotonicClock("run_cluster worker clock")
        if _sanitizer.sanitize_enabled() else None
    )
    try:
        for t in threads:
            t.start()
        for g in range(total_steps):
            gate.await_all_arrived()
            if clock_check is not None:
                for r in range(P):
                    clock_check.observe(r, workers[r].meter.wall_s)
            # deterministic release order: virtual clock, then rank
            order = sorted(range(P), key=lambda r: (workers[r].meter.wall_s, r))
            for r in order:
                gate.run_turn(r)
            gate.publish_sync(g, _step_sync(g))
        for t in threads:
            t.join(timeout=JOIN_TIMEOUT_S)
        # failures after the driver's last publish (the last apply_sync or
        # end_epoch) reach the gate with no driver wait to observe them
        gate.raise_if_failed()
        alive = [t.name for t in threads if t.is_alive()]
        if alive:
            raise RuntimeError(
                f"cluster worker threads did not exit: {alive}"
            )
    except BaseException as exc:
        gate.fail(exc)
        raise
    finally:
        # the gate's error wakes every parked worker; none outlives the run
        for t in threads:
            if t.ident is not None:
                t.join(timeout=JOIN_TIMEOUT_S)
        for w in workers:
            w.close()

    return ClusterReport(
        n_workers=P,
        n_parts=cfg.n_parts,
        scenario=scenario,
        sync=cluster.sync,
        results=[w.result() for w in workers],
        silent_ranks=silent,
        methods=tuple(w.cfg.method for w in workers),
        requester_metrics=fabric.requester_metrics(),
        sync_wait_s=np.asarray([w.sync_wait_s for w in workers]),
        sync_coll_s=np.asarray([w.sync_coll_s for w in workers]),
        total_queue_s=float(fabric.total_queue_s),
        grad_compression=cluster.grad_compression,
        grad_wire_bytes=float(grad_bytes),
    )
