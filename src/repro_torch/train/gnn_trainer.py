"""Distributed GNN training loop with the GreenDyGNN pipeline (Section V),
P=1.

Port of ``repro/train/gnn_trainer.py``: real graph -> METIS-like partition
-> presampled mini-batch trace -> per-step feature resolution (local /
cache-hit / remote miss) -> network time (the Eq. 4 closed form, or the
``net/`` event fabric of ``RunConfig.scenario``) + energy accounting ->
per-boundary control (static, heuristic or RL) -> reports. With
``compute="measured"`` every step also runs a real GraphSAGE
forward/backward/AdamW step on ``device`` (``train/compute.py``), through
the hand-written CSR SpMM kernel; with ``run_model=True`` in the modeled
lane, the same model trains beside the trainer through the plain scatter
path (``_init_model``, ``_model_step``); with a ``MemoryBudget`` whose
``device_payloads`` is set, cache hits are served by the EmbeddingBag
kernel, and one whose ``host_bytes`` is set budgets the host tier.

Methods (paper Section VI-A + ablations VI-H):
  dgl          on-demand per-layer fetching, no cache
  bgl          prefetch-overlap pipeline, no adaptive cache
  rapidgnn     epoch-level static cache (presample once per epoch)
  static_w     windowed cache at fixed W (w/o-RL ablation at W=16)
  heuristic    windowed cache + Eq. 7 threshold rule
  greendygnn   windowed cache + Double-DQN controller (full system)
  greendygnn_nocw   RL for W only, uniform allocation (w/o cost weights)
See ``worker.check_supported`` for every configuration not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import controller as ctl
from repro_torch.core import cost_model as cm
from repro_torch.core import domain_rand as dr
from repro_torch.core.energy import EnergyMeter
from repro_torch.core.windowed_cache import CacheStats
from repro_torch.graph import datasets
from repro_torch.graph.partition import partition_graph
from repro_torch.graph.sampling import presample_epoch

METHODS = (
    "dgl", "bgl", "rapidgnn", "static_w", "heuristic",
    "greendygnn", "greendygnn_nocw",
)


@dataclasses.dataclass
class RunConfig:
    method: str = "greendygnn"
    dataset: str = "reddit"
    batch_size: int = 2000
    n_epochs: int = 30
    steps_per_epoch: int = 32
    fanouts: tuple = (10, 25)
    n_parts: int = 4
    cache_frac: float = 0.35        # RapidGNN-scale: ~100k / 233k on Reddit
    congested: bool = True           # paper schedule vs clean (closed form)
    fixed_delta_ms: float | tuple | None = None
                                     # override: constant injected delay [ms]
                                     # on every owner link (scalar) or per
                                     # owner (length-(P-1) vector)
    scenario: str | None = None      # net/ fabric scenario: "clean",
                                     # "paper_schedule", "bursty_markov",
                                     # "incast", "trace:<path>", ...
                                     # None/"closed_form" keeps the analytic
                                     # Eq. 4 law (congested/fixed_delta_ms)
    static_window: int = 16
    warmup_epochs: int = 2
    batch_divisor: int = 10          # bench graphs are ~10x scaled: keep the
                                     # paper's batch/graph ratio
    locality_frac: float = 0.75      # fraction of each batch drawn from the
                                     # locality traversal (rest global)
    dgl_chunk: int = 512             # rows per fine-grained DistTensor RPC
    dgl_concurrency: int = 2         # in-flight RPCs (default DGL pipeline)
    prefetch_depth: int = 4          # Stage-3 async queue depth Q
    bgl_depth: int = 2               # BGL prefetches but shallower
    seed: int = 0
    params: cm.CostModelParams = dataclasses.field(
        default_factory=cm.CostModelParams
    )
    q_fn: Callable | None = None     # RL policy (greendygnn methods)
    run_model: bool = False          # also train the real SAGE model: in
                                     # the modeled lane a model step after
                                     # each trainer step (_model_step), in
                                     # both lanes accuracy per epoch
    pad_blocks: bool = False         # static block shapes in the sampler
    bgl_overlap_frac: float = 0.75   # fraction of t_base usable to hide stall
    async_pipeline: bool = False     # threaded builder + prefetcher
                                     # (pipeline/): measured exposed wait
                                     # instead of the alpha_crit leak
    mem_budget: object | None = None  # repro_torch.store.MemoryBudget
    compute: str = "modeled"         # "measured" runs the real SAGE step
                                     # each trainer step and charges its
                                     # measured time where t_base is charged
    grad_compression: str = "none"   # measured-lane gradient sync scheme:
                                     # "none" | "int8" | "topk" (error
                                     # feedback; wire bytes feed the ring
                                     # collective in cluster runs)
    topk_frac: float = 0.05          # kept fraction for "topk"
    trace: bool = False              # greentrace (not ported)
    device: str = "cuda"             # where the measured lane and the device
                                     # tier run; "cpu" for the CPU tests


@dataclasses.dataclass
class RunResult:
    meter: EnergyMeter
    hit_rate_per_epoch: np.ndarray
    window_per_epoch: np.ndarray
    sigma_trace: np.ndarray
    accuracy_per_epoch: np.ndarray | None
    wall_time_per_epoch: np.ndarray
    # parity-harness observables: per-step hit/miss stream and cumulative
    # remotely-fetched rows by owner (cache rebuilds + per-step misses)
    step_hits: np.ndarray | None = None
    step_misses: np.ndarray | None = None
    fetched_rows_by_owner: np.ndarray | None = None
    tier_counts: dict | None = None  # TierStats.counts() of a tiered store
    pipeline: object | None = None   # pipeline.PipelineReport when
                                     # async_pipeline=True
    compute_report: dict | None = None  # ComputeEngine.report() when
                                     # compute="measured"
    scenario: str = "closed_form"    # the network substrate the run used

    def totals(self) -> dict:
        return self.meter.totals_kj()


def build_trace(cfg: RunConfig, rank: int = 0, rng=None, graph=None,
                owner=None):
    """Shared per-(dataset,batch) trace so all methods see identical load.

    Seeds are drawn in *locality order* (community-sorted with a rotating
    offset per epoch), so the hot remote set drifts within the epoch.
    The defaults reproduce the reference's rank-0 trace bit-for-bit."""
    if graph is None:
        # the graph/partition are fixtures shared by every method and seed
        graph = datasets.materialize(cfg.dataset, seed=0)
    if owner is None:
        owner = partition_graph(graph, cfg.n_parts, seed=0)
    if rng is None:
        rng = np.random.default_rng(cfg.seed + 17)
    local_nodes = np.where(owner == rank)[0]
    # locality-ordered traversal: sort by community, jitter within community
    comm = graph.labels[local_nodes].astype(np.int64)
    order = np.lexsort((rng.random(len(local_nodes)), comm))
    local_sorted = local_nodes[order]
    batch = max(cfg.batch_size // max(cfg.batch_divisor, 1), 32)
    mbs = []
    for epoch in range(cfg.n_epochs):
        # rotate the traversal start each epoch (epoch-shuffled locality)
        roll = rng.integers(0, len(local_sorted))
        epoch_nodes = np.roll(local_sorted, roll)
        mbs.append(
            presample_epoch(
                graph, epoch_nodes, batch, list(cfg.fanouts),
                cfg.steps_per_epoch, rng, pad=cfg.pad_blocks,
                sequential=True, locality_frac=cfg.locality_frac,
            )
        )
    traces = [[mb.input_nodes for mb in epoch] for epoch in mbs]
    return graph, owner, traces, mbs


def _closed_form_delta(cfg: RunConfig, epoch: int, n_owners: int) -> np.ndarray:
    """Injected per-owner delay [ms] for the analytic path."""
    if cfg.fixed_delta_ms is not None:
        fd = np.asarray(cfg.fixed_delta_ms, np.float64).ravel()
        if fd.size == 1:
            return np.full(n_owners, fd[0])
        if fd.size != n_owners:
            raise ValueError(
                f"fixed_delta_ms has {fd.size} entries, run has "
                f"{n_owners} owner links"
            )
        return fd.copy()
    if cfg.congested:
        return dr.paper_schedule_delta(epoch, cfg.n_epochs, n_owners)
    return np.zeros(n_owners)


def _fetch_time(params, per_owner_rows: np.ndarray, delta_ms: np.ndarray,
                bytes_per_row: float) -> tuple[float, float, float, int]:
    """ONE consolidated bulk RPC per owner, concurrently across owners.

    raw — wall latency of the slowest owner (Eq. 3 straggler semantics);
    cpu — CPU processing time summed over owners (Eq. 4 without the
    passive network wait). Returns (raw_s, cpu_s, bytes, n_rpcs)."""
    active = per_owner_rows > 0
    if not active.any():
        return 0.0, 0.0, 0.0, 0
    payload = per_owner_rows * bytes_per_row
    per_owner_t = cm.rpc_cpu_s(
        float(params.alpha_rpc), float(params.beta), float(params.gamma_c),
        payload, delta_ms,
    )
    raw = float(np.max(np.where(
        active, per_owner_t + cm.PROP_RTT_BULK_S_PER_MS * delta_ms, 0.0
    )))
    cpu = float(np.sum(np.where(active, per_owner_t, 0.0)))
    return raw, cpu, float(payload.sum()), int(active.sum())


def _chunked_fetch_time(params, per_owner_rows: np.ndarray,
                        delta_ms: np.ndarray, bytes_per_row: float,
                        chunk: int, concurrency: int
                        ) -> tuple[float, float, float, int]:
    """Fine-grained DistTensor path (Default DGL / BGL): each owner's rows
    go as ceil(N/chunk) small RPCs with ``concurrency`` in flight."""
    active = per_owner_rows > 0
    if not active.any():
        return 0.0, 0.0, 0.0, 0
    n_chunks = np.ceil(per_owner_rows / chunk)
    payload = per_owner_rows * bytes_per_row
    payload_t = (
        float(params.beta) * payload
        + float(params.gamma_c) * payload * delta_ms
    )
    wall = (
        np.maximum(n_chunks / concurrency, 1.0) * float(params.alpha_rpc)
        + cm.PROP_RTT_CHUNKED_S_PER_MS * delta_ms  # pipelined injected RTT
        + payload_t
    )
    cpu_t = n_chunks * float(params.alpha_rpc) + payload_t
    raw = float(np.max(np.where(active, wall, 0.0)))
    cpu = float(np.sum(np.where(active, cpu_t, 0.0)))
    return raw, cpu, float(payload.sum()), int(n_chunks.sum())


def run(cfg: RunConfig, trace_bundle=None) -> RunResult:
    """Single-trainer entry point, the P=1 case of the cluster: one
    :class:`TrainerWorker` (partition 0) over the scenario's event fabric,
    or the closed form, driven through its epochs in a plain loop. P
    workers over one requester-aware fabric are
    ``repro_torch.train.cluster.run_cluster``."""
    from repro_torch.net import CLOSED_FORM, build_scenario
    from repro_torch.train.worker import TrainerWorker, check_supported

    check_supported(cfg)
    if trace_bundle is None:
        trace_bundle = build_trace(cfg)
    fabric = None
    if cfg.scenario not in CLOSED_FORM:
        fabric = build_scenario(
            cfg.scenario, params=cfg.params, n_owners=cfg.n_parts - 1,
            seed=cfg.seed, n_epochs=cfg.n_epochs,
            steps_per_epoch=cfg.steps_per_epoch,
        )
    worker = TrainerWorker(cfg, trace_bundle, rank=0, fabric=fabric)
    try:
        for epoch in range(cfg.n_epochs):
            worker.begin_epoch(epoch)
            for step in range(cfg.steps_per_epoch):
                worker.step(epoch, step)
            worker.end_epoch(epoch)
    finally:
        # threads must not outlive the run, even on error paths
        worker.close()
    return worker.result()


def _controller_stats(
    stats: CacheStats, meter: EnergyMeter, t_base: float,
    e_baseline: float | None, step: int, steps_per_epoch: int, n_owners: int,
    snapshot: dict | None = None, rebuild_stall: float = 0.0,
    headroom: float = 1.0,
) -> ctl.ControllerStats:
    """Observations over the LAST WINDOW (meter delta since ``snapshot``) —
    the same quantities the simulator's _observe emits (sim-to-real)."""
    per_owner = (
        stats.per_owner_hit_rates()
        if stats.per_owner_hits is not None
        else np.zeros(n_owners)
    )
    if snapshot:
        d_steps = max(meter.n_steps - snapshot["n"], 1)
        t_step = (meter.wall_s - snapshot["wall"]) / d_steps
        e_step = (
            meter.gpu_j + meter.cpu_j - snapshot["energy"]
        ) / d_steps
    else:
        n = max(meter.n_steps, 1)
        t_step = meter.wall_s / n
        e_step = (meter.gpu_j + meter.cpu_j) / n
    return ctl.ControllerStats(
        owner_hit_rates=per_owner,
        global_hit_rate=stats.hit_rate(),
        t_step=t_step,
        f_rebuild=rebuild_stall / max(t_step, 1e-9),
        f_miss=max(0.0, (t_step - t_base - rebuild_stall) / max(t_step, 1e-9)),
        e_step=e_step,
        e_baseline=e_baseline if e_baseline else e_step,
        batches_remaining=1.0 - step / steps_per_epoch,
        headroom=headroom,
    )


# --------------------------------------------------------------- real model
def _init_model(graph, cfg: RunConfig, params: dict | None = None) -> dict:
    """The modeled lane's model runner: the paper's SAGE model on the run's
    device, its AdamW state, and a loss log. ``params``, numpy arrays in
    the reference's layout, replace the seeded initialisation (through
    ``convert``, with a fresh optimizer state)."""
    from repro_torch.convert import sage_params_from_jax
    from repro_torch.device import resolve
    from repro_torch.models.gnn import sage
    from repro_torch.optim import optimizers as optim
    from repro_torch.train.compute import LEARNING_RATE, sage_config

    device = resolve(cfg.device)
    mcfg = sage_config(graph)
    if params is None:
        p = sage.init(mcfg, torch.Generator().manual_seed(int(cfg.seed)),
                      device=device)
    else:
        p = sage_params_from_jax(params, device)
    opt = optim.adamw(LEARNING_RATE)
    return {
        "params": p, "opt_state": opt.init(p), "opt": opt, "cfg": mcfg,
        "device": device, "graph": graph, "losses": [],
    }


def _model_step(state: dict, mb) -> dict:
    """One AdamW step of the model over ``mb``'s blocks (the plain scatter
    path, ``sage.apply_blocks``) on the graph's own feature rows."""
    from repro_torch.models.gnn import common, sage
    from repro_torch.optim import optimizers as optim

    graph, dev = state["graph"], state["device"]
    blocks = [
        {
            "edge_src": torch.as_tensor(b.edge_src).to(dev),
            "edge_dst": torch.as_tensor(b.edge_dst).to(dev),
            "edge_mask": torch.as_tensor(b.edge_mask).to(dev),
            "dst_pos": torch.as_tensor(b.dst_pos).to(dev),
        }
        for b in mb.blocks
    ]
    x_in = torch.as_tensor(
        np.asarray(graph.features[mb.input_nodes], np.float32)).to(dev)
    labels = torch.as_tensor(
        np.asarray(graph.labels[mb.seeds], np.int64)).to(dev)
    params = optim.tree_map(lambda p: p.detach().requires_grad_(True),
                            state["params"])
    loss = common.cross_entropy(
        sage.apply_blocks(params, state["cfg"], x_in, blocks), labels)
    grads = torch.autograd.grad(loss, optim.tree_leaves(params))
    grads = optim.tree_unflatten(params, grads)
    upd, state["opt_state"] = state["opt"].update(
        grads, state["opt_state"], state["params"])
    state["params"] = optim.apply_updates(state["params"], upd)
    state["losses"].append(float(loss.detach()))
    return state


@torch.no_grad()
def _model_eval(params, mcfg, graph, device, n_eval: int = 2048) -> float:
    """Accuracy on the induced subgraph of the first ``n_eval`` nodes."""
    from repro_torch.models.gnn import sage
    from repro_torch.models.gnn.common import accuracy

    x = torch.as_tensor(np.asarray(graph.features[:n_eval])).to(device)
    ei = graph.edge_index
    m = (ei[0] < n_eval) & (ei[1] < n_eval)
    logits = sage.apply_full(
        params, mcfg, x, torch.as_tensor(ei[:, m]).to(device)
    )
    labels = torch.as_tensor(np.asarray(graph.labels[:n_eval])).to(device)
    return float(accuracy(logits, labels))
