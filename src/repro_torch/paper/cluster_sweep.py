"""Emergent-vs-injected congestion across cluster sizes P in {2, 4, 8}.

Port of ``benchmarks/cluster_sweep.py``. For each P, every partition
runs a live trainer over ONE shared requester-aware fabric
(``repro_torch.train.cluster``), and methods
dgl / bgl / static (static_w) / greendygnn are compared on *cluster-total*
energy under two families of scenarios:

  emergent (NO background overlay — congestion comes only from the P
  trainers' real traffic):
    clean         symmetric cluster; contention = P-way NIC sharing
    hot_owner     partition 0's NIC at a fraction of the base rate — a
                  hot/slow feature owner; every worker's misses to it
                  incast-collapse at that NIC
    slow_worker   rank 0 computes slower (t_base x) — a straggler whose
                  barrier drag and lagging rebuilds feed back into peers
    demand_skew   partition 0 owns a disproportionate share of the
                  globally-hot nodes (``partition_graph(degree_bias=)``)
                  — every worker directs outsized miss demand at one NIC,
                  stressing per-owner cache allocation, not window size

  injected (the fabric's background overlays, now *on top of* the emergent
  traffic): bursty_markov, incast

The greendygnn policy deployed on every rank is trained IN the cluster
twin (``repro_torch.envs.cluster_sim`` via
``policy.get_or_train_policy(env="cluster", n_workers=P)``) — per-P
checkpoints, new default. ``greendygnn_queue`` deploys the same
architecture trained in the single-requester queue env
(``core/queue_sim``), as the ablation the acceptance gate compares
against.

    python -m repro_torch.paper.cluster_sweep --steps 96
    python -m repro_torch.paper.cluster_sweep --workers 4 --check
    python -m repro_torch.paper.cluster_sweep --workers 4 --mixture

``--check`` asserts the cluster-twin acceptance at P=4: emergent
queueing on every no-overlay scenario, the cluster-trained greendygnn
beats the BEST static policy (min over dgl/bgl/static_w) on >= 2
emergent scenarios, is <= the queue-trained greendygnn on every
emergent scenario (one-sided 5% band on clean), and strictly better on
>= 2 of {hot_owner, slow_worker, demand_skew}.

``--mixture`` adds the policy-heterogeneity axis (per-rank
``ClusterConfig.methods``): mixed fleets — greendygnn only on the
straggler rank vs only on the symmetric ranks — under slow_worker
physics, against the homogeneous fleets.

``--mem-budget`` adds the tiered-memory axis: each level is a
host-tier byte budget (fraction of the graph's total feature bytes, or
the named presets tight=0.2 / loose=0.6) deployed through
``RunConfig.mem_budget`` -> ``repro_torch.store.TieredFeatureStore``, so
memory pressure converts into block traffic on the SAME shared fabric
the policies reason about. The greendygnn cell deploys a headroom-aware
policy trained in the cluster twin under matching pressure
(``ClusterEnvConfig(mem_budget_frac=..., observe_headroom=True)``,
per-level checkpoints ``qnet_sweep_mem_<level>_cluster_p<P>``). Rows
carry per-tier hit/eviction attribution (``ClusterReport.tier_counts``),
and with ``--check`` the greendygnn cells are paired-run
digest-compared and an explicit unlimited ``MemoryBudget`` is asserted
bit-identical to the pre-PR store.

    python -m repro_torch.paper.cluster_sweep \\
        --workers 4 --mem-budget tight,loose --check

``--device`` (default ``cuda``, raising without a card) is where the
runs, the policies' training and their qnets go; the modeled lane itself
is numpy. Each budget level's device tier (``MemoryBudget
.device_payloads``) serves its hits through the ``embedding_bag`` kernel
there, and the policies train through the ``cluster_window`` and
``queue_window`` kernels. Policies are cached under
``repro_torch.train.policy.ARTIFACT_DIR`` with the reference's names; the
JSON goes to ``results/paper_torch/cluster_sweep.json`` and ``--trace``
payloads under ``results/paper_torch/traces/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from repro_torch.device import resolve
from repro_torch.graph.partition import hot_share, partition_graph
from repro_torch.paper.common import RESULTS_DIR, base_cfg, save_json
from repro_torch.train import policy as pol
from repro_torch.train.cluster import (
    ClusterConfig,
    build_cluster_traces,
    run_cluster,
)

STATIC_METHODS = ("dgl", "bgl", "static_w")
ADAPTIVE_METHODS = ("greendygnn", "greendygnn_queue")
METHOD_LABEL = {
    "static_w": "static",
    "greendygnn": "gdg-cluster",
    "greendygnn_queue": "gdg-queue",
}
INJECTED = ("bursty_markov", "incast")
# the non-clean emergent scenarios the strict-win criterion ranges over
EMERGENT_STRESS = ("hot_owner", "slow_worker", "demand_skew")
# named --mem-budget presets: host-tier budget as a fraction of the
# graph's total feature bytes
MEM_LEVELS = {"tight": 0.2, "loose": 0.6}


def emergent_scenarios(n_parts: int, hot_rate: float, slow_factor: float):
    """Name -> (fabric scenario, ClusterConfig physics kwargs, skewed?).

    ``demand_skew`` carries no fabric/physics knobs — its congestion
    comes entirely from the degree-biased partition (third element)."""
    hot = np.ones(n_parts)
    hot[0] = hot_rate
    slow = np.ones(n_parts)
    slow[0] = slow_factor
    return {
        "clean": ("clean", {}, False),
        "hot_owner": ("clean", {"link_rate_scale": tuple(hot)}, False),
        "slow_worker": ("clean", {"compute_scale": tuple(slow)}, False),
        "demand_skew": ("clean", {}, True),
    }


def calib_pool(cfg0, bundle):
    """Algorithm-1 calibration for this P's trace, as an episode pool."""
    theta, _ = pol.calibrate_from_bundle(bundle, cfg0)
    return pol.make_params_pool([theta], device=cfg0.device)


def get_q_fns(cfg0, pool, iterations: int, force: bool,
              wanted) -> dict:
    """Per-P Double-DQN policies: cluster-twin-trained (the deployed
    default) and queue-env-trained (the train/eval-gap ablation) — each
    trained only when a requested method actually deploys it.

    The controller's obs/action spaces are sized by n_owners = P - 1, so
    each P gets its own Algorithm-1 calibration + checkpoints
    (``qnet_sweep_cluster_p<P>`` / ``qnet_sweep_p<P>_queue``).
    """
    wanted = [m for m in ADAPTIVE_METHODS if m in wanted]
    if not wanted:
        return {}
    P = cfg0.n_parts
    q_fns = {}
    if "greendygnn" in wanted:
        q_fns["greendygnn"], _ = pol.get_or_train_policy(
            pool, name="qnet_sweep", iterations=iterations, force=force,
            env="cluster", n_workers=P, device=cfg0.device,
        )
    if "greendygnn_queue" in wanted:
        q_fns["greendygnn_queue"], _ = pol.get_or_train_policy(
            pool, name=f"qnet_sweep_p{P}", iterations=iterations,
            force=force, env="queue", n_owners=P - 1, device=cfg0.device,
        )
    return q_fns


def _run_cell(cfg0, method, fabric_sc, physics, bundles, q_fns, P, sync,
              trace=False):
    trainer_method = (
        "greendygnn" if method in ADAPTIVE_METHODS else method
    )
    cfg_m = dataclasses.replace(
        cfg0, method=trainer_method, scenario=fabric_sc,
        q_fn=q_fns.get(method), trace=trace,
    )
    rep = run_cluster(
        cfg_m,
        ClusterConfig(n_workers=P, sync=sync, **physics),
        trace_bundles=bundles,
    )
    t = rep.totals_kj()
    return rep, {
        "total_kj": t["total_kj"],
        "gpu_kj": t["gpu_kj"],
        "cpu_kj": t["cpu_kj"],
        "wall_s": t["wall_s"],
        "queue_s": rep.total_queue_s,
        "hit_rate": float(np.mean([
            float(r.hit_rate_per_epoch.mean())
            for r in rep.results
        ])),
        "per_worker": rep.per_worker(),
    }


def run_sweep(args) -> dict:
    resolve(args.device)
    steps_per_epoch = args.steps_per_epoch
    n_epochs = max(args.steps // steps_per_epoch, 2)
    methods = args.methods.split(",")
    worker_counts = [int(p) for p in args.workers.split(",")]

    out: dict = {"rows": {}, "dataset": args.dataset, "batch": args.batch,
                 "n_epochs": n_epochs, "steps_per_epoch": steps_per_epoch,
                 "seed": args.seed, "sync": args.sync,
                 "demand_bias": args.demand_bias}
    for P in worker_counts:
        cfg0 = dataclasses.replace(
            base_cfg(args.dataset, args.batch, device=args.device),
            n_parts=P, n_epochs=n_epochs, steps_per_epoch=steps_per_epoch,
            seed=args.seed,
        )
        print(f"\n=== P={P}: building {P} per-partition traces...",
              flush=True)
        bundles = build_cluster_traces(cfg0, P)
        # demand_skew partitions the SAME graph with partition-0 degree
        # bias, so its congestion is pure demand concentration
        graph = bundles[0][0]
        owner_skew = partition_graph(
            graph, P, seed=0, degree_bias=args.demand_bias, biased_part=0,
        )
        skew_bundles = build_cluster_traces(
            cfg0, P, graph=graph, owner=owner_skew
        )
        out.setdefault("hot_share", {})[P] = {
            "balanced": hot_share(graph, bundles[0][1], P).tolist(),
            "demand_skew": hot_share(graph, owner_skew, P).tolist(),
        }
        wanted = set(methods)
        if args.mixture:
            wanted.add("greendygnn")  # the mixture axis deploys it
        need_pool = bool(
            wanted & set(ADAPTIVE_METHODS)
        ) or bool(args.mem_budget)
        pool = calib_pool(cfg0, bundles[0]) if need_pool else None
        q_fns = get_q_fns(
            cfg0, pool, args.iterations, args.force, wanted
        )

        scenarios = dict(
            emergent_scenarios(P, args.hot_rate, args.slow_factor)
        )
        for sc in INJECTED:
            scenarios[f"injected:{sc}"] = (sc, {}, False)

        out["rows"][P] = {}
        header = f"{'scenario':>22} " + "".join(
            f"{METHOD_LABEL.get(m, m):>12}" for m in methods
        )
        print(f"cluster-total energy [kJ], P={P} workers, "
              f"sync={args.sync}\n{header}")
        for name, (fabric_sc, physics, skewed) in scenarios.items():
            out["rows"][P][name] = {}
            cells = []
            for m in methods:
                rep, row = _run_cell(
                    cfg0, m, fabric_sc, physics,
                    skew_bundles if skewed else bundles, q_fns, P,
                    args.sync, trace=args.trace,
                )
                if args.trace and rep.trace is not None:
                    from repro_torch.obs import reconcile, write_trace

                    reconcile(rep.trace)  # hard-fail on a broken ledger
                    rep.trace["meta"]["scenario"] = name
                    tp = write_trace(
                        os.path.join(
                            RESULTS_DIR, "traces",
                            f"cluster_sweep_p{P}_{name}_{m}.json",
                        ),
                        rep.trace,
                    )
                    print(f"    trace -> {tp}")
                out["rows"][P][name][m] = row
                cells.append(f"{row['total_kj']:12.3f}")
            q = out["rows"][P][name][methods[0]]["queue_s"]
            print(f"{name:>22} " + "".join(cells) + f"   (queue {q:.3f}s)")

        if args.mixture:
            out.setdefault("mixtures", {})[P] = run_mixture(
                cfg0, bundles, q_fns, P, args
            )

        if args.mem_budget:
            out.setdefault("mem", {})[P] = run_mem_axis(
                cfg0, bundles, pool, P, args
            )
    return out


def parse_mem_levels(spec: str) -> dict:
    """'tight,loose' / '0.15,0.5' -> {level name: budget fraction}."""
    levels = {}
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        levels[tok] = MEM_LEVELS.get(tok, None)
        if levels[tok] is None:
            levels[tok] = float(tok)
    if not levels:
        raise ValueError(f"no budget levels in --mem-budget={spec!r}")
    return levels


def _feature_bytes(graph) -> float:
    """Total feature bytes the budget fractions are relative to."""
    if graph.features is not None:
        return float(graph.features.nbytes)
    return float(graph.n_nodes * graph.feature_source.bytes_per_row)


def _run_mem_cell(cfg0, method, budget, bundles, q_fn, P, sync):
    cfg_m = dataclasses.replace(
        cfg0, method="greendygnn" if method == "greendygnn" else method,
        scenario="clean", q_fn=q_fn if method == "greendygnn" else None,
        mem_budget=budget,
    )
    rep = run_cluster(
        cfg_m, ClusterConfig(n_workers=P, sync=sync), trace_bundles=bundles,
    )
    t = rep.totals_kj()
    return rep, {
        "total_kj": t["total_kj"],
        "gpu_kj": t["gpu_kj"],
        "cpu_kj": t["cpu_kj"],
        "wall_s": t["wall_s"],
        "queue_s": rep.total_queue_s,
        "tier_counts": rep.tier_counts(),
        "per_worker": rep.per_worker(),
    }


def run_mem_axis(cfg0, bundles, pool, P, args) -> dict:
    """--mem-budget axis: static fleets vs the headroom-aware greendygnn
    under tiered host budgets on the clean emergent fabric.

    Per level, the greendygnn cell deploys a policy trained in the
    cluster twin under MATCHING memory pressure
    (``mem_budget_frac=frac, observe_headroom=True`` — 24-dim obs); the
    deployed worker observes the real store's headroom, so train and
    eval see the same state surface. With ``--check`` the greendygnn
    cell is run twice and digest- and tier-count-compared (the sweep's
    determinism evidence), and an explicit *unlimited* ``MemoryBudget``
    is asserted report-digest-identical to the legacy in-RAM store.
    """
    from repro_torch.analysis.digest import report_digest
    from repro_torch.store import MemoryBudget

    graph = bundles[0][0]
    feat_bytes = _feature_bytes(graph)
    levels = parse_mem_levels(args.mem_budget)
    methods = list(STATIC_METHODS) + ["greendygnn"]
    out = {"feature_bytes": feat_bytes, "chunk_rows": args.chunk_rows,
           "levels": levels, "rows": {}}

    cfg_st = dataclasses.replace(
        cfg0, method="static_w", scenario="clean", q_fn=None,
    )
    legacy = run_cluster(
        cfg_st, ClusterConfig(n_workers=P, sync=args.sync),
        trace_bundles=bundles,
    )
    unlim = run_cluster(
        dataclasses.replace(
            cfg_st, mem_budget=MemoryBudget(device_payloads=False)
        ),
        ClusterConfig(n_workers=P, sync=args.sync), trace_bundles=bundles,
    )
    out["unlimited_parity"] = (
        report_digest(legacy) == report_digest(unlim)
    )

    print(f"\n--mem-budget axis @ P={P} "
          f"(total feature bytes {feat_bytes / 1e6:.2f} MB, "
          f"chunk {args.chunk_rows} rows, unlimited parity: "
          f"{out['unlimited_parity']})")
    header = f"{'budget':>22} " + "".join(
        f"{METHOD_LABEL.get(m, m):>12}" for m in methods
    )
    print(header)
    for name, frac in levels.items():
        budget = MemoryBudget(
            host_bytes=frac * feat_bytes, chunk_rows=args.chunk_rows,
        )
        q_fn, _ = pol.get_or_train_policy(
            pool, name=f"qnet_sweep_mem_{name}", iterations=args.iterations,
            force=args.force, env="cluster", n_workers=P,
            device=cfg0.device, cluster_kwargs={
                "mem_budget_frac": float(frac), "observe_headroom": True,
            },
        )
        out["rows"][name] = {}
        cells = []
        for m in methods:
            rep, row = _run_mem_cell(
                cfg0, m, budget, bundles, q_fn, P, args.sync
            )
            if args.check and m == "greendygnn":
                rep2, row2 = _run_mem_cell(
                    cfg0, m, budget, bundles, q_fn, P, args.sync
                )
                row["deterministic"] = (
                    report_digest(rep) == report_digest(rep2)
                    and row["tier_counts"] == row2["tier_counts"]
                )
            out["rows"][name][m] = row
            cells.append(f"{row['total_kj']:12.3f}")
        tc = out["rows"][name]["greendygnn"]["tier_counts"]
        print(f"{name:>22} " + "".join(cells)
              + f"   (evict {tc['evictions']}, host hit {tc['host_hits']},"
                f" device hit {tc['device_hits']})")
    return out


def run_mixture(cfg0, bundles, q_fns, P, args) -> dict:
    """Policy-heterogeneity axis: mixed fleets under slow_worker physics.

    Per-rank ``ClusterConfig.methods``: the adaptive policy deployed only
    on the straggler rank (0) vs only on the symmetric ranks, against the
    homogeneous static and homogeneous adaptive fleets.
    """
    slow = np.ones(P)
    slow[0] = args.slow_factor
    physics = {"compute_scale": tuple(slow)}
    q = q_fns["greendygnn"]
    fleets = {
        "all_static": dict(methods=("static_w",) * P),
        "all_greendygnn": dict(methods=("greendygnn",) * P),
        "gdg_on_straggler": dict(
            methods=("greendygnn",) + ("static_w",) * (P - 1)
        ),
        "gdg_on_symmetric": dict(
            methods=("static_w",) + ("greendygnn",) * (P - 1)
        ),
    }
    rows = {}
    print(f"\npolicy mixtures under slow_worker physics, P={P}")
    for name, fleet in fleets.items():
        cfg_m = dataclasses.replace(
            cfg0, method="static_w", scenario="clean", q_fn=q,
        )
        rep = run_cluster(
            cfg_m,
            ClusterConfig(n_workers=P, sync=args.sync, **physics, **fleet),
            trace_bundles=bundles,
        )
        t = rep.totals_kj()
        rows[name] = {
            "total_kj": t["total_kj"],
            "wall_s": t["wall_s"],
            "queue_s": rep.total_queue_s,
            "methods": list(rep.methods),
            "per_worker": rep.per_worker(),
        }
        print(f"{name:>22} {t['total_kj']:12.3f} kJ  "
              f"(wall {t['wall_s']:.2f}s)")
    return rows


def check_acceptance(result: dict, check_p: int) -> None:
    """The cluster-twin acceptance at P=check_p (see module docstring)."""
    rows = result["rows"].get(check_p)
    assert rows is not None, f"--check needs P={check_p} in --workers"
    emergent = [n for n in rows if not n.startswith("injected:")]
    for m in ("greendygnn", "greendygnn_queue"):
        assert all(m in rows[n] for n in emergent), (
            f"--check needs method {m} in --methods"
        )

    # (0) invariant: congestion is emergent on the no-overlay fabric
    for name in emergent:
        q = rows[name]["greendygnn"]["queue_s"]
        assert q > 0, f"no emergent queueing under {name} (queue_s={q})"

    # (1) invariant: beats the best static fleet on >= 2 emergent
    static_wins = []
    for name in emergent:
        e_ad = rows[name]["greendygnn"]["total_kj"]
        statics = [
            rows[name][m]["total_kj"] for m in STATIC_METHODS
            if m in rows[name]
        ]
        assert statics, "--check needs at least one static method"
        if e_ad < min(statics):
            static_wins.append((name, e_ad, min(statics)))
    print(f"\n--check @ P={check_p}: cluster-trained greendygnn beats "
          f"best-static on {len(static_wins)}/{len(emergent)} emergent "
          "scenarios: "
          + ", ".join(f"{n} ({a:.3f} < {s:.3f} kJ)"
                      for n, a, s in static_wins))
    assert len(static_wins) >= 2, (
        "cluster-trained greendygnn must beat the best static policy on "
        f">= 2 emergent scenarios at P={check_p}, won {len(static_wins)}"
    )

    # (2) the cluster twin closes the train/eval gap — <= the
    # queue-trained policy everywhere emergent (one-sided 5% band on
    # clean), strictly better on >= 2 stress scenarios
    strict = []
    for name in emergent:
        e_c = rows[name]["greendygnn"]["total_kj"]
        e_q = rows[name]["greendygnn_queue"]["total_kj"]
        tol = 1.05 if name == "clean" else 1.0 + 1e-9
        assert e_c <= e_q * tol, (
            f"cluster-trained ({e_c:.3f} kJ) worse than queue-trained "
            f"({e_q:.3f} kJ) under {name} at P={check_p}"
        )
        if name in EMERGENT_STRESS and e_c < e_q:
            strict.append((name, e_c, e_q))
    print(f"--check @ P={check_p}: cluster-trained <= queue-trained on "
          f"all emergent; strictly better on {len(strict)}/"
          f"{len(EMERGENT_STRESS)} stress scenarios: "
          + ", ".join(f"{n} ({a:.3f} < {b:.3f} kJ)" for n, a, b in strict))
    assert len(strict) >= 2, (
        "cluster-trained greendygnn must strictly beat queue-trained on "
        f">= 2 of {EMERGENT_STRESS} at P={check_p}, won {len(strict)}"
    )


def check_mem_acceptance(result: dict, check_p: int) -> None:
    """The memory-axis acceptance at P=check_p: unlimited
    budget is bit-identical to the legacy store, the tightest budget
    produces real tier traffic with deterministic per-tier counts, and
    the headroom-aware greendygnn beats the best static fleet on total
    energy under that pressure."""
    mem = result.get("mem", {}).get(check_p)
    assert mem is not None, (
        f"--check with --mem-budget needs P={check_p} in --workers"
    )
    assert mem["unlimited_parity"], (
        "an unlimited MemoryBudget must be report-digest-identical to "
        "the legacy in-RAM store"
    )
    tight = min(mem["levels"], key=mem["levels"].get)
    rows = mem["rows"][tight]
    tc = rows["greendygnn"]["tier_counts"]
    assert tc and tc["block_fetches"] > 0 and tc["evictions"] > 0, (
        f"'{tight}' budget produced no tier traffic: {tc}"
    )
    assert rows["greendygnn"]["deterministic"], (
        "paired greendygnn runs under the tight budget disagreed on "
        "digest or per-tier counts"
    )
    e_ad = rows["greendygnn"]["total_kj"]
    statics = [
        rows[m]["total_kj"] for m in STATIC_METHODS if m in rows
    ]
    assert statics, "--check needs at least one static method"
    print(f"--check mem @ P={check_p}: headroom-aware greendygnn "
          f"{e_ad:.3f} kJ vs best static {min(statics):.3f} kJ under "
          f"'{tight}' budget ({tc['evictions']} evictions, "
          f"{tc['host_hits']} host hits, {tc['device_hits']} device hits)")
    assert e_ad < min(statics), (
        f"headroom-aware greendygnn ({e_ad:.3f} kJ) must beat the best "
        f"static fleet ({min(statics):.3f} kJ) under the '{tight}' "
        f"budget at P={check_p}"
    )


def parse_args(argv=None) -> argparse.Namespace:
    """The command line's flags: the reference's, and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="reddit")
    ap.add_argument("--batch", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=96,
                    help="total train steps per run (bounds runtime)")
    ap.add_argument("--steps-per-epoch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", default="2,4,8",
                    help="comma list of cluster sizes P (n_parts = P)")
    ap.add_argument("--methods",
                    default="dgl,bgl,static_w,greendygnn_queue,greendygnn")
    ap.add_argument("--sync", default="allreduce",
                    choices=("allreduce", "reduce_scatter", "none"))
    ap.add_argument("--hot-rate", type=float, default=0.35,
                    help="hot_owner: partition-0 NIC rate multiplier")
    ap.add_argument("--slow-factor", type=float, default=1.5,
                    help="slow_worker: rank-0 t_base multiplier")
    ap.add_argument("--demand-bias", type=float, default=0.6,
                    help="demand_skew: share of globally-hot nodes "
                         "pre-assigned to partition 0")
    ap.add_argument("--iterations", type=int, default=6000,
                    help="DQN training budget for the greendygnn policies")
    ap.add_argument("--force", action="store_true",
                    help="retrain the policies even if cached")
    ap.add_argument("--mixture", action="store_true",
                    help="add the per-rank policy-mixture axis "
                         "(ClusterConfig.methods) under slow_worker")
    ap.add_argument("--mem-budget", default="",
                    help="comma list of tiered host-budget levels: named "
                         "presets (tight, loose) or fractions of the "
                         "graph's feature bytes (e.g. 0.15)")
    ap.add_argument("--chunk-rows", type=int, default=256,
                    help="host-tier block granularity (feature rows)")
    ap.add_argument("--trace", action="store_true",
                    help="capture a greentrace payload per cell (written "
                         "under results/paper_torch/traces/, "
                         "reconciled)")
    ap.add_argument("--check", action="store_true",
                    help="assert the cluster-twin acceptance at --check-p "
                         "(and the memory gates when --mem-budget is set)")
    ap.add_argument("--check-p", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="where the runs and the policies go (default: "
                         "%(default)s)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    result = run_sweep(args)
    path = save_json("cluster_sweep", result, RESULTS_DIR)
    print(f"\nwrote {path}")
    if args.check:
        check_acceptance(result, args.check_p)
        if args.mem_budget:
            check_mem_acceptance(result, args.check_p)
    return result


if __name__ == "__main__":
    main()
