"""Per-scenario energy/time sweep across methods on the net fabric.

Port of ``benchmarks/scenario_sweep.py``. Runs every registry scenario
(or a chosen subset) end-to-end through the trace-driven trainer for dgl
/ bgl / static (static_w) / adaptive (heuristic) and prints a Table-I
style grid: total energy, mean epoch time, mean hit rate, mean effective
sigma. The adaptive method needs no pretrained artifact, so the whole
sweep is self-contained.

    python -m repro_torch.paper.scenario_sweep --steps 120
    python -m repro_torch.paper.scenario_sweep \\
        --scenarios clean,incast,trace:mytrace.json --methods dgl,heuristic

``--workers P`` (P > 1) runs every cell as a concurrent P-worker cluster
over ONE shared requester-aware fabric (``repro_torch.train.cluster``):
the scenario's background processes become optional overlays on top of
the *emergent* cross-worker congestion, and the reported energy is the
cluster total summed over the P trainers (see
``repro_torch.paper.cluster_sweep`` for the dedicated emergent-vs-injected
comparison).

``--check-clean-parity`` additionally runs the closed-form path on the
clean scenario's config and asserts the fabric totals agree within 5%
(the acceptance cross-check), plus bit-reproducibility of the hit/miss
stream across two seeded fabric runs.

``--device`` (default ``cuda``, raising without a card) is where the runs
go; the JSON goes to ``results/paper_torch/scenario_sweep.json`` and
``--trace`` payloads under ``results/paper_torch/traces/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from repro_torch.device import resolve
from repro_torch.net import ScenarioRegistry
from repro_torch.paper.common import RESULTS_DIR, base_cfg, save_json
from repro_torch.train import gnn_trainer as gt

DEFAULT_METHODS = ["dgl", "bgl", "static_w", "heuristic"]
METHOD_LABEL = {"static_w": "static", "heuristic": "adaptive"}


def default_scenarios() -> list[str]:
    return [n for n in ScenarioRegistry.names() if ":" not in n]


def run_sweep(args) -> dict:
    resolve(args.device)
    steps_per_epoch = args.steps_per_epoch
    n_epochs = max(args.steps // steps_per_epoch, 2)
    workers = max(int(getattr(args, "workers", 1)), 1)
    cfg0 = base_cfg(args.dataset, args.batch, device=args.device)
    cfg0 = dataclasses.replace(
        cfg0, n_epochs=n_epochs, steps_per_epoch=steps_per_epoch,
        seed=args.seed,
    )
    print(f"building shared trace ({args.dataset}, B={args.batch}, "
          f"{n_epochs}x{steps_per_epoch} steps"
          + (f", P={workers} workers" if workers > 1 else "")
          + ")...", flush=True)
    if workers > 1:
        from repro_torch.train.cluster import (
            ClusterConfig, build_cluster_traces, run_cluster,
        )

        bundles = build_cluster_traces(cfg0, workers)
    else:
        bundle = gt.build_trace(cfg0)

    scenarios = (
        args.scenarios.split(",") if args.scenarios else default_scenarios()
    )
    methods = args.methods.split(",")

    rows: dict = {}
    header = f"{'scenario':>16} " + "".join(
        f"{METHOD_LABEL.get(m, m):>12}" for m in methods
    )
    print("\ntotal energy [kJ] per scenario x method "
          "(epoch time / hit rate in the JSON)")
    print(header)
    for sc in scenarios:
        rows[sc] = {}
        cells = []
        for m in methods:
            cfg_m = dataclasses.replace(
                cfg0, method=m, scenario=sc, trace=args.trace,
            )
            if workers > 1:
                rep = run_cluster(
                    cfg_m, ClusterConfig(n_workers=workers),
                    trace_bundles=bundles,
                )
                if args.trace and rep.trace is not None:
                    _save_cell_trace(rep.trace, sc, m, workers)
                t = rep.totals_kj()
                r0 = rep.results[0]
                rows[sc][m] = {
                    "total_kj": t["total_kj"],
                    "gpu_kj": t["gpu_kj"],
                    "cpu_kj": t["cpu_kj"],
                    "wall_s": t["wall_s"],
                    "mean_epoch_ms": r0.meter.mean_epoch_time() * 1e3,
                    "hit_rate": float(np.mean([
                        float(r.hit_rate_per_epoch.mean())
                        for r in rep.results
                    ])),
                    "mean_sigma": float(r0.sigma_trace.mean()),
                    "queue_s": rep.total_queue_s,
                    "per_worker": rep.per_worker(),
                }
            else:
                r = gt.run(cfg_m, bundle)
                if args.trace and r.trace is not None:
                    _save_cell_trace(r.trace, sc, m, workers)
                t = r.totals()
                rows[sc][m] = {
                    "total_kj": t["total_kj"],
                    "gpu_kj": t["gpu_kj"],
                    "cpu_kj": t["cpu_kj"],
                    "wall_s": t["wall_s"],
                    "mean_epoch_ms": r.meter.mean_epoch_time() * 1e3,
                    "hit_rate": float(r.hit_rate_per_epoch.mean()),
                    "mean_sigma": float(r.sigma_trace.mean()),
                }
            cells.append(f"{rows[sc][m]['total_kj']:12.3f}")
        sig = rows[sc][methods[0]]["mean_sigma"]
        print(f"{sc:>16} " + "".join(cells) + f"   (sigma~{sig:.2f})")
    return {
        "dataset": args.dataset, "batch": args.batch,
        "n_epochs": n_epochs, "steps_per_epoch": steps_per_epoch,
        "seed": args.seed, "workers": workers, "rows": rows,
    }


def _save_cell_trace(payload, sc, method, workers) -> None:
    """Reconcile and persist one cell's greentrace payload."""
    from repro_torch.obs import reconcile, write_trace

    reconcile(payload)  # hard-fail on a broken energy ledger
    safe = sc.replace(":", "_").replace("/", "_")
    path = write_trace(
        os.path.join(
            RESULTS_DIR, "traces",
            f"scenario_sweep_p{workers}_{safe}_{method}.json",
        ),
        payload,
    )
    print(f"    trace -> {path}")


def check_clean_parity(args) -> None:
    """Acceptance: fabric(clean) vs closed form within 5%; bit-repro."""
    resolve(args.device)
    cfg = base_cfg(args.dataset, args.batch, device=args.device)
    cfg = dataclasses.replace(
        cfg, method="static_w",
        n_epochs=max(args.steps // args.steps_per_epoch, 2),
        steps_per_epoch=args.steps_per_epoch, congested=False,
        seed=args.seed,
    )
    bundle = gt.build_trace(cfg)
    closed = gt.run(cfg, bundle)
    fab1 = gt.run(dataclasses.replace(cfg, scenario="clean"), bundle)
    fab2 = gt.run(dataclasses.replace(cfg, scenario="clean"), bundle)

    e_c = closed.totals()["total_kj"]
    e_f = fab1.totals()["total_kj"]
    rel = abs(e_f - e_c) / e_c
    print(f"\nclean parity: closed={e_c:.4f} kJ fabric={e_f:.4f} kJ "
          f"rel={rel:.3%}")
    assert rel < 0.05, f"clean fabric diverges from closed form: {rel:.3%}"

    np.testing.assert_array_equal(fab1.step_hits, fab2.step_hits)
    np.testing.assert_array_equal(fab1.step_misses, fab2.step_misses)
    np.testing.assert_array_equal(
        fab1.fetched_rows_by_owner, fab2.fetched_rows_by_owner
    )
    print("bit-reproducibility: identical hit/miss stream and per-owner "
          "fetched rows across two fabric runs")


def parse_args(argv=None) -> argparse.Namespace:
    """The command line's flags: the reference's, and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="reddit")
    ap.add_argument("--batch", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=128,
                    help="total train steps per run (bounds runtime)")
    ap.add_argument("--steps-per-epoch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scenarios", default="",
                    help="comma list (default: every non-parametric "
                         "registry scenario)")
    ap.add_argument("--methods", default=",".join(DEFAULT_METHODS))
    ap.add_argument("--workers", type=int, default=1,
                    help="P > 1: run each cell as a concurrent P-worker "
                         "cluster over one shared fabric (emergent "
                         "cross-worker congestion + the scenario overlay)")
    ap.add_argument("--trace", action="store_true",
                    help="capture a greentrace payload per cell (written "
                         "under results/paper_torch/traces/, reconciled)")
    ap.add_argument("--check-clean-parity", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the runs go (default: %(default)s)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    result = run_sweep(args)
    path = save_json("scenario_sweep", result, RESULTS_DIR)
    print(f"\nwrote {path}")
    if args.check_clean_parity:
        check_clean_parity(args)
    return result


if __name__ == "__main__":
    main()
