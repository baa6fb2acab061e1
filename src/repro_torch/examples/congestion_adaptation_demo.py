"""Congestion-adaptation demo: watch the controller react live.

Runs the trace-driven trainer twice, static cache (RapidGNN) against
adaptive (the heuristic Eq. 7 controller, or the full Double-DQN with
``--rl``), under a net-fabric congestion scenario, and prints an
epoch-by-epoch side-by-side: effective congestion multiplier, chosen
window, hit rate, energy:

    python -m repro_torch.examples.congestion_adaptation_demo
    python -m repro_torch.examples.congestion_adaptation_demo \\
        --scenario incast
    python -m repro_torch.examples.congestion_adaptation_demo \\
        --scenario trace:my_delta_trace.json --rl

Any registry name works (``repro_torch.net.ScenarioRegistry.names()``):
clean, paper_schedule, fixed:<ms>, bursty_markov, diurnal, incast,
straggler, trace:<path>, arch_none .. arch_osc. ``--closed-form`` restores
the analytic path for comparison. Port of
``examples/congestion_adaptation_demo.py``.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.device import resolve
from repro_torch.train import gnn_trainer as gt
from repro_torch.train import policy as pol

POLICY_ITERATIONS = 8_000


def make_config(scenario: str | None = "paper_schedule", epochs: int = 14,
                batch: int = 2000, device: str = "cuda") -> gt.RunConfig:
    """``scenario=None`` is the closed form."""
    return gt.RunConfig(dataset="reddit", batch_size=batch,
                        n_epochs=epochs, steps_per_epoch=32,
                        congested=True, scenario=scenario, device=device)


def run_pair(cfg: gt.RunConfig, bundle, rl: bool) -> dict:
    """{"rapidgnn": run, adaptive name: run} on one trace; the adaptive
    side is ``qnet_example`` (table-calibrated on this trace) with
    ``rl``, else the heuristic."""
    if rl:
        tp = pol.calibrate_table_from_bundle(bundle, cfg)
        q_fn, _ = pol.get_or_train_policy(
            pol.make_params_pool([tp], device=cfg.device),
            name="qnet_example", iterations=POLICY_ITERATIONS,
            device=cfg.device,
        )
        adaptive_cfg = dataclasses.replace(cfg, method="greendygnn", q_fn=q_fn)
        adaptive_name = "greendygnn"
    else:
        adaptive_cfg = dataclasses.replace(cfg, method="heuristic")
        adaptive_name = "heuristic"
    return {
        "rapidgnn": gt.run(dataclasses.replace(cfg, method="rapidgnn"),
                           bundle),
        adaptive_name: gt.run(adaptive_cfg, bundle),
    }


def table(cfg: gt.RunConfig, runs: dict) -> list[str]:
    """The epoch-by-epoch side-by-side and each run's totals."""
    label = ("closed form" if cfg.scenario is None
             else f"scenario={cfg.scenario}")
    lines = [f"\n[{label}]",
             f"{'ep':>3} {'sigma max':>9} | {'W static':>8} {'W adapt':>8} | "
             f"{'hit stat':>8} {'hit adpt':>8}"]
    static = runs["rapidgnn"]
    adapt = next(r for name, r in runs.items() if name != "rapidgnn")
    sigma = adapt.sigma_trace.max(axis=1)
    for e in range(cfg.n_epochs):
        lines.append(
            f"{e:3d} {sigma[e]:9.2f} | {static.window_per_epoch[e]:8.1f} "
            f"{adapt.window_per_epoch[e]:8.1f} | "
            f"{static.hit_rate_per_epoch[e]:8.3f} "
            f"{adapt.hit_rate_per_epoch[e]:8.3f}")
    for name, r in runs.items():
        t = r.totals()
        lines.append(f"{name:12s} total={t['total_kj']:7.2f} kJ "
                     f"ET={r.meter.mean_epoch_time()*1e3:6.1f} ms")
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenario", default="paper_schedule",
                    help="net-fabric scenario name (default: %(default)s)")
    ap.add_argument("--closed-form", action="store_true",
                    help="use the analytic Eq. 4 path instead of the fabric")
    ap.add_argument("--rl", action="store_true",
                    help="adaptive = trained Double-DQN (trains/loads the "
                         "qnet_example artifact) instead of the heuristic")
    ap.add_argument("--epochs", type=int, default=14)
    ap.add_argument("--batch", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve(args.device)        # raises for the card where there is none

    cfg = make_config(None if args.closed_form else args.scenario,
                      args.epochs, args.batch, args.device)
    print("building shared trace...")
    bundle = gt.build_trace(cfg)
    runs = run_pair(cfg, bundle, args.rl)
    print("\n".join(table(cfg, runs)))
    return runs


if __name__ == "__main__":
    main()
