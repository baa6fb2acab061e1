"""Cross-scenario policy gauntlet: train-env x eval-scenario energy matrix.

Port of ``benchmarks/policy_gauntlet.py``. Trains one Double-DQN per
training environment (analytic parametric sim, trace-calibrated tabular
sim, queue-aware scenario-conditioned sim) and evaluates every policy —
plus the dgl / bgl / static baselines — on every net-fabric scenario
through the trace-driven trainer. This is the paper's
headline claim made measurable: a policy trained in a calibrated simulator
with domain-randomized congestion must transfer to dynamics it was not
hand-tuned for. The JSON output makes policy-quality drift trackable
from one change to the next.

    python -m repro_torch.paper.policy_gauntlet --steps 96 \
        --iterations 4000
    python -m repro_torch.paper.policy_gauntlet --check   # acceptance

``--check`` asserts the gauntlet's acceptance criteria: the
queue-sim-trained policy is no worse than the analytic-sim-trained
policy on every fabric scenario, strictly better on bursty_markov and
incast, and within 5% on clean.

``--device`` (default ``cuda``, raising without a card) is where the
policies train (the queue env through the ``queue_window`` kernel), where
their qnets run and where the runs go. Policies are cached under
``repro_torch.train.policy.ARTIFACT_DIR`` with the reference's names; the
JSON goes to ``results/paper_torch/policy_gauntlet.json``.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.device import resolve
from repro_torch.net import ScenarioRegistry
from repro_torch.paper.common import RESULTS_DIR, base_cfg, save_json
from repro_torch.train import gnn_trainer as gt
from repro_torch.train import policy as pol

BASELINES = ["dgl", "bgl", "static_w"]
METHOD_LABEL = {"static_w": "static"}
TRAIN_ENVS = ["analytic", "table", "queue"]
# the two scenarios where queue-aware training must strictly win (--check)
MUST_WIN = ("bursty_markov", "incast")


def default_scenarios() -> list[str]:
    return [n for n in ScenarioRegistry.names() if ":" not in n]


def build_pools(args, cfg0, bundle) -> dict:
    """Per-env parameter pools. ``--quick`` skips Algorithm-1 calibration
    (benchmark-speed mode: published constants + the trace's true feature
    width); the table env always needs its trace replay."""
    pools = {}
    if "table" in args.train_envs:
        print("calibrating tabular Phase 2 (trace replay)...", flush=True)
        pools["table"] = pol.make_params_pool(
            [pol.calibrate_table_from_bundle(bundle, cfg0)],
            device=cfg0.device,
        )
    if "analytic" in args.train_envs or "queue" in args.train_envs:
        if args.quick:
            from repro_torch.graph.features import ShardedFeatureStore

            graph, owner, traces, _ = bundle
            store = ShardedFeatureStore(
                graph.features, owner, 0, cfg0.n_parts
            )
            # trace-derived scales without the Phase-2 stall-grid runs: the
            # REAL mean remote rows per step and bytes per row (these set
            # the queue sim's payload/backlog physics), with t_miss0
            # rescaled to keep the analytic env's calibrated R * t_miss0
            # product at its published operating point
            r_mean = float(np.mean(
                [len(store.remote_ids_of(t)) for ep in traces[:2] for t in ep]
            ))
            base = cm.CostModelParams()
            theta = base.replace(
                feature_bytes=store.bytes_per_row,
                remote_nodes=r_mean,
                t_miss0=float(base.t_miss0) * float(base.remote_nodes)
                / max(r_mean, 1.0),
            )
        else:
            print("calibrating analytic Phase 2 (Algorithm 1)...", flush=True)
            theta, _ = pol.calibrate_from_bundle(bundle, cfg0)
        analytic_pool = pol.make_params_pool([theta], device=cfg0.device)
        for env in ("analytic", "queue"):
            if env in args.train_envs:
                pools[env] = analytic_pool
    return pools


def train_policies(args, pools, cfg0) -> dict:
    # Training episodes run the paper's 30-epoch horizon (scenario burst /
    # cycle timescales are run-length-relative in BOTH the training envs
    # and the eval fabric, so the congestion families line up at any eval
    # --steps budget). Matching the eval horizon instead sounds more
    # faithful but collapses every policy onto one or two post-warmup
    # decisions — too few to learn (or to measure) scenario-conditional
    # behavior.
    q_fns = {}
    for env in args.train_envs:
        print(f"training policy on env={env} "
              f"({args.iterations} iterations, "
              f"{args.train_epochs}x32-step episodes)...", flush=True)
        # every knob that changes the trained policy — training settings AND
        # the trace/calibration shape behind the params pool — is part of
        # the cache key, so reruns with different settings never reuse a
        # stale qnet
        name = (
            f"qnet_gauntlet_{args.dataset}_b{args.batch}"
            f"_t{args.steps}x{args.steps_per_epoch}_i{args.iterations}"
            f"_e{args.train_epochs}_n{args.n_envs}_s{args.seed}"
            + ("_quick" if args.quick else "")
        )
        q_fn, _ = pol.get_or_train_policy(
            pools[env], name=name,
            iterations=args.iterations, env=env, force=args.force,
            seed=args.seed, n_epochs=args.train_epochs, n_envs=args.n_envs,
            device=cfg0.device,
        )
        q_fns[env] = q_fn
    return q_fns


def run_gauntlet(args, cfg0, bundle, q_fns) -> dict:
    scenarios = (
        args.scenarios.split(",") if args.scenarios else default_scenarios()
    )
    columns = BASELINES + [f"dqn_{e}" for e in args.train_envs]
    rows: dict = {}
    header = f"{'scenario':>16} " + "".join(
        f"{METHOD_LABEL.get(c, c):>13}" for c in columns
    )
    print("\ntotal energy [kJ] per scenario x policy")
    print(header)
    for sc in scenarios:
        rows[sc] = {}
        cells = []
        for col in columns:
            if col.startswith("dqn_"):
                cfg = dataclasses.replace(
                    cfg0, method="greendygnn", scenario=sc,
                    q_fn=q_fns[col[len("dqn_"):]],
                )
            else:
                cfg = dataclasses.replace(cfg0, method=col, scenario=sc)
            r = gt.run(cfg, bundle)
            t = r.totals()
            rows[sc][col] = {
                "total_kj": t["total_kj"],
                "cpu_kj": t["cpu_kj"],
                "gpu_kj": t["gpu_kj"],
                "wall_s": t["wall_s"],
                "hit_rate": float(r.hit_rate_per_epoch.mean()),
                "mean_window": float(r.window_per_epoch.mean()),
                "mean_sigma": float(r.sigma_trace.mean()),
            }
            cells.append(f"{t['total_kj']:13.3f}")
        print(f"{sc:>16} " + "".join(cells))
    return rows


def check_acceptance(rows: dict, tol_eq: float = 0.02,
                     tol_clean: float = 0.05) -> None:
    """The gauntlet's acceptance: queue <= analytic everywhere (within
    ``tol_eq``), strictly better on MUST_WIN, clean parity within
    ``tol_clean``."""
    missing = [s for s in (*MUST_WIN, "clean") if s not in rows]
    if missing:
        raise SystemExit(
            "--check needs the clean and must-win scenarios evaluated; "
            "missing: " + ", ".join(missing)
        )
    failures = []
    for sc, cols in rows.items():
        if "dqn_queue" not in cols or "dqn_analytic" not in cols:
            raise SystemExit("--check needs both queue and analytic envs")
        q = cols["dqn_queue"]["total_kj"]
        a = cols["dqn_analytic"]["total_kj"]
        # clean is governed by its own (looser, one-sided) parity band below
        if sc != "clean" and q > a * (1.0 + tol_eq):
            failures.append(
                f"{sc}: queue {q:.3f} kJ worse than analytic {a:.3f} kJ"
            )
        if sc in MUST_WIN and not q < a:
            failures.append(
                f"{sc}: queue {q:.3f} kJ not strictly below "
                f"analytic {a:.3f} kJ"
            )
        # parity is one-sided: the guard is against queue-aware training
        # SACRIFICING clean performance for congestion robustness; beating
        # the analytic policy on clean is a win, not a parity violation
        if sc == "clean" and q > a * (1.0 + tol_clean):
            failures.append(
                f"clean: queue {q:.3f} kJ more than {tol_clean:.0%} above "
                f"analytic {a:.3f} kJ"
            )
    if failures:
        raise SystemExit("gauntlet acceptance FAILED:\n  " +
                         "\n  ".join(failures))
    print("\ngauntlet acceptance PASSED: queue-trained policy is no worse "
          "everywhere, strictly better on " + ", ".join(MUST_WIN) +
          ", clean parity held")


def parse_args(argv=None) -> argparse.Namespace:
    """The command line's flags: the reference's, and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="reddit")
    ap.add_argument("--batch", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=128,
                    help="total eval train steps per run (bounds runtime)")
    ap.add_argument("--steps-per-epoch", type=int, default=16)
    ap.add_argument("--iterations", type=int, default=4_000,
                    help="DQN training iterations per env")
    ap.add_argument("--train-epochs", type=int, default=30,
                    help="episode length (epochs) inside the training envs")
    ap.add_argument("--n-envs", type=int, default=64,
                    help="vectorized training environments")
    ap.add_argument("--train-envs", default=",".join(TRAIN_ENVS))
    ap.add_argument("--scenarios", default="",
                    help="comma list (default: every non-parametric "
                         "registry scenario)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="skip Algorithm-1 calibration (published constants)")
    ap.add_argument("--force", action="store_true",
                    help="retrain policies even if artifacts exist")
    ap.add_argument("--check", action="store_true",
                    help="assert the gauntlet's acceptance criteria")
    ap.add_argument("--device", default="cuda",
                    help="where the policies and the runs go (default: "
                         "%(default)s)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    args.train_envs = args.train_envs.split(",")
    resolve(args.device)

    steps_per_epoch = args.steps_per_epoch
    n_epochs = max(args.steps // steps_per_epoch, 3)
    cfg0 = base_cfg(args.dataset, args.batch, device=args.device)
    cfg0 = dataclasses.replace(
        cfg0, n_epochs=n_epochs, steps_per_epoch=steps_per_epoch,
        seed=args.seed,
    )
    print(f"building shared trace ({args.dataset}, B={args.batch}, "
          f"{n_epochs}x{steps_per_epoch} steps)...", flush=True)
    bundle = gt.build_trace(cfg0)

    pools = build_pools(args, cfg0, bundle)
    q_fns = train_policies(args, pools, cfg0)
    rows = run_gauntlet(args, cfg0, bundle, q_fns)

    result = {
        "dataset": args.dataset, "batch": args.batch,
        "n_epochs": n_epochs, "steps_per_epoch": steps_per_epoch,
        "iterations": args.iterations, "train_envs": args.train_envs,
        "seed": args.seed, "rows": rows,
    }
    path = save_json("policy_gauntlet", result, RESULTS_DIR)
    print(f"\nwrote {path}")
    if args.check:
        check_acceptance(rows)
    return result


if __name__ == "__main__":
    main()
