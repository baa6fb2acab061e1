"""greentrace CLI: trace capture and the "where did the joules go" analyzer.

Port of ``repro/obs/__main__.py``, with the reference's flags, and
``--device`` (``cuda`` unless asked for ``cpu``) for the captured runs::

    # analyze a trace (top-k spans, attribution, per-window waterfall)
    python -m repro_torch.obs report results/traces/hot_owner.json

    # rank the energy movers between two scenarios
    python -m repro_torch.obs report --diff results/traces/clean.json \
        results/traces/hot_owner.json

    # capture traced runs (and gate reconciliation, traced == untraced
    # digests, and wall overhead); files land in build/traces
    python -m repro_torch.obs capture --workers 4 --check

The default ``--out`` is ``build/traces``: ``results/traces/*.json`` are
the reference's 4-worker captures, which ``capture --workers 4`` at the
default settings reproduces byte for byte.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from repro_torch.obs import export as ox
from repro_torch.obs import report as orep
from repro_torch.obs.tracer import reconcile


def _cmd_report(args) -> int:
    if args.diff:
        a = ox.load_trace(args.diff[0])
        b = ox.load_trace(args.diff[1])
        if args.json:
            print(json.dumps(orep.diff(a, b)[: args.top], indent=2))
        else:
            print(orep.format_diff(a, b, args.top))
        return 0
    payload = ox.load_trace(args.trace)
    if args.chrome:
        out = ox.write_chrome(args.chrome, payload)
        print(f"[greentrace] chrome trace_event JSON -> {out} "
              f"(open in ui.perfetto.dev)")
        return 0
    if args.json:
        print(json.dumps({
            "reconciled": {
                str(r): t for r, t in reconcile(payload).items()
            },
            "attribution": orep.attribution(payload),
            "top_spans": orep.top_spans(payload, args.top),
            "waterfall": orep.waterfall(payload),
        }, indent=2))
    else:
        print(orep.format_report(payload, args.top))
    return 0


def _scenario_physics(name: str, n_parts: int, hot_rate: float):
    """The emergent-scenario physics the cluster_sweep bench uses."""
    import numpy as np

    if name == "clean":
        return {}
    if name == "hot_owner":
        hot = np.ones(n_parts)
        hot[0] = hot_rate
        return {"link_rate_scale": tuple(hot)}
    raise SystemExit(f"unknown capture scenario {name!r} "
                     f"(expected clean or hot_owner)")


def _run_pair(cfg, cluster_kw, traced: bool):
    """One cluster run; returns (report, wall_seconds)."""
    from repro_torch.train.cluster import ClusterConfig, run_cluster

    cfg_t = dataclasses.replace(cfg, trace=traced)
    t0 = time.perf_counter()
    rep = run_cluster(cfg_t, ClusterConfig(**cluster_kw))
    return rep, time.perf_counter() - t0


def _cmd_capture(args) -> int:
    from repro_torch.analysis.digest import report_digest
    from repro_torch.train.gnn_trainer import RunConfig

    n_epochs = max(args.steps // args.steps_per_epoch, 1)
    cfg = RunConfig(
        method=args.method, dataset=args.dataset, batch_size=args.batch,
        n_epochs=n_epochs, steps_per_epoch=args.steps_per_epoch,
        scenario="clean", seed=args.seed, device=args.device,
    )
    cluster_kw = {"n_workers": args.workers}
    failures = []
    for name in args.scenarios.split(","):
        name = name.strip()
        kw = dict(cluster_kw, **_scenario_physics(
            name, cfg.n_parts, args.hot_rate
        ))
        rep, wall_traced = _run_pair(cfg, kw, traced=True)
        payload = rep.trace
        # stamp the capture scenario name so diffs are labeled correctly
        payload["meta"]["scenario"] = name
        out = ox.write_trace(f"{args.out}/{name}.json", payload)
        totals = reconcile(payload)  # raises on a broken ledger
        gpu = sum(t["gpu_j"] for t in totals.values())
        cpu = sum(t["cpu_j"] for t in totals.values())
        print(f"[greentrace] {name}: {len(payload['ranks'])} ranks, "
              f"{sum(len(s['events']) for s in payload['ranks'])} events, "
              f"gpu={gpu:.1f}J cpu={cpu:.1f}J (reconciled) -> {out}")
        if args.check:
            # modeled-lane identity: the traced run's result digest must be
            # bit-identical to the untraced run's (tracing only observes)
            rep_off, wall_off = _run_pair(cfg, kw, traced=False)
            if report_digest(rep) != report_digest(rep_off):
                failures.append(
                    f"{name}: traced report digest != untraced digest"
                )
            if rep_off.trace is not None:
                failures.append(f"{name}: trace=False produced a trace")
            # wall overhead: best-of-N to shave scheduler noise
            for _ in range(max(args.reps - 1, 0)):
                _, w = _run_pair(cfg, kw, traced=True)
                wall_traced = min(wall_traced, w)
                _, w = _run_pair(cfg, kw, traced=False)
                wall_off = min(wall_off, w)
            over = (wall_traced - wall_off) / max(wall_off, 1e-9)
            print(f"[greentrace] {name}: wall overhead "
                  f"{over * 100:+.2f}% (traced {wall_traced:.2f}s vs "
                  f"untraced {wall_off:.2f}s, limit {args.overhead:.0%})")
            if over > args.overhead:
                failures.append(
                    f"{name}: tracing overhead {over:.1%} > "
                    f"{args.overhead:.0%}"
                )
    if failures:
        print("[greentrace] CHECK FAILED:")
        for f in failures:
            print(f"  - {f}")
        return 1
    if args.check:
        print("[greentrace] check passed: reconciliation bit-exact, "
              "modeled lane untouched, overhead within budget")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("report", help="analyze a trace file")
    rp.add_argument("trace", nargs="?", help="greentrace JSON payload")
    rp.add_argument("--diff", nargs=2, metavar=("A", "B"),
                    help="rank energy movers between two traces")
    rp.add_argument("--top", type=int, default=10)
    rp.add_argument("--json", action="store_true",
                    help="machine-readable analyzer output")
    rp.add_argument("--chrome", metavar="OUT",
                    help="write Chrome trace_event JSON for Perfetto")

    cp = sub.add_parser("capture", help="run traced cluster runs")
    cp.add_argument("--workers", type=int, default=2)
    cp.add_argument("--steps", type=int, default=32,
                    help="total training steps")
    cp.add_argument("--steps-per-epoch", type=int, default=16)
    cp.add_argument("--batch", type=int, default=600)
    cp.add_argument("--dataset", default="reddit")
    cp.add_argument("--method", default="static_w")
    cp.add_argument("--seed", type=int, default=0)
    cp.add_argument("--scenarios", default="clean,hot_owner")
    cp.add_argument("--hot-rate", type=float, default=0.35,
                    help="hot_owner: partition-0 NIC rate multiplier")
    cp.add_argument("--out", default="build/traces")
    cp.add_argument("--device", default="cuda",
                    help="where the runs' device work goes (cuda or cpu)")
    cp.add_argument("--check", action="store_true",
                    help="assert reconciliation, modeled-lane digest "
                         "identity and wall overhead")
    cp.add_argument("--overhead", type=float, default=0.03,
                    help="max traced/untraced wall overhead fraction")
    cp.add_argument("--reps", type=int, default=5,
                    help="overhead timing repetitions (best-of)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.cmd == "report":
        if not args.diff and not args.trace:
            ap.error("report needs a trace file or --diff A B")
        return _cmd_report(args)
    return _cmd_capture(args)


if __name__ == "__main__":
    sys.exit(main())
