#!/usr/bin/env python3
"""Host wall a step with greentrace on and off, in alternating pairs.

Usage (from the repository root; on a machine with a CUDA card, or with
``--device cpu``):

    python3 scripts/trace_overhead.py [--device cuda] [--pairs 8]

The runs are ``chip_smoke.py``'s cluster runs at the main path's widths
and batch (the reddit stand-in, batch 2000, fanouts (10, 25), measured
lane, device payloads, static_w, 3 epochs of 8 steps): P = 1 through
``gnn_trainer.run`` on the closed form, and P = 4 through ``run_cluster``
under ``clean``. Each P runs ``--pairs`` pairs, untraced and traced in
turns (off on, on off, ...), so a drift of the host over the call falls
on both sides. Each run reports the median host wall of a step (P = 1:
around ``TrainerWorker.step``; P = 4: the spacing of the driver's
publishes, a global step of 4 rank-steps), the host time spent inside
the tracer a step (event construction, the charge laws and the measured
step's roofline terms: ``Tracer.emit``, ``TrainerWorker._trace_step``
and ``_trace_tier_counters``, outermost calls only), and the garbage
collector's collections by generation. The last line is a JSON summary
with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import pathlib
import statistics
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


class InTracer:
    """Host seconds spent inside the wrapped tracer functions, counting
    only the outermost call on each thread."""

    def __init__(self):
        self.seconds = 0.0
        self._depth = threading.local()

    def wrap(self, fn):
        @functools.wraps(fn)
        def timed(*a, **k):
            depth = getattr(self._depth, "n", 0)
            self._depth.n = depth + 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self._depth.n = depth
                if depth == 0:
                    self.seconds += time.perf_counter() - t0

        return timed


@contextlib.contextmanager
def patched(owner, name, wrapper):
    original = getattr(owner, name)
    setattr(owner, name, wrapper(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def collections() -> list[int]:
    return [g["collections"] for g in gc.get_stats()]


def one_run(torch, chip_smoke, p: int, traced: bool, device, bundles):
    """(host ms a step, in-tracer ms a step, GC collections by
    generation) of one run."""
    from repro_torch.obs.tracer import Tracer
    from repro_torch.train import cluster as cl
    from repro_torch.train import gnn_trainer as gt
    from repro_torch.train.worker import TrainerWorker

    clock = InTracer()
    with contextlib.ExitStack() as stack:
        for owner, name in ((Tracer, "emit"), (TrainerWorker, "_trace_step"),
                            (TrainerWorker, "_trace_tier_counters")):
            stack.enter_context(patched(owner, name, clock.wrap))
        gc0 = collections()
        if p == 1:
            cfg = chip_smoke.cluster_cfg(device, trace=traced)
            with chip_smoke.steps_timed() as walls:
                res = gt.run(cfg, bundles[0])
            torch.cuda.synchronize() if device.type == "cuda" else None
            n_steps = len(res.step_hits)
        else:
            cfg = chip_smoke.cluster_cfg(device, scenario="clean",
                                         trace=traced)
            with chip_smoke.global_steps_timed() as stamps:
                res = cl.run_cluster(cfg, cl.ClusterConfig(n_workers=p),
                                     trace_bundles=bundles)
            walls = [b - a for a, b in zip(stamps, stamps[1:])]
            n_steps = len(res.results[0].step_hits)
        gc1 = collections()
    if traced:
        from repro_torch.obs import reconcile

        reconcile(res.trace)
    return (statistics.median(walls) * 1e3, clock.seconds * 1e3 / n_steps,
            [b - a for a, b in zip(gc0, gc1)])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pairs", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.device import resolve
    from repro_torch.train import cluster as cl
    from repro_torch.train import gnn_trainer as gt

    device = resolve(args.device)
    smi = chip_smoke.smi_line() if device.type == "cuda" else "cpu"
    cpu_cfg = gt.RunConfig(**chip_smoke.CLUSTER, device="cpu")
    summary = {"device": smi, "pairs": args.pairs}
    for p in (1, chip_smoke.CLUSTER_P):
        bundles = cl.build_cluster_traces(cpu_cfg, p)
        one_run(torch, chip_smoke, p, False, device, bundles)  # warm-up
        host = {False: [], True: []}
        inside = []
        for k in range(2 * args.pairs):
            traced = k % 4 in (1, 2)
            ms, tracer_ms, gcs = one_run(torch, chip_smoke, p, traced,
                                         device, bundles)
            host[traced].append(ms)
            if traced:
                inside.append(tracer_ms)
            print(f"P={p} run {k} trace={traced}: host {ms:.3f} ms a step, "
                  f"in the tracer {tracer_ms:.4f} ms a step, GC "
                  f"collections {gcs}", flush=True)
        diffs = [on - off for on, off in zip(host[True], host[False])]
        summary[f"p{p}"] = {
            "host_ms_untraced": statistics.median(host[False]),
            "host_ms_traced": statistics.median(host[True]),
            "median_pair_diff_ms": statistics.median(diffs),
            "traced_slower_pairs": sum(d > 0 for d in diffs),
            "untraced_iqr_ms": (statistics.quantiles(host[False], n=4)[2]
                                - statistics.quantiles(host[False], n=4)[0]),
            "in_tracer_ms": statistics.median(inside),
        }
        print(f"P={p}: {summary[f'p{p}']}; {smi}", flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
