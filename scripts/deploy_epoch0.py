#!/usr/bin/env python3
"""Read the first deployment run's epoch-0 joules in fresh processes, on
one CUDA card.

Usage (from the repository root, on a machine with an H100):

    python3 scripts/deploy_epoch0.py [N_PROCESSES] [--gc-freeze] [--ungated]

``chip_smoke.py``'s deployment phase holds the first ``run_cluster`` of
its fresh process (static_w, ``clean``, P = 4, the measured lane, 3
epochs of 8 steps) to its epoch 0 costing, on every rank, within
``chip_smoke.EPOCH0_BAND`` of the later epochs' joules. This script runs
that same first run, then a second one, in each of N fresh processes
(default 5) and prints, for every rank, its joules per epoch, its
untimed first runs (``compile_s``) and every measured step's time: a
step that took tens of ms more than its neighbours shows where an
epoch's excess comes from. Each run also lists the interpreter's garbage
collections that took 1 ms or more (generation, ms), read through
``gc.callbacks``, and the count of each generation's collections. With
``--gc-freeze`` every other process (the odd ones) moves the objects
alive after its set-up to the permanent generation (``gc.freeze``), so
runs with and without the collector's full passes run side by side.
With ``--ungated`` every other process (the odd ones) times each measured
step as the engine did before its step gate (``kernels/step_gate``):
CUDA events around the enqueue of the step's launches, so that a host
stall while they are enqueued is timed too; the even processes time it
behind the gate. Each run's line gives its measured steps' median and
largest time and their ratio; a gated run must keep every step within
``MAX_STEP_RATIO`` of its median, else the script exits 1. Exits non-zero
without a card.
"""
from __future__ import annotations

import gc
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAX_STEP_RATIO = 3.0     # a gated run's largest step against its median


class UngatedGate:
    """The engine's timing before the step gate: nothing holds the
    stream, so the events time the enqueue's host stalls too."""

    def __init__(self, device, timeout_s=None):
        pass

    def close(self):
        pass

    def open(self):
        pass

    def check(self):
        pass


def gc_recorder() -> list:
    """A list that receives (generation, ms) for every collection of the
    interpreter from now on."""
    out, start = [], {}

    def record(phase, info):
        if phase == "start":
            start["t"] = time.perf_counter()
        elif "t" in start:
            out.append((info["generation"],
                        (time.perf_counter() - start.pop("t")) * 1e3))

    gc.callbacks.append(record)
    return out


def one_process(freeze: bool, ungated: bool) -> bool:
    """The deployment's first run and a second one; True when every gated
    run kept its steps within ``MAX_STEP_RATIO`` of its median."""
    import statistics

    import torch

    import chip_smoke as cs
    from repro_torch.train import cluster as cl
    from repro_torch.train import compute

    if ungated:
        compute.StepGate = UngatedGate

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cc = cl.ClusterConfig(n_workers=cs.CLUSTER_P)
    bundles = cl.build_cluster_traces(cs.cluster_cfg("cpu", **cs.DEPLOY),
                                      cs.CLUSTER_P)
    if freeze:
        gc.collect()
        gc.freeze()
    print(f"gc frozen: {freeze}, step timing "
          f"{'ungated (events around the enqueue)' if ungated else 'gated'}"
          f", objects tracked outside the permanent generation "
          f"{len(gc.get_objects())}, in it {gc.get_freeze_count()}")
    collections = gc_recorder()
    ok = True
    for run in range(2):
        collections.clear()
        cfg = cs.cluster_cfg(device, **dict(cs.DEPLOY, scenario="clean",
                                            method="static_w"))
        t0 = time.perf_counter()
        rep = cl.run_cluster(cfg, cc, trace_bundles=bundles)
        torch.cuda.synchronize()
        print(f"run {run}: wall {time.perf_counter() - t0:.3f} s, barrier "
              f"wait by rank {[round(float(x), 4) for x in rep.sync_wait_s]}")
        for r in range(cs.CLUSTER_P):
            res = rep.results[r]
            joules = [round(cs.rank_epoch_joules(res, e), 2)
                      for e in range(cfg.n_epochs)]
            cr = res.compute_report
            print(f"  rank {r}: J per epoch {joules}, untimed first runs "
                  f"{cr['n_compiles']} ({cr['compile_s']:.3f} s), step ms "
                  f"{[round(x * 1e3, 3) for x in cr['step_s']]}")
        steps = [x * 1e3 for r in range(cs.CLUSTER_P)
                 for x in rep.results[r].compute_report["step_s"]]
        med, top = statistics.median(steps), max(steps)
        joules = [[cs.rank_epoch_joules(rep.results[r], e)
                   for e in range(cfg.n_epochs)] for r in range(cs.CLUSTER_P)]
        in_band = all(
            min(j[1:]) * (1 - cs.EPOCH0_BAND) <= j[0]
            <= max(j[1:]) * (1 + cs.EPOCH0_BAND) for j in joules)
        print(f"  run {run} ({'ungated' if ungated else 'gated'}): "
              f"{len(steps)} measured steps, median {med:.4f} ms, largest "
              f"{top:.4f} ms ({top / med:.2f}x the median); epoch 0 within "
              f"the {cs.EPOCH0_BAND:.0%} band on every rank: {in_band}")
        if not ungated and top > MAX_STEP_RATIO * med:
            ok = False
        long = [(g, round(ms, 2)) for g, ms in collections if ms >= 1.0]
        by_gen = [sum(1 for g, _ in collections if g == k) for k in range(3)]
        print(f"  gc collections by generation {by_gen}, of 1 ms or more "
              f"{long}")
    sys.stdout.flush()
    return ok


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("deploy_epoch0: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 3
    if sys.argv[1:2] == ["--one"]:
        ok = one_process("freeze" in sys.argv[2:], "ungated" in sys.argv[2:])
        return 0 if ok else 1
    from repro_torch.kernels import _build

    _build.build_all()
    print(__import__("chip_smoke").smi_line(), flush=True)
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    alternate = "--gc-freeze" in sys.argv[1:]
    ungated = "--ungated" in sys.argv[1:]
    n = int(args[0]) if args else 5
    failed = []
    for i in range(n):
        print(f"process {i}", flush=True)
        modes = ((["freeze"] if alternate and i % 2 else [])
                 + (["ungated"] if ungated and i % 2 else []))
        proc = subprocess.run([sys.executable, __file__, "--one", *modes],
                              timeout=600)
        if proc.returncode == 1:
            failed.append(i)
        elif proc.returncode:
            return proc.returncode
    print(f"gated processes with a step over {MAX_STEP_RATIO}x its run's "
          f"median: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
