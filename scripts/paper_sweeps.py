"""The reference's sweeps at full size on the card, in one process.

Runs the port's ``repro_torch.paper`` sweep modules at the reference's
defaults, in this order, each as its command line would:

    cluster_sweep --check                          P = 2, 4, 8
    cluster_sweep --workers 4 --mixture
    cluster_sweep --workers 4 --mem-budget tight,loose --check
    scenario_sweep --check-clean-parity
    scenario_sweep --workers 4 --check-clean-parity
    policy_gauntlet --check

The policies train once, into ``OUT/artifacts`` (the later commands find
the earlier ones' checkpoints there under the reference's names), and
each training is logged with its env, owners, iterations, envs, wall
time, iterations/s and window-kernel launches
(``repro_torch.paper.common.trainings_timed``). A ``--check`` gate that fails is recorded with its
message and the next command still runs; the memory axis's gate is read
from its JSON even where the cluster-twin gate before it failed. Each
command's JSON goes to ``OUT/<label>/``; ``OUT/summary.json``, rewritten
after each command, holds the wall times, the gates' outcomes, the
trainings and the card (``nvidia-smi``'s name and power limit).

    python3 scripts/paper_sweeps.py [--out build/paper_sweeps]
        [--only cluster_sweep scenario_sweep_p4 ...]
"""
import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# (label, module, flags)
RUNS = [
    ("cluster_sweep", "cluster_sweep", ["--check"]),
    ("cluster_sweep_mixture", "cluster_sweep", ["--workers", "4",
                                                "--mixture"]),
    ("cluster_sweep_mem", "cluster_sweep", ["--workers", "4", "--mem-budget",
                                            "tight,loose", "--check"]),
    ("scenario_sweep", "scenario_sweep", ["--check-clean-parity"]),
    ("scenario_sweep_p4", "scenario_sweep", ["--workers", "4",
                                             "--check-clean-parity"]),
    ("policy_gauntlet", "policy_gauntlet", ["--check"]),
]


def smi_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except OSError:
        return "no nvidia-smi"


class Tee(io.TextIOBase):
    """Writes to every stream it holds."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
            st.flush()
        return len(s)


def mem_gate(mod) -> str:
    """``check_mem_acceptance`` at P = 4 over the JSON ``mod`` (the
    cluster sweep) wrote."""
    with open(os.path.join(mod.RESULTS_DIR, "cluster_sweep.json")) as f:
        result = json.load(f)
    result["mem"] = {int(k): v for k, v in result.get("mem", {}).items()}
    try:
        mod.check_mem_acceptance(result, 4)
        return "held"
    except AssertionError as e:
        return f"gate failed: {e}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="build/paper_sweeps")
    ap.add_argument("--only", nargs="+", default=None,
                    help="labels of RUNS to run (default: all)")
    args = ap.parse_args()

    import importlib

    from repro_torch.paper.common import trainings_timed
    from repro_torch.train import policy as pol

    os.makedirs(args.out, exist_ok=True)
    pol.ARTIFACT_DIR = os.path.join(args.out, "artifacts")
    card = smi_line()
    summary = {"card": card, "runs": {}, "trainings": []}
    log = open(os.path.join(args.out, "log.txt"), "a")
    failed = 0

    def training(rec):
        summary["trainings"].append(rec)
        print(f"[paper_sweeps] training {json.dumps(rec)}", flush=True)

    with contextlib.redirect_stdout(Tee(sys.stdout, log)):
        print(f"[paper_sweeps] {card}", flush=True)
        for label, name, flags in RUNS:
            if args.only and label not in args.only:
                continue
            mod = importlib.import_module(f"repro_torch.paper.{name}")
            mod.RESULTS_DIR = os.path.join(args.out, label)
            print(f"\n[paper_sweeps] === {label}: {name} {' '.join(flags)}",
                  flush=True)
            n_before = len(summary["trainings"])
            t0 = time.perf_counter()
            with trainings_timed(training):
                try:
                    mod.main(list(flags))
                    outcome = "held" if any(
                        f.startswith("--check") for f in flags) else "ran"
                except (AssertionError, SystemExit) as e:
                    outcome = f"gate failed: {e}"
                # greenlint: broad-except — a command that raises is
                # recorded and the next one runs; the script exits 1
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    outcome = f"error: {type(e).__name__}: {e}"
                    failed += 1
            wall = time.perf_counter() - t0
            summary["runs"][label] = {
                "argv": flags, "wall_s": wall, "outcome": outcome,
                "trainings": len(summary["trainings"]) - n_before}
            if "--mem-budget" in flags and "--check" in flags:
                # the command checks the memory axis only after the
                # cluster-twin gates held: read it here in any case
                summary["runs"][label]["mem_gate"] = mem_gate(mod)
            print(f"[paper_sweeps] {label}: {wall:.1f} s, {outcome}; {card}",
                  flush=True)
            with open(os.path.join(args.out, "summary.json"), "w") as f:
                json.dump(summary, f, indent=1)
        print("[paper_sweeps] summary " + json.dumps(summary), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
