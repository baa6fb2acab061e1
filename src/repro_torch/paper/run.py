"""The paper's harness on the port, one module per table or figure:

    python -m repro_torch.paper.run [--device cuda]

Prints ``name,value,derived`` CSV rows per module and a ``wall_s`` row a
module, over one :class:`~repro_torch.paper.common.Sweep` at the
reference's grid. It covers the reference's ``benchmarks/run.py`` list,
in its order; the last, ``roofline_report``, reads the dry-run's records
(``results/dryrun_torch/``) and runs nothing. A module that raises prints
an ``ERROR`` row, the others still run, and the command exits 1.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

from repro_torch.paper import (
    fig1_rpc_energy,
    fig5_overhead,
    fig6_clean,
    fig7_adaptation,
    fig8_sim_validation,
    fig9_cumulative,
    pipeline_overlap,
    roofline_report,
    table1_energy,
    table2_ablation,
)
from repro_torch.paper.common import Sweep

MODULES = [
    ("fig1_rpc_energy", fig1_rpc_energy),
    ("table1_energy", table1_energy),
    ("fig5_overhead", fig5_overhead),
    ("fig6_clean", fig6_clean),
    ("fig7_adaptation", fig7_adaptation),
    ("fig8_sim_validation", fig8_sim_validation),
    ("fig9_cumulative", fig9_cumulative),
    ("table2_ablation", table2_ablation),
    ("pipeline_overlap", pipeline_overlap),
    ("roofline_report", roofline_report),
]


def run_all(sw: Sweep, modules, out=sys.stdout) -> list[str]:
    """Run each module's ``main(sw)``, printing its rows and its wall
    time; returns the names of the modules that raised."""
    failed = []
    print("name,value,derived", file=out, flush=True)
    for name, mod in modules:
        t0 = time.time()
        try:
            rows = mod.main(sw)
        # what a module's runs raise (torch's errors are RuntimeErrors);
        # anything else ends the harness at once, also non-zero
        except (ArithmeticError, LookupError, OSError, RuntimeError,
                TypeError, ValueError) as e:
            traceback.print_exc()
            failed.append(name)
            rows = [f"{name}/ERROR,{type(e).__name__},{e}"]
        for row in rows:
            print(row, file=out, flush=True)
        print(f"{name}/wall_s,{time.time() - t0:.1f},", file=out, flush=True)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="where the runs and the policy go (default: "
                         "%(default)s)")
    args = ap.parse_args(argv)
    return 1 if run_all(Sweep(device=args.device), MODULES) else 0


if __name__ == "__main__":
    sys.exit(main())
