#!/usr/bin/env python3
"""Run GNN cells of ``launch/cell.py`` at full config on one CUDA card,
each with ``chip_smoke.py``'s checks, including those ``chip_smoke.py``
leaves out for its time.

Usage (from the repository root, on a machine with an H100):

    python3 scripts/gnn_cells.py [ARCH:SHAPE ...]

With no arguments it runs every ``chip_smoke.GNN_IF_FITS`` cross whose
``gnn_peak_estimate`` fits ``MEM_FRAC`` of the card, whatever its CPU
check takes (``chip_smoke.py`` runs only those under
``CPU_CHECK_MAX_S``, and leaves NequIP and MACE at ``minibatch_lg`` to
this script; about 200 s on an H100, 138 s of it MACE's CPU check), and
``greendygnn-sage`` cells named as ``greendygnn-sage:SHAPE`` (whose
estimate is the peak ``launch.count`` counts on ``meta``;
``chip_smoke.py`` runs those whose CPU check fits its budget). Each cell is
``chip_smoke.run_gnn_cell``: the first loss and gradients on the card
against the same step on the CPU, 5 AdamW steps that must lower the loss,
the peak memory against the estimate, one step under the counter held
against the same step counted on ``meta`` (``chip_smoke.hold_count``),
one profiled step. A cell whose estimate does not fit is
refused. The card's name and power limit come
first; the last line is one JSON object of each cell's estimate, CPU
check seconds and wall seconds. Exits non-zero without a card or when a
check fails.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("gnn_cells: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 3
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = cs.smi_line()
    print(smi, flush=True)
    cells = ([tuple(a.split(":")) for a in sys.argv[1:]]
             or list(cs.GNN_IF_FITS))
    budget = cs.MEM_FRAC * torch.cuda.get_device_properties(
        device).total_memory
    out = {}
    for arch_id, shape in cells:
        (est, _), meta = cs.gnn_estimate(arch_id, shape)
        name = f"{arch_id}:{shape}"
        if est > budget:
            cs.log(f"gnn {arch_id} {shape}: {meta}, peak estimated at "
                   f"{est / 2**30:.2f} GiB against {cs.MEM_FRAC} of the "
                   f"card: not run")
            out[name] = {"estimate_gib": est / 2**30, "run": False}
            continue
        t0 = time.perf_counter()
        t_cpu = cs.run_gnn_cell(torch, device, smi, arch_id, shape)
        out[name] = {"estimate_gib": est / 2**30, "run": True,
                     "cpu_check_s": t_cpu,
                     "wall_s": time.perf_counter() - t0}
    print(json.dumps({"card": smi, "cells": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
