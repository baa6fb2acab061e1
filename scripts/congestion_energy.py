#!/usr/bin/env python3
"""Joules per epoch of ``chip_smoke.py``'s congestion runs, on any device,
optionally with every measured step charged at a fixed time.

Usage (from the repository root):

    python3 scripts/congestion_energy.py [--device cpu|cuda] [--step-ms MS]

The runs are ``chip_smoke.py``'s: the reddit stand-in at the main path's
widths and batch, measured lane, device payloads, 5 epochs of 4 steps (1
of warmup, W = 2), methods dgl, static_w, heuristic and greendygnn (the
seeded untrained qnet), under ``paper_schedule`` and ``bursty_markov``.
With ``--step-ms`` each measured step still runs, but the meter is charged
``MS`` for it: on the CPU that gives what the card's runs should read if
its steps took ``MS`` (the meter charges 400 W a node for compute time,
and the time-driven scenarios read the clock the charges advance).
"""
from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--step-ms", type=float, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.core import controller as ctl, dqn
    from repro_torch.store import MemoryBudget
    from repro_torch.train import compute, gnn_trainer as gt

    if args.step_ms is not None:
        step = compute.ComputeEngine.step
        fixed_s = args.step_ms / 1e3

        def fixed(self, mb, x_in, key=None):
            step(self, mb, x_in, key)
            self.step_s[-1] = fixed_s
            return fixed_s

        compute.ComputeEngine.step = fixed
    qnet = dqn.init_qnet(torch.Generator().manual_seed(chip_smoke.SEED),
                         ctl.state_dim(3), ctl.n_actions(3),
                         device=args.device)
    base = dict(chip_smoke.CONGESTION)
    bundle = gt.build_trace(gt.RunConfig(**base, device=args.device))
    print(f"device {args.device}, step "
          f"{'measured' if args.step_ms is None else f'{args.step_ms} ms'}")
    print("scenario,method,joules per epoch,mean of epochs 1+,windows")
    for scenario in ("paper_schedule", "bursty_markov"):
        for method in ("dgl", "static_w", "heuristic", "greendygnn"):
            cfg = gt.RunConfig(
                **dict(base, method=method, scenario=scenario),
                q_fn=dqn.q_fn_of(qnet) if method == "greendygnn" else None,
                mem_budget=MemoryBudget(device_payloads=True),
                device=args.device)
            res = gt.run(cfg, bundle)
            joules = [chip_smoke.epoch_joules(res, e)
                      for e in range(cfg.n_epochs)]
            print(f"{scenario},{method},"
                  f"{' '.join(f'{j:.2f}' for j in joules)},"
                  f"{np.mean(joules[cfg.warmup_epochs:]):.2f},"
                  f"{' '.join(f'{w:g}' for w in res.window_per_epoch)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
