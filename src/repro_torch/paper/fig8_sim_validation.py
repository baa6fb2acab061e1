"""Fig. 8: calibrated-simulator validation across a (W, delta) grid.

The tabular simulator's predicted step time is compared against the
trace-driven trainer ("the cluster") at every (rebuild window, injected
delay) grid point. Paper reports mean 2.8% error, <5% across the range.
The prediction runs on the sweep's device, as one env of the table
simulator.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import table_sim as ts
from repro_torch.core.cost_model import WINDOW_CHOICES
from repro_torch.paper.common import Sweep, cli, fmt_row
from repro_torch.train import gnn_trainer as gt
from repro_torch.train import policy as pol

GRID_W = [1, 2, 4, 8, 16, 32, 64]
GRID_DELTA = [0.0, 5.0, 10.0, 15.0, 20.0, 25.0]
VALIDATION_EPOCHS = 4


def main(sw: Sweep, dataset: str = "reddit", batch: int = 2000) -> list[str]:
    bundle = sw.trace(dataset, batch)
    cfg = sw.base_cfg(dataset, batch)
    tp = pol.make_params_pool([pol.calibrate_table_from_bundle(bundle, cfg)],
                              device=sw.device)
    n_owners = cfg.n_parts - 1

    errors, table = [], []
    for w in GRID_W:
        wi = WINDOW_CHOICES.index(w)
        for d in GRID_DELTA:
            # fixed_delta_ms congests EVERY owner link; the prediction must
            # model the same condition
            delta = torch.full((1, n_owners), d, dtype=torch.float32,
                               device=tp.t_base.device)
            t_pred, _, _ = ts.step_time_energy(tp, wi, 0, delta)
            t_pred = float(t_pred[0])
            r = gt.run(
                dataclasses.replace(
                    cfg, method="static_w", static_window=w,
                    congested=d > 0, fixed_delta_ms=d or None,
                    n_epochs=VALIDATION_EPOCHS,
                ),
                bundle,
            )
            t_meas = r.meter.wall_s / max(r.meter.n_steps, 1)
            err = abs(t_pred - t_meas) / t_meas
            errors.append(err)
            table.append({"W": w, "delta_ms": d,
                          "pred_ms": t_pred * 1e3,
                          "meas_ms": t_meas * 1e3,
                          "err_pct": 100 * err})

    mean_err = 100 * float(np.mean(errors))
    max_err = 100 * float(np.max(errors))
    sw.save_json("fig8_sim_validation", table)
    return [
        fmt_row("fig8/mean_error_pct", f"{mean_err:.2f}", "paper: 2.8"),
        fmt_row("fig8/max_error_pct", f"{max_err:.2f}",
                "paper: below 5 across the range"),
        fmt_row("fig8/grid_points", len(table)),
    ]


if __name__ == "__main__":
    cli(main)
