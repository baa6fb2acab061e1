"""Fig. 9: cumulative energy over epochs under congestion.

Claim: GreenDyGNN accumulates less energy than all baselines, gap widening
during congested epochs.
"""
from __future__ import annotations

import numpy as np

from repro_torch.paper.common import METHODS, Sweep, cli, fmt_row


def main(sw: Sweep, batch: int = 2000) -> list[str]:
    rows, table = [], []
    for ds in sw.datasets:
        curves = {
            m: sw.run(ds, batch, m, True).meter.cumulative_kj().tolist()
            for m in METHODS
        }
        table.append({"dataset": ds, **curves})
        final = {m: curves[m][-1] for m in METHODS}
        gap_vs_rapid = final["rapidgnn"] - final["greendygnn"]
        rows.append(fmt_row(
            f"fig9/{ds}/final_cumulative_kj",
            "|".join(f"{m}={final[m]:.2f}" for m in METHODS),
        ))
        rows.append(fmt_row(
            f"fig9/{ds}/saved_vs_rapidgnn_kj", f"{gap_vs_rapid:.2f}",
            "paper: gap widens during congested epochs",
        ))
        # monotone widening check: gap at end >= gap at 1/3 of the run
        g = np.asarray(curves["rapidgnn"]) - np.asarray(curves["greendygnn"])
        rows.append(fmt_row(
            f"fig9/{ds}/gap_widens", bool(g[-1] >= g[len(g) // 3]),
        ))
    sw.save_json("fig9_cumulative", table)
    return rows


if __name__ == "__main__":
    cli(main)
