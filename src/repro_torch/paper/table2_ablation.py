"""Table II / Fig. 11: ablation under congestion at B=2000.

  w/o RL            -> static windowed cache at W=16
  w/o Cost Weights  -> RL adapts W, allocation forced uniform
  full GreenDyGNN   -> both levers

Claim: both components contribute; RL window adaptation gives the larger
share, per-owner cost weighting adds on top.
"""
from __future__ import annotations

from repro_torch.paper.common import Sweep, cli, fmt_row

VARIANTS = ["static_w", "greendygnn_nocw", "greendygnn"]


def main(sw: Sweep, batch: int = 2000) -> list[str]:
    rows, table = [], []
    for ds in sw.datasets:
        entry = {"dataset": ds}
        for v in VARIANTS:
            entry[v] = round(sw.totals(ds, batch, v, True)["total_kj"], 3)
        table.append(entry)
        full = entry["greendygnn"]
        rows.append(fmt_row(
            f"table2/{ds}/kj",
            f"w/o_RL={entry['static_w']}|w/o_CW={entry['greendygnn_nocw']}"
            f"|full={full}",
        ))
        rows.append(fmt_row(
            f"table2/{ds}/full_beats_both_ablations",
            full <= entry["static_w"] and full <= entry["greendygnn_nocw"],
            "paper: both components contribute",
        ))
    sw.save_json("table2_ablation", table)
    return rows


if __name__ == "__main__":
    cli(main)
