"""Fig. 5: congestion overhead relative to each method's own clean baseline.

Claims: Default DGL suffers ~30-50% overhead; RapidGNN absorbs part of it;
GreenDyGNN the least on every dataset.
"""
from __future__ import annotations

from repro_torch.paper.common import METHODS, Sweep, cli, fmt_row


def main(sw: Sweep, batch: int = 2000) -> list[str]:
    rows, table = [], []
    for ds in sw.datasets:
        entry = {"dataset": ds}
        for m in METHODS:
            cong = sw.totals(ds, batch, m, congested=True)["total_kj"]
            clean = sw.totals(ds, batch, m, congested=False)["total_kj"]
            entry[m] = round(100 * (cong / clean - 1), 2)
        table.append(entry)
        rows.append(fmt_row(
            f"fig5/{ds}/overhead_pct",
            "|".join(f"{m}={entry[m]:.1f}" for m in METHODS),
        ))
        best = min(METHODS, key=lambda m: entry[m])
        rows.append(fmt_row(
            f"fig5/{ds}/lowest_overhead", best,
            "paper: greendygnn lowest on every dataset",
        ))
    sw.save_json("fig5_overhead", table)
    return rows


if __name__ == "__main__":
    cli(main)
