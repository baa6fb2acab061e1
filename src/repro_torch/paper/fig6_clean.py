"""Fig. 6: total energy under clean conditions.

Claim: GreenDyGNN matches the strongest static baseline within ~2% — the
adaptive controller causes no cache churn when the network is stable.
"""
from __future__ import annotations

from repro_torch.paper.common import METHODS, Sweep, cli, fmt_row


def main(sw: Sweep, batch: int = 2000) -> list[str]:
    rows, table = [], []
    for ds in sw.datasets:
        entry = {"dataset": ds}
        for m in METHODS:
            entry[m] = round(sw.totals(ds, batch, m, False)["total_kj"], 3)
        gap = 100 * (entry["greendygnn"] / entry["rapidgnn"] - 1)
        entry["gap_vs_rapidgnn_pct"] = round(gap, 2)
        table.append(entry)
        rows.append(fmt_row(
            f"fig6/{ds}/clean_total_kj",
            "|".join(f"{m}={entry[m]:.2f}" for m in METHODS),
        ))
        rows.append(fmt_row(
            f"fig6/{ds}/adaptive_gap_pct", f"{gap:.2f}",
            "paper: within 2% of RapidGNN",
        ))
    sw.save_json("fig6_clean", table)
    return rows


if __name__ == "__main__":
    cli(main)
