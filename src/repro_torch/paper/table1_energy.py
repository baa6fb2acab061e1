"""Table I + Fig. 4: energy and epoch time under congestion, all methods x
datasets x batch sizes.

Claims reproduced:
  * GreenDyGNN lowest total energy in most configurations,
  * savings vs Default DGL in the tens of percent (paper: 27-43%),
  * consistently below RapidGNN (paper: 4-24%),
  * fastest epoch time.
"""
from __future__ import annotations

from repro_torch.paper.common import METHODS, Sweep, cli, fmt_row


def main(sw: Sweep) -> list[str]:
    table, rows = [], []
    for ds in sw.datasets:
        for b in sw.batch_sizes:
            entry = {"dataset": ds, "batch": b}
            for m in METHODS:
                r = sw.run(ds, b, m, congested=True)
                t = r.totals()
                entry[m] = {
                    "gpu_kj": round(t["gpu_kj"], 3),
                    "cpu_kj": round(t["cpu_kj"], 3),
                    "total_kj": round(t["total_kj"], 3),
                    "epoch_time_s": round(r.meter.mean_epoch_time(), 4),
                }
            table.append(entry)

    n_best = n_fastest = 0
    dgl_savings, rapid_savings = [], []
    for e in table:
        totals = {m: e[m]["total_kj"] for m in METHODS}
        ets = {m: e[m]["epoch_time_s"] for m in METHODS}
        if min(totals, key=totals.get) == "greendygnn":
            n_best += 1
        if min(ets, key=ets.get) == "greendygnn":
            n_fastest += 1
        dgl_savings.append(1 - totals["greendygnn"] / totals["dgl"])
        rapid_savings.append(1 - totals["greendygnn"] / totals["rapidgnn"])
        rows.append(fmt_row(
            f"table1/{e['dataset']}/B={e['batch']}/total_kj",
            "|".join(f"{m}={totals[m]:.2f}" for m in METHODS),
        ))

    # the paper's grid is 3 datasets x 3 batches: the labels keep its 9
    rows.append(fmt_row("table1/greendygnn_best_of_9", f"{n_best}/9",
                        "paper: lowest in 8 of 9"))
    rows.append(fmt_row("table1/greendygnn_fastest_of_9", f"{n_fastest}/9",
                        "paper: fastest in 9 of 9"))
    rows.append(fmt_row(
        "table1/savings_vs_dgl_pct",
        f"{100 * min(dgl_savings):.1f}..{100 * max(dgl_savings):.1f}",
        "paper: 27..43",
    ))
    rows.append(fmt_row(
        "table1/savings_vs_rapidgnn_pct",
        f"{100 * min(rapid_savings):.1f}..{100 * max(rapid_savings):.1f}",
        "paper: 4..24",
    ))
    sw.save_json("table1_energy", table)
    return rows


if __name__ == "__main__":
    cli(main)
