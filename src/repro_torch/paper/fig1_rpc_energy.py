"""Fig. 1: per-RPC energy decomposed into initiation vs payload cost.

Claim reproduced: at GNN-typical request sizes (tens to hundreds of nodes)
initiation accounts for 90-99% of per-RPC energy; the crossover where
payload dominates is above ~1000 nodes.
"""
from __future__ import annotations

from repro_torch.core import cost_model as cm
from repro_torch.paper.common import Sweep, cli, fmt_row


def main(sw: Sweep) -> list[str]:
    params = cm.CostModelParams()
    sizes = [10, 50, 100, 500, 1_000, 5_000, 10_000, 50_000]
    rows, table = [], []
    for n in sizes:
        e_init, e_pay = cm.rpc_energy_breakdown(params, float(n))
        share = float(e_init / (e_init + e_pay))
        table.append({"batch_nodes": n, "initiation_share": share,
                      "e_init_mj": float(e_init) * 1e3,
                      "e_payload_mj": float(e_pay) * 1e3})
        rows.append(fmt_row(f"fig1/initiation_share@N={n}", f"{share:.4f}"))

    shares = {t["batch_nodes"]: t["initiation_share"] for t in table}
    claim_small = all(shares[n] > 0.89 for n in (10, 50, 100))
    crossover = next(n for n in sizes if shares[n] < 0.5)
    rows.append(fmt_row("fig1/claim_90_99pct_at_gnn_sizes", claim_small,
                        "paper: 90-99% at tens-hundreds of nodes"))
    rows.append(fmt_row("fig1/payload_crossover_nodes", crossover,
                        "paper: crossover above ~1000 nodes"))
    sw.save_json("fig1_rpc_energy", table)
    return rows


if __name__ == "__main__":
    cli(main)
