"""Fig. 7: RL agent behavior — rebuild window chosen per epoch vs the
static baseline, and cache hit rates per epoch.

Claims: clean warmup settles near W=16; congestion onset drives W down
toward 4-10; adaptive hit rate >= static's during congested phases.
"""
from __future__ import annotations

import numpy as np

from repro_torch.paper.common import WARMUP, Sweep, cli, fmt_row


def main(sw: Sweep, dataset: str = "ogbn-papers100m",
         batch: int = 2000) -> list[str]:
    ours = sw.run(dataset, batch, "greendygnn", congested=True)
    static = sw.run(dataset, batch, "rapidgnn", congested=True)
    congested_epochs = np.where(ours.sigma_trace.max(axis=1) > 1.05)[0]
    clean_epochs = np.where(ours.sigma_trace.max(axis=1) <= 1.05)[0]
    clean_epochs = clean_epochs[clean_epochs >= WARMUP]

    w_clean = float(ours.window_per_epoch[clean_epochs].mean())
    w_cong = float(ours.window_per_epoch[congested_epochs].mean())
    h_ours = float(ours.hit_rate_per_epoch[congested_epochs].mean())
    h_stat = float(static.hit_rate_per_epoch[congested_epochs].mean())

    table = {
        "window_per_epoch": ours.window_per_epoch.tolist(),
        "hit_ours": ours.hit_rate_per_epoch.tolist(),
        "hit_static": static.hit_rate_per_epoch.tolist(),
        "sigma_max": ours.sigma_trace.max(axis=1).tolist(),
    }
    sw.save_json("fig7_adaptation", table)
    return [
        fmt_row("fig7/mean_W_clean", f"{w_clean:.1f}", "paper: settles ~16"),
        fmt_row("fig7/mean_W_congested", f"{w_cong:.1f}",
                "paper: drops toward 4-10"),
        fmt_row("fig7/W_shrinks_under_congestion", w_cong < w_clean),
        fmt_row("fig7/hit_ours_vs_static_congested",
                f"{h_ours:.3f}_vs_{h_stat:.3f}",
                "paper: adaptive reaches higher hit peaks"),
    ]


if __name__ == "__main__":
    cli(main)
