"""Pipeline overlap: is adaptation *measurably* free?

Runs the REAL threaded pipeline (``repro_torch.pipeline``) on the
synthetic Reddit analogue at the paper's default W=16 against the
synchronous run on the same trace, and reports:

  * overlap efficiency — fraction of builder (plan + bulk fetch) wall time
    hidden behind consumer step compute (paper claim: rebuilds overlap so
    well that adaptation is "effectively free"; we require >= 50% hidden),
  * swap latency — the atomic generation-tagged buffer promotion,
  * prefetch lead/wait — how far ahead the Stage-3 depth-Q queue runs,
  * parity — threaded vs synchronous hit/miss stream + per-owner rows
    (``pipeline.parity.compare_runs``); the wall times are the host's and
    vary from run to run, the parity does not.
"""
from __future__ import annotations

import dataclasses

from repro_torch.paper.common import Sweep, cli, fmt_row
from repro_torch.pipeline.parity import compare_runs
from repro_torch.train import gnn_trainer as gt


def main(
    sw: Sweep,
    dataset: str = "reddit",
    batch: int = 2000,
    window: int = 16,
    n_epochs: int = 6,
    steps_per_epoch: int = 32,
) -> list[str]:
    cfg = gt.RunConfig(
        method="static_w", dataset=dataset, batch_size=batch,
        n_epochs=n_epochs, steps_per_epoch=steps_per_epoch,
        static_window=window, device=sw.device,
    )
    bundle = gt.build_trace(cfg)
    res_sync = gt.run(cfg, bundle)
    res = gt.run(dataclasses.replace(cfg, async_pipeline=True), bundle)
    parity = compare_runs(res_sync, res)
    rep = res.pipeline
    s = rep.summary()
    consumer_s = float(res.meter.wall_s)

    rows = [
        fmt_row(f"pipeline/{dataset}/W", window),
        fmt_row(f"pipeline/{dataset}/n_rebuilds", rep.n_rebuilds),
        fmt_row(
            f"pipeline/{dataset}/builder_wall_ms",
            round(1e3 * rep.builder_wall_s, 3),
        ),
        fmt_row(
            f"pipeline/{dataset}/exposed_wait_ms",
            round(1e3 * rep.exposed_wait_s, 3),
        ),
        fmt_row(
            f"pipeline/{dataset}/overlap_efficiency",
            round(rep.overlap_efficiency, 4),
            "paper: rebuild hidden behind compute; target >= 0.5",
        ),
        fmt_row(
            f"pipeline/{dataset}/swap_latency_us",
            round(1e6 * rep.swap_latency_s, 1),
            "atomic generation-tagged promotion",
        ),
        fmt_row(
            f"pipeline/{dataset}/prefetch_mean_lead_ms",
            round(1e3 * rep.prefetch_mean_lead_s, 3),
            f"Stage-3 queue depth Q={cfg.prefetch_depth}",
        ),
        fmt_row(
            f"pipeline/{dataset}/prefetch_wait_ms",
            round(1e3 * rep.prefetch_wait_s, 3),
        ),
        fmt_row(
            f"pipeline/{dataset}/parity",
            "OK" if parity.ok else "MISMATCH",
            f"{parity.n_steps} steps, {parity.mismatched_steps} mismatched",
        ),
    ]
    sw.save_json(
        "pipeline_overlap",
        {
            **s,
            "dataset": dataset,
            "window": window,
            "consumer_wall_modeled_s": consumer_s,
            "parity_ok": parity.ok,
            "parity_steps": parity.n_steps,
        },
    )
    return rows


if __name__ == "__main__":
    cli(main)
