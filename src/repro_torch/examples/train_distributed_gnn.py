"""End-to-end example: distributed GraphSAGE training under the GreenDyGNN
pipeline: real sampled mini-batches, real train steps, the adaptive
cache, energy accounting and a restartable checkpoint:

    python -m repro_torch.examples.train_distributed_gnn [--epochs 8] \\
        [--async-pipeline] [--device cuda]

Port of ``examples/train_distributed_gnn.py``. The policy is the
table-calibrated ``qnet_example`` (8,000 iterations), trained on the
run's device the first time and cached under ``policy.ARTIFACT_DIR``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.train import checkpoint as ckpt
from repro_torch.device import resolve
from repro_torch.train import gnn_trainer as gt
from repro_torch.train import policy as pol

POLICY_ITERATIONS = 8_000
DEFAULT_CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                                "build", "greendygnn_ckpt")


def make_config(epochs: int = 8, dataset: str = "reddit", steps: int = 24,
                async_pipeline: bool = False,
                device: str = "cuda") -> gt.RunConfig:
    return gt.RunConfig(
        method="greendygnn", dataset=dataset, batch_size=2000,
        n_epochs=epochs, steps_per_epoch=steps,
        run_model=True, pad_blocks=True, congested=True,
        async_pipeline=async_pipeline, device=device,
    )


def train(cfg: gt.RunConfig, bundle=None) -> gt.RunResult:
    """Calibrate the table simulator on the run's trace, load or train
    ``qnet_example``, and train GraphSAGE under the adaptive cache."""
    if bundle is None:
        print("building trace (partition + presample)...")
        bundle = gt.build_trace(cfg)
    print("calibrating simulator + loading/training the RL policy...")
    tp = pol.calibrate_table_from_bundle(bundle, cfg)
    cfg.q_fn, _ = pol.get_or_train_policy(
        pol.make_params_pool([tp], device=cfg.device), name="qnet_example",
        iterations=POLICY_ITERATIONS, device=cfg.device,
    )
    print("training GraphSAGE under the adaptive cache pipeline...")
    return gt.run(cfg, bundle)


def checkpoint_tree(result: gt.RunResult) -> dict:
    """The final per-epoch hit rates and windows, as float32 tensors (the
    reference's ``jnp.asarray`` of the float64 logs)."""
    return {
        "hit_rate": torch.as_tensor(result.hit_rate_per_epoch,
                                    dtype=torch.float32),
        "windows": torch.as_tensor(result.window_per_epoch,
                                   dtype=torch.float32),
    }


def report(result: gt.RunResult) -> None:
    t = result.totals()
    print(f"\ntotal energy: {t['total_kj']:.2f} kJ "
          f"(gpu {t['gpu_kj']:.2f} / cpu {t['cpu_kj']:.2f})")
    print(f"mean epoch time: {result.meter.mean_epoch_time():.3f} s")
    print("per-epoch hit rate:", np.round(result.hit_rate_per_epoch, 3))
    print("per-epoch mean window:", np.round(result.window_per_epoch, 1))
    if result.accuracy_per_epoch is not None:
        print("per-epoch eval accuracy:",
              np.round(result.accuracy_per_epoch, 3))
    if result.pipeline is not None:
        rep = result.pipeline
        print(f"pipeline: {rep.n_rebuilds} rebuilds, "
              f"overlap efficiency {rep.overlap_efficiency:.1%}, "
              f"mean swap {rep.swap_latency_s * 1e6:.0f} us, "
              f"prefetch lead {rep.prefetch_mean_lead_s * 1e3:.2f} ms")


def main(argv=None) -> gt.RunResult:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--dataset", default="reddit")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument(
        "--async-pipeline", action="store_true",
        help="run the real threaded cache-builder + prefetch pipeline "
             "(measured rebuild overlap) instead of the analytic model",
    )
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve(args.device)        # raises for the card where there is none

    cfg = make_config(args.epochs, args.dataset, args.steps,
                      args.async_pipeline, args.device)
    result = train(cfg)
    report(result)
    # checkpoint the final meter state + energy trace (restartable)
    ckpt.save_checkpoint(args.ckpt_dir, args.epochs, checkpoint_tree(result))
    print(f"checkpointed to {args.ckpt_dir} "
          f"(latest step {ckpt.latest_step(args.ckpt_dir)})")
    return result


if __name__ == "__main__":
    main()
