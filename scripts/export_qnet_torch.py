"""Train and cache a DQN policy with the PyTorch port, on the card.

The counterpart of ``scripts/export_qnet.py`` for ``repro_torch``: it
calibrates the simulator on each (dataset, batch size) trace with the
port's trainer, trains Double-DQN in the port's simulator on the device
and writes the qnet to the port's artifact directory
(``$REPRO_TORCH_ARTIFACTS`` or ``.artifacts/torch/``), where
``repro_torch.train.policy.get_or_train_policy`` finds it:

    python scripts/export_qnet_torch.py                       # qnet_example
    python scripts/export_qnet_torch.py --env analytic --iterations 20000
    python scripts/export_qnet_torch.py --device cpu --iterations 200

``--env`` selects the training environment: ``table`` (trace-calibrated
tables) or ``analytic`` (parametric archetypes); naming one exports
``<name>_<env>.npz``. Omitting it trains on table dynamics and writes the
unsuffixed ``<name>.npz``. The queue and cluster envs are not ported.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--name", default="qnet_example",
                    help="artifact name (default: %(default)s)")
    ap.add_argument("--datasets", nargs="+", default=["reddit"])
    ap.add_argument("--batch-sizes", nargs="+", type=int, default=[2000])
    ap.add_argument("--iterations", type=int, default=8_000)
    ap.add_argument("--n-epochs", type=int, default=6)
    ap.add_argument("--env", default=None, choices=["table", "analytic"],
                    help="training environment; omit for the unsuffixed "
                         "table-dynamics artifact")
    ap.add_argument("--workers", type=int, default=4,
                    help="n_parts for calibration; n_owners = P - 1")
    ap.add_argument("--device", default="cuda",
                    help="where training runs (default: %(default)s)")
    ap.add_argument("--force", action="store_true",
                    help="retrain even if the artifact already exists")
    args = ap.parse_args()

    from repro_torch.train import gnn_trainer as gt
    from repro_torch.train import policy as pol

    t0 = time.time()
    P = int(args.workers)
    thetas = []
    for ds in args.datasets:
        for bs in args.batch_sizes:
            cfg = gt.RunConfig(
                dataset=ds, batch_size=bs, n_epochs=args.n_epochs,
                steps_per_epoch=32, n_parts=P, device=args.device,
            )
            bundle = gt.build_trace(cfg)
            if args.env == "analytic":
                thetas.append(pol.calibrate_from_bundle(bundle, cfg)[0])
            else:
                thetas.append(pol.calibrate_table_from_bundle(bundle, cfg))
            print(f"{ds} B={bs} calibrated ({time.time() - t0:.0f}s)",
                  flush=True)
    pool = pol.make_params_pool(thetas, device=args.device)
    pol.get_or_train_policy(
        pool, name=args.name, iterations=args.iterations, force=args.force,
        env=args.env, device=args.device, n_owners=P - 1,
    )
    artifact = args.name if args.env is None else f"{args.name}_{args.env}"
    path = os.path.join(pol.ARTIFACT_DIR, f"{artifact}.npz")
    print(f"policy artifact ready at {os.path.abspath(path)} "
          f"({time.time() - t0:.0f}s total)", flush=True)


if __name__ == "__main__":
    main()
