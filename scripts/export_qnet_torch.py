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

The paper harness's policy (``repro_torch.paper.common.Sweep``'s
``qnet_main``: one table per dataset at batch 2000, 40,000 iterations):

    python scripts/export_qnet_torch.py --name qnet_main --iterations 40000 \
        --datasets reddit ogbn-products ogbn-papers100m

``--env`` selects the training environment: ``table`` (trace-calibrated
tables), ``analytic`` (parametric archetypes), ``queue`` (the
scenario-conditioned fluid fabric twin) or ``cluster`` (the P-requester
cluster twin with emergent congestion), the last two on the analytic
calibration; naming one exports ``<name>_<env>.npz``. Omitting it trains
on table dynamics and writes the unsuffixed ``<name>.npz``. ``--workers
P`` sizes the cluster: calibration runs at ``n_parts = P``, the policy's
spaces at ``n_owners = P - 1``, and the cluster env writes a checkpoint
per P (``<name>_cluster_p<P>.npz``), the policy ``run_cluster`` deploys
at P ranks:

    python scripts/export_qnet_torch.py --env queue --iterations 20000
    python scripts/export_qnet_torch.py --env cluster --workers 4
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
    ap.add_argument("--env", default=None,
                    choices=["table", "analytic", "queue", "cluster"],
                    help="training environment; omit for the unsuffixed "
                         "table-dynamics artifact")
    ap.add_argument("--workers", type=int, default=4,
                    help="cluster size P: n_parts for calibration, n_owners "
                         "= P - 1 for the policy's spaces, and the cluster "
                         "env's per-P checkpoint suffix")
    ap.add_argument("--device", default="cuda",
                    help="where training runs (default: %(default)s)")
    ap.add_argument("--force", action="store_true",
                    help="retrain even if the artifact already exists")
    args = ap.parse_args()

    import torch

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
            # the queue and cluster envs run the analytic calibration
            # (CostModelParams)
            if args.env in ("analytic", "queue", "cluster"):
                thetas.append(pol.calibrate_from_bundle(bundle, cfg)[0])
            else:
                thetas.append(pol.calibrate_table_from_bundle(bundle, cfg))
            print(f"{ds} B={bs} calibrated ({time.time() - t0:.0f}s)",
                  flush=True)
    pool = pol.make_params_pool(thetas, device=args.device)
    kw = {"n_owners": P - 1}
    if args.env == "cluster":
        kw["n_workers"] = P
    t_train = time.time()
    _, qnet = pol.get_or_train_policy(
        pool, name=args.name, iterations=args.iterations, force=args.force,
        env=args.env, device=args.device, **kw,
    )
    if qnet["l1"]["w"].is_cuda:
        torch.cuda.synchronize()
    train_s = time.time() - t_train
    print(f"policy trained or loaded in {train_s:.1f}s "
          f"({args.iterations / train_s:.1f} iterations/s if trained)",
          flush=True)
    artifact = args.name if args.env is None else f"{args.name}_{args.env}"
    if args.env == "cluster":
        artifact = f"{artifact}_p{P}"
    path = os.path.join(pol.ARTIFACT_DIR, f"{artifact}.npz")
    print(f"policy artifact ready at {os.path.abspath(path)} "
          f"({time.time() - t0:.0f}s total)", flush=True)


if __name__ == "__main__":
    main()
