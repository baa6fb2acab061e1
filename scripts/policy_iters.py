"""Held-out return of a policy trained for a given number of iterations.

    python scripts/policy_iters.py ITERS[,ITERS...] ENV[,ENV...] [--device D]

Builds ``chip_smoke.py``'s policy pools (calibrated on the main path's
bundle: the tables for ``table``, the analytic fit for the other envs),
trains Double-DQN as the script's policy phases do (``POLICY_ENVS`` envs,
seed ``SEED``; ``cluster`` at ``CLUSTER_P`` workers) for each iteration
count, and prints the mean discounted return of ``chip_smoke.held_out``'s
episodes for the trained qnet beside the fresh qnet's (seed 99), the
number the script's checks compare. ENV is ``table``, ``analytic``,
``queue`` or ``cluster``; the device defaults to the CPU.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("iters")
    ap.add_argument("envs")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.core import dqn
    from repro_torch.train import gnn_trainer as gt, policy as pol

    dev = torch.device(args.device)
    cal_cfg = gt.RunConfig(**dict(cs.MAIN_PATH, compute="modeled"),
                           device=str(dev))
    bundle = gt.build_trace(cal_cfg)
    tables = pol.calibrate_table_from_bundle(bundle, cal_cfg)
    theta, _ = pol.calibrate_from_bundle(bundle, cal_cfg)
    analytic = pol.make_params_pool([theta], device=dev)
    pools = {"table": pol.make_params_pool([tables], device=dev),
             "analytic": analytic, "queue": analytic, "cluster": analytic}
    fresh = dqn.greedy_policy(dqn.init_qnet(
        torch.Generator().manual_seed(99), 23, 32, device=dev))
    with tempfile.TemporaryDirectory() as tmp:
        pol.ARTIFACT_DIR = tmp
        for env in args.envs.split(","):
            base = float(cs.held_out(torch, dev, env, pools[env], fresh)[1]
                         .mean())
            extra = {"n_workers": cs.CLUSTER_P} if env == "cluster" else {}
            for it in (int(x) for x in args.iters.split(",")):
                t0 = time.perf_counter()
                _, q = pol.get_or_train_policy(
                    pools[env], name=f"iters{it}", iterations=it,
                    force=True, env=env, device=str(dev),
                    n_envs=cs.POLICY_ENVS, seed=cs.SEED, **extra)
                ret = float(cs.held_out(torch, dev, env, pools[env],
                                        dqn.greedy_policy(q))[1].mean())
                print(f"{env} {it} iterations: held-out return trained "
                      f"{ret:.4f}, fresh {base:.4f} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
