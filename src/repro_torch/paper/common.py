"""Shared harness of the paper's tables and figures: traces, the deployed
policy and the method sweep.

Port of ``benchmarks/common.py``. Every table and figure reads ONE
:class:`Sweep`, so the whole of ``repro_torch.paper.run`` stays in
minutes: a trace is built once per (dataset, batch) and every method
replays the identical trace under the identical congestion schedule (the
paper's "all four methods experience identical congestion").

The grid, the device and the policy are the sweep's own: the module
constants are the reference's values and the defaults. Each figure's
``main(sw, ...)`` reads the sweep it is given; ``run.py`` hands one sweep
to all of them. The results go under ``results/paper_torch/``, never
under the reference's ``results/bench/``.
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import time

from repro_torch.device import resolve
from repro_torch.train import gnn_trainer as gt
from repro_torch.train import policy as pol

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "paper_torch")
DATASETS = ["reddit", "ogbn-products", "ogbn-papers100m"]
BATCH_SIZES = [1000, 2000, 3000]
METHODS = ["dgl", "bgl", "rapidgnn", "greendygnn"]
ABLATIONS = ["static_w", "greendygnn_nocw"]

N_EPOCHS = 14
STEPS_PER_EPOCH = 32
WARMUP = 2
POLICY_BATCH = 2000     # the batch whose traces calibrate qnet_main


def base_cfg(dataset: str, batch: int, device: str = "cuda",
             n_epochs: int = N_EPOCHS, steps_per_epoch: int = STEPS_PER_EPOCH,
             **kw) -> gt.RunConfig:
    return gt.RunConfig(
        dataset=dataset, batch_size=batch, n_epochs=n_epochs,
        steps_per_epoch=steps_per_epoch, warmup_epochs=WARMUP,
        device=device, **kw,
    )


class Sweep:
    """Lazily runs and caches every (dataset, batch, method, condition).

    ``q_fn`` is the greendygnn methods' policy; without one, the first
    greendygnn run trains (or loads) ``qnet_main`` as the reference does:
    one table per dataset of :data:`DATASETS` at batch 2000, pooled, then
    ``get_or_train_policy`` on ``device`` at its defaults (40,000
    iterations of 64 envs), cached under ``policy.ARTIFACT_DIR``."""

    def __init__(self, datasets=DATASETS, batch_sizes=BATCH_SIZES,
                 n_epochs: int = N_EPOCHS,
                 steps_per_epoch: int = STEPS_PER_EPOCH, device: str = "cuda",
                 q_fn=None, results_dir: str = RESULTS_DIR):
        self.datasets = list(datasets)
        self.batch_sizes = list(batch_sizes)
        self.n_epochs = n_epochs
        self.steps_per_epoch = steps_per_epoch
        resolve(device)         # raises for the card where there is none
        self.device = device
        self.results_dir = results_dir
        self._q_fn = q_fn
        self._traces: dict = {}
        self._runs: dict = {}

    def base_cfg(self, dataset: str, batch: int, **kw) -> gt.RunConfig:
        return base_cfg(dataset, batch, device=self.device,
                        n_epochs=self.n_epochs,
                        steps_per_epoch=self.steps_per_epoch, **kw)

    @property
    def q_fn(self):
        if self._q_fn is None:
            tables = [
                pol.calibrate_table_from_bundle(
                    self.trace(ds, POLICY_BATCH),
                    self.base_cfg(ds, POLICY_BATCH))
                for ds in DATASETS
            ]
            pool = pol.make_params_pool(tables, device=self.device)
            self._q_fn, _ = pol.get_or_train_policy(
                pool, name="qnet_main", device=self.device)
        return self._q_fn

    def trace(self, dataset: str, batch: int):
        key = (dataset, batch)
        if key not in self._traces:
            self._traces[key] = gt.build_trace(self.base_cfg(dataset, batch))
        return self._traces[key]

    def run(self, dataset: str, batch: int, method: str,
            congested: bool) -> gt.RunResult:
        key = (dataset, batch, method, congested)
        if key not in self._runs:
            q_fn = self.q_fn if method.startswith("greendygnn") else None
            cfg = self.base_cfg(dataset, batch, method=method,
                                congested=congested, q_fn=q_fn)
            self._runs[key] = gt.run(cfg, self.trace(dataset, batch))
        return self._runs[key]

    def totals(self, dataset, batch, method, congested) -> dict:
        return self.run(dataset, batch, method, congested).totals()

    def save_json(self, name: str, data) -> str:
        return save_json(name, data, self.results_dir)


def save_json(name: str, data, results_dir: str = RESULTS_DIR) -> str:
    """``data`` as ``<results_dir>/<name>.json``, in the reference's
    format; returns the path."""
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(results_dir, f"{name}.json")
    with open(path, "w") as f:
        json.dump(data, f, indent=1, default=float)
    return path


# the window kernel each training env launches (the others launch none)
WINDOW_KERNEL = {"queue": "queue_window", "cluster": "cluster_window"}


@contextlib.contextmanager
def trainings_timed(report):
    """Time every ``policy.train_policy`` call made in the block on the
    card, ``get_or_train_policy``'s included, and hand ``report`` one dict
    a training: its env, owners, ``cluster_kwargs``, iterations, envs,
    epochs, episodes, wall time, iterations/s and the launches of the
    ``queue_window`` and ``cluster_window`` kernels it made."""
    import torch

    from repro_torch.kernels.cluster_window import cluster_window
    from repro_torch.kernels.queue_window import queue_window

    train = pol.train_policy
    kernels = {"queue_window": queue_window,
               "cluster_window": cluster_window}

    def timed(pool, **kw):
        bound = inspect.signature(train).bind(pool, **kw)
        bound.apply_defaults()
        a = bound.arguments
        if a["env"] == "cluster":
            owners = (a["n_workers"] or (a["n_owners"] or 3) + 1) - 1
        else:
            owners = a["n_owners"] or 3
        before = {k: w.launches for k, w in kernels.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train(pool, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        report({"env": a["env"], "owners": owners,
                "cluster_kwargs": a["cluster_kwargs"],
                "iterations": a["iterations"], "n_envs": a["n_envs"],
                "n_epochs": a["n_epochs"], "episodes": int(res["episodes"]),
                "wall_s": wall, "iterations_per_s": a["iterations"] / wall,
                **{k: w.launches - before[k] for k, w in kernels.items()}})
        return res
    pol.train_policy = timed
    try:
        yield
    finally:
        pol.train_policy = train


def fmt_row(name: str, value, derived: str = "") -> str:
    return f"{name},{value},{derived}"


def cli(main) -> None:
    """Run one figure's ``main`` on a fresh sweep (``--device``, default
    the card) and print its rows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the runs and the policy go (default: "
                         "%(default)s)")
    args = ap.parse_args()
    print("\n".join(main(Sweep(device=args.device))))
