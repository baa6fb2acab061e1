#!/usr/bin/env python3
"""Show where ``torch.profiler`` on the card stops recording the trainer's
kernels: the CSR SpMM's and the EmbeddingBag gather's instances read from
a trace (``chip_smoke.csr_instances``, ``chip_smoke.bag_instances``) in a
fresh process, then after each million of small ``add_`` launches.

Usage (from the repository root, on a machine with a CUDA card):

    python3 scripts/profiler_drops.py [--millions 4]

Each line holds the instances the trace held (an empty list: the trace
lost the launch; ``chip_smoke.kernel_instances`` takes a trace 3 times).
It prints the card's name and power limit first and exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--millions", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profiler_drops: needs a CUDA card", file=sys.stderr)
        return 3
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.segment_mm import csr_spmm

    print(chip_smoke.smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    _build.build_all()
    ops = chip_smoke.main_path_operands(torch, dev)
    fmt0, x0 = ops["layers"][0]["fwd"], ops["x0"]
    table = torch.randn(8400, 64, device=dev)
    idx = np.random.default_rng(0).integers(0, 8400, 5047)
    bags = bag_ops.BagFormat.from_numpy(idx, np.arange(5047), 5047, None, dev)
    out = torch.empty(5047, 64, device=dev)

    def read(tag):
        bag = chip_smoke.bag_instances(
            torch, lambda: bag_ops.bag_launch(bags, table, out))
        csr = chip_smoke.csr_instances(torch, lambda: csr_spmm(fmt0, x0))
        print(f"{tag}: embedding_bag {bag}, csr_spmm {csr}", flush=True)

    read("fresh process")
    x = torch.zeros(16, device=dev)
    for m in range(args.millions):
        t0 = time.perf_counter()
        for _ in range(1_000_000):
            x.add_(1.0)
        torch.cuda.synchronize()
        read(f"after {m + 1}M add_ launches "
             f"({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
