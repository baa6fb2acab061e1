"""The paper's evaluation congestion schedule (Section VI-A).

Port of ``repro/core/domain_rand.py::paper_schedule_delta`` only; the
domain-randomisation samplers come with the DQN-training slice.

Epochs 0-2 are a clean warmup; from epoch 3 a 7-epoch pattern repeats in
which 5 congested epochs inject 15-25 ms on one or two links (rotating
target) followed by 2 clean epochs; the final epoch is forced clean.

The reference computes this in float32 (``0.7 * 17.5`` is not the float64
product), so this port does too; its float64 numpy twin
``paper_schedule_delta_np`` gives other values and is not the source.
"""
from __future__ import annotations

import numpy as np


def paper_schedule_delta(
    epoch: int,
    n_epochs: int,
    n_owners: int = 3,
) -> np.ndarray:
    """Deterministic per-owner injected delay [ms] (float32, (n_owners,))."""
    epoch = int(epoch)
    owners = np.arange(n_owners)
    phase = max(epoch - 3, 0) % 7
    congested = (epoch >= 3) and (epoch < n_epochs - 1) and (phase < 5)
    if not congested:
        return np.zeros(n_owners, np.float32)
    # severity sweeps 15 -> 25 ms across the 5 congested phases
    sev = np.float32(15.0) + np.float32(2.5) * np.float32(phase)
    # rotate the afflicted link; every other phase hits two links
    onehot_a = (owners == phase % n_owners).astype(np.float32)
    onehot_b = (owners == (phase + 1) % n_owners).astype(np.float32) \
        * np.float32(phase % 2 == 1)
    return sev * (onehot_a + np.float32(0.7) * onehot_b)
