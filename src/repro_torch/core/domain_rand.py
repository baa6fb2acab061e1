"""The paper's evaluation congestion schedule (Section VI-A).

Port of ``repro/core/domain_rand.py``'s ``paper_schedule_delta`` and of
the two numpy twins the event fabric evaluates per step,
``paper_schedule_delta_np`` and ``delta_at_np`` (the six archetypes); the
jnp domain-randomisation samplers come with the DQN-training slice.

Epochs 0-2 are a clean warmup; from epoch 3 a 7-epoch pattern repeats in
which 5 congested epochs inject 15-25 ms on one or two links (rotating
target) followed by 2 clean epochs; the final epoch is forced clean.

The reference computes ``paper_schedule_delta`` in float32 (``0.7 *
17.5`` is not the float64 product), so this port does too; the closed-form
trainer reads it. Its float64 twin ``paper_schedule_delta_np`` gives other
values; the fabric's ``PaperScheduleDelta`` reads that one, as the
reference's does.
"""
from __future__ import annotations

import numpy as np

N_ARCHETYPES = 6


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


def delta_at_np(
    archetype: int,
    severity_ms: float,
    onset: float,
    duration: float,
    period: float,
    link_a: int,
    link_b: int,
    phase: float,
    step: float,
    n_owners: int = 3,
) -> np.ndarray:
    """Per-owner injected delay [ms] of one archetype at ``step`` (float64):
    0 none, 1 single constant, 2 single fast-switching, 3 two-link
    symmetric, 4 two-link asymmetric, 5 oscillating."""
    step = float(step)
    owners = np.arange(n_owners)
    active = (step >= onset) and (step < onset + duration)
    sev = float(severity_ms) if active else 0.0

    onehot_a = (owners == int(link_a)).astype(np.float64)
    onehot_b = (owners == int(link_b)).astype(np.float64)
    p = max(float(period), 1.0)
    flip = np.floor((step - onset) / p) % 2
    switching = onehot_a if flip == 0 else onehot_b
    osc = 0.5 * (1.0 + np.sin(2.0 * np.pi * (step - onset) / p + phase))

    branches = [
        np.zeros(n_owners),
        sev * onehot_a,
        sev * switching,
        sev * (onehot_a + onehot_b),
        sev * (onehot_a + 0.5 * onehot_b),
        sev * osc * onehot_a,
    ]
    return branches[int(archetype) % N_ARCHETYPES]


def paper_schedule_delta_np(epoch: int, n_epochs: int,
                            n_owners: int = 3) -> np.ndarray:
    """The paper schedule in float64 (the fabric's per-step twin)."""
    epoch = int(epoch)
    owners = np.arange(n_owners)
    phase = max(epoch - 3, 0) % 7
    in_window = (epoch >= 3) and (epoch < n_epochs - 1)
    congested = in_window and (phase < 5)
    if not congested:
        return np.zeros(n_owners)
    sev = 15.0 + 2.5 * phase
    link_a = phase % n_owners
    link_b = (phase + 1) % n_owners
    two_links = (phase % 2) == 1
    onehot_a = (owners == link_a).astype(np.float64)
    onehot_b = (owners == link_b).astype(np.float64) * float(two_links)
    return sev * (onehot_a + 0.7 * onehot_b)
