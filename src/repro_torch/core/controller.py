"""Runtime adaptive controller (paper Algorithm 2) + shared MDP plumbing.

Port of ``repro/core/controller.py``: the action codec (32 discrete actions
-> (W, per-owner weights)), the state constructor (R^23 for P=4), the
congestion estimator (Eq. 8) and the live controller.

The reference evaluates the codec, the state and the Eq. 8 inversion in
float32, with Python constants cast to float32 before each operation. This
port does the same in numpy, operation by operation, so observation
vectors and allocation weights are bit-identical; the float32 weights feed
``plan_window``'s largest-remainder quotas, where one ulp can move a row.
The training simulators run the tensor forms (``*_t``) of the codec and
the state, batched over a leading env axis.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import cost_model as cm
from repro_torch.device import constant

N_WINDOWS = len(cm.WINDOW_CHOICES)  # 8
BIAS_FRACTION = 0.6                 # "biased 60% toward one designated owner"
CLEAN_RATIO_THRESHOLD = 1.1         # Eq. 8 clamp-to-zero condition
LAMBDA_THRASH = 0.02                # reward allocation-instability penalty

_F32 = np.float32


def n_actions(n_owners: int) -> int:
    """N_W x N_A where N_A = 1 uniform + n_owners biased templates (= P)."""
    return N_WINDOWS * (n_owners + 1)


def state_dim(n_owners: int, headroom: bool = False) -> int:
    """sigma (P-1) + hit rates (P) + load ratios (5) + onehot W (8) + prev
    allocation weights (P-1), plus the optional trailing headroom entry."""
    return (n_owners) + (n_owners + 1) + 5 + N_WINDOWS + n_owners + (
        1 if headroom else 0
    )


def allocation_weights(alloc_idx: int, n_owners: int) -> np.ndarray:
    """Template 0 = uniform; template k>=1 = 60% on owner k-1, rest split
    (float32). At n_owners=1 every template is the degenerate [1.0]."""
    uniform = np.full((n_owners,), 1.0 / n_owners, _F32)
    if n_owners <= 1 or int(alloc_idx) == 0:
        return uniform
    owner = min(max(int(alloc_idx) - 1, 0), n_owners - 1)
    onehot = np.zeros(n_owners, _F32)
    onehot[owner] = 1.0
    rest = _F32((1.0 - BIAS_FRACTION) / (n_owners - 1))
    return onehot * _F32(BIAS_FRACTION) + (_F32(1.0) - onehot) * rest


def decode_action(action: int, n_owners: int) -> tuple[np.float32, np.ndarray]:
    """action in [0, 32) -> (window size float32, weights (n_owners,))."""
    n_a = n_owners + 1
    w_idx, alloc_idx = divmod(int(action), n_a)
    window = np.asarray(cm.WINDOW_CHOICES, _F32)[w_idx]
    return window, allocation_weights(alloc_idx, n_owners)


def encode_action(w_idx: int, alloc_idx: int, n_owners: int) -> int:
    return int(w_idx) * (n_owners + 1) + int(alloc_idx)


def window_index(window) -> int:
    """Index of a window value inside WINDOW_CHOICES (exact match; 0 when
    absent, as the reference's argmax of an all-false mask)."""
    choices = np.asarray(cm.WINDOW_CHOICES, _F32)
    return int(np.argmax(choices == _F32(window)))


def build_state(
    sigma_hat,            # (P-1,) per-owner congestion multipliers
    owner_hit_rates,      # (P-1,)
    global_hit_rate,      # ()
    t_step,
    t_base,
    f_rebuild,            # rebuild fraction of step time
    f_miss,               # network-miss fraction of step time
    e_step,
    e_baseline,
    batches_remaining,    # normalized [0, 1]
    prev_window,
    prev_weights,         # (P-1,)
    headroom=None,        # () normalized host-tier headroom
) -> np.ndarray:
    """Assemble the R^23 observation (paper Section IV-C.1a), float32.

    ``headroom`` appends exactly one trailing entry when given."""
    onehot_w = np.zeros(N_WINDOWS, _F32)
    onehot_w[window_index(prev_window)] = 1.0
    ratios = np.asarray(
        [
            _F32(t_step) / _F32(t_base),
            _F32(f_rebuild),
            _F32(f_miss),
            _F32(e_step) / _F32(e_baseline),
            _F32(batches_remaining),
        ],
        _F32,
    )
    parts = [
        np.asarray(sigma_hat, _F32),
        np.asarray(owner_hit_rates, _F32),
        np.asarray([global_hit_rate], _F32),
        ratios,
        onehot_w,
        np.asarray(prev_weights, _F32),
    ]
    if headroom is not None:
        parts.append(np.asarray([headroom], _F32))
    return np.concatenate(parts).astype(_F32)


def estimate_delta_ms(recent_fetch_ratio, params: cm.CostModelParams):
    """Eq. (8): invert the RPC model, clamped to [0, params.delta_max_ms]
    and zeroed when the ratio is within 10% of clean (float32)."""
    ratio = np.asarray(recent_fetch_ratio, _F32)
    delta = (ratio - _F32(1.0)) * _F32(params.beta) / _F32(params.gamma_c)
    delta = np.clip(delta, _F32(0.0), _F32(params.delta_max_ms))
    return np.where(ratio <= _F32(CLEAN_RATIO_THRESHOLD), _F32(0.0), delta)


def sigma_from_fetch_ratio(recent_fetch_ratio, params: cm.CostModelParams):
    """Owner congestion multiplier from its observed fetch-latency ratio."""
    return cm.sigma_from_delta(params, estimate_delta_ms(recent_fetch_ratio,
                                                         params))


# ---------------------------------------------------------------------------
# Tensor forms for the training simulators (a leading env axis n)
# ---------------------------------------------------------------------------

def window_choices(device) -> torch.Tensor:
    """WINDOW_CHOICES as a float32 tensor on ``device`` (not to be written)."""
    return constant(tuple(float(w) for w in cm.WINDOW_CHOICES),
                    torch.device(device))


def allocation_weights_t(alloc_idx: torch.Tensor, n_owners: int
                         ) -> torch.Tensor:
    """:func:`allocation_weights` of each index in ``alloc_idx`` (n,):
    (n, n_owners) float32."""
    uniform = torch.full((alloc_idx.shape[0], n_owners), 1.0 / n_owners,
                         device=alloc_idx.device)
    if n_owners <= 1:
        return uniform
    owner = torch.clamp(alloc_idx - 1, 0, n_owners - 1)
    onehot = (torch.arange(n_owners, device=alloc_idx.device)
              == owner[:, None]).float()
    biased = onehot * BIAS_FRACTION + (1.0 - onehot) * (
        (1.0 - BIAS_FRACTION) / (n_owners - 1)
    )
    return torch.where((alloc_idx == 0)[:, None], uniform, biased)


def decode_action_t(action: torch.Tensor, n_owners: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Actions (n,) -> (windows (n,) float32, weights (n, n_owners))."""
    n_a = n_owners + 1
    window = window_choices(action.device)[action // n_a]
    return window, allocation_weights_t(action % n_a, n_owners)


def build_state_t(sigma_hat, owner_hit_rates, global_hit_rate, t_step,
                  t_base, f_rebuild, f_miss, e_step, e_baseline,
                  batches_remaining, prev_window, prev_weights
                  ) -> torch.Tensor:
    """:func:`build_state` for n envs: the per-owner arguments are (n,
    P-1), the others (n,); returns (n, state_dim) float32. The window's
    one-hot sits at its first exact match in WINDOW_CHOICES (index 0 when
    there is none, as the reference's argmax of an all-false mask)."""
    choices = window_choices(prev_window.device)
    w_idx = torch.argmax((choices == prev_window[:, None]).int(), dim=1)
    onehot_w = (torch.arange(N_WINDOWS, device=w_idx.device)
                == w_idx[:, None]).float()
    ratios = torch.stack([
        t_step / t_base,
        f_rebuild,
        f_miss,
        e_step / e_baseline,
        batches_remaining,
    ], dim=1)
    return torch.cat([sigma_hat, owner_hit_rates, global_hit_rate[:, None],
                      ratios, onehot_w, prev_weights], dim=1).float()


# ---------------------------------------------------------------------------
# Live controller (host side — called once per rebuild boundary; Algorithm 2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ControllerStats:
    """Per-boundary observations handed to the controller by the pipeline."""

    owner_hit_rates: np.ndarray      # (P-1,)
    global_hit_rate: float
    t_step: float
    f_rebuild: float
    f_miss: float
    e_step: float
    e_baseline: float
    batches_remaining: float
    headroom: float = 1.0            # tiered-store host headroom [0, 1]


class FetchTimeDeque:
    """Stage-3 fetch-time deque feeding both Eq. 8 and the RL state."""

    def __init__(self, n_owners: int, maxlen: int = 512):
        self.n_owners = n_owners
        self.times: collections.deque[tuple[int, float]] = collections.deque(
            maxlen=maxlen
        )

    def append(self, owner: int, seconds: float) -> None:
        self.times.append((int(owner), float(seconds)))

    def recent_median(self, k: int = 30) -> float:
        vals = [t for _, t in list(self.times)[-k:]]
        return float(np.median(vals)) if vals else 0.0

    def per_owner_median(self, k: int = 90) -> np.ndarray:
        out = np.zeros(self.n_owners)
        recent = list(self.times)[-k:]
        for o in range(self.n_owners):
            vals = [t for ow, t in recent if ow == o]
            out[o] = np.median(vals) if vals else 0.0
        return out


class AdaptiveController:
    """Algorithm 2: congestion estimation -> state -> argmax_a Q(s, a).

    ``q_fn(state) -> (n_actions,) Q-values`` abstracts the policy.
    """

    def __init__(
        self,
        q_fn: Callable[[np.ndarray], np.ndarray],
        params: cm.CostModelParams,
        n_owners: int = 3,
        observe_headroom: bool = False,
    ):
        self.q_fn = q_fn
        self.params = params
        self.n_owners = n_owners
        self.observe_headroom = bool(observe_headroom)
        self.deque = FetchTimeDeque(n_owners)
        self.t_base_hat: float | None = None
        self._owner_base: np.ndarray | None = None
        self.prev_window = 16.0
        self.prev_weights = np.full(n_owners, 1.0 / n_owners)
        self.last_state: np.ndarray | None = None
        self.last_sigma: np.ndarray | None = None

    # -- congestion estimation (Algorithm 2 lines 1-4) ----------------------
    def _estimate_sigma(self) -> np.ndarray:
        per_owner = self.deque.per_owner_median()
        if self.t_base_hat is None or self._owner_base is None:
            return np.ones(self.n_owners)
        base = np.where(self._owner_base > 0, self._owner_base, self.t_base_hat)
        ratio = np.where(base > 0, per_owner / np.maximum(base, 1e-9), 1.0)
        ratio = np.where(per_owner > 0, ratio, 1.0)
        sigma = sigma_from_fetch_ratio(ratio.astype(_F32), self.params)
        return np.maximum(sigma, _F32(1.0))

    def observe_warmup(self) -> None:
        """Record the uncongested baseline T_base_hat as the 15th
        percentile of the warmup fetch times (Section V-B)."""
        vals = [t for _, t in self.deque.times]
        if vals:
            self.t_base_hat = float(np.percentile(vals, 15))
            per_owner = np.zeros(self.n_owners)
            for o in range(self.n_owners):
                ov = [t for ow, t in self.deque.times if ow == o]
                per_owner[o] = np.percentile(ov, 15) if ov else self.t_base_hat
            self._owner_base = per_owner

    # -- per-boundary decision (Algorithm 2) --------------------------------
    def decide(self, stats: ControllerStats) -> tuple[int, np.ndarray, int]:
        sigma = self._estimate_sigma()
        self.last_sigma = sigma
        state = build_state(
            sigma,
            stats.owner_hit_rates,
            stats.global_hit_rate,
            stats.t_step,
            float(self.params.t_base),
            stats.f_rebuild,
            stats.f_miss,
            stats.e_step,
            max(stats.e_baseline, 1e-9),
            stats.batches_remaining,
            self.prev_window,
            self.prev_weights,
            headroom=stats.headroom if self.observe_headroom else None,
        )
        self.last_state = state
        q_values = np.asarray(self.q_fn(state))
        action = int(np.argmax(q_values))
        window, weights = decode_action(action, self.n_owners)
        window = float(window)
        self.prev_window = window
        self.prev_weights = weights
        return int(window), weights, action
