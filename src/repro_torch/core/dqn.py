"""Double-DQN Q-network inference (paper Section IV-C.2).

Port of the inference half of ``repro/core/dqn.py``: the 23 -> 256 ReLU ->
256 ReLU -> 32 Q-network, its He-normal init and the reference's npz
layout (keys ``l1.w``, ``l1.b``, ... ``l3.b``), so a policy trained by the
reference drives the port's controller. Training (replay, Double-DQN loss,
the scan over vectorised simulators) waits in ROADMAP queue 1 (DQN
training and the simulator twins).

A qnet is a plain dict ``{"l1": {"w": (in, out), "b": (out,)}, ...}`` of
float32 tensors, the reference's layout.
"""
from __future__ import annotations

import math

import numpy as np
import torch

HIDDEN = 256


def init_qnet(generator: torch.Generator, state_dim: int, n_actions: int,
              device: torch.device | str = "cpu") -> dict:
    """He-normal weights (std sqrt(2 / n_in)) and zero biases, drawn from
    ``generator`` (a CPU generator, so the draw does not depend on the
    device)."""

    def dense(n_in, n_out):
        w = torch.randn((n_in, n_out), generator=generator) \
            * math.sqrt(2.0 / n_in)
        return {"w": w.to(device), "b": torch.zeros(n_out, device=device)}

    return {
        "l1": dense(state_dim, HIDDEN),
        "l2": dense(HIDDEN, HIDDEN),
        "l3": dense(HIDDEN, n_actions),
    }


def q_forward(params: dict, state: torch.Tensor) -> torch.Tensor:
    x = torch.relu(state @ params["l1"]["w"] + params["l1"]["b"])
    x = torch.relu(x @ params["l2"]["w"] + params["l2"]["b"])
    return x @ params["l3"]["w"] + params["l3"]["b"]


def q_fn_of(params: dict):
    """``q_fn(state: np.ndarray) -> np.ndarray`` for the controller, on
    the device the qnet's tensors live on."""
    device = params["l1"]["w"].device

    @torch.no_grad()
    def q_fn(state: np.ndarray) -> np.ndarray:
        s = torch.as_tensor(np.asarray(state, np.float32), device=device)
        return q_forward(params, s).cpu().numpy()

    return q_fn


def save_qnet(path: str, qnet: dict) -> None:
    flat = {
        f"{layer}.{name}": v.detach().cpu().numpy()
        for layer, sub in qnet.items()
        for name, v in sub.items()
    }
    np.savez(path, **flat)


def load_qnet(path: str, device: torch.device | str = "cpu") -> dict:
    out: dict[str, dict[str, torch.Tensor]] = {}
    with np.load(path) as data:
        for key in data.files:
            layer, name = key.split(".")
            out.setdefault(layer, {})[name] = torch.as_tensor(
                data[key], device=device
            )
    return out
