"""Carry weights between the reference's numpy trees and the port.

The reference stores SAGE parameters as ``{"layer_i": {"w_self",
"w_neigh", "b"}}`` and the qnet as ``{"l1": {"w", "b"}, ...}``; the port
keeps both layouts, as dicts of float32 tensors. JAX's PRNG cannot be
reproduced in torch, so parity tests initialise in the reference and carry
the arrays across with these functions.
"""
from __future__ import annotations

import numpy as np
import torch


def _to_torch(tree: dict, device) -> dict:
    return {
        name: _to_torch(sub, device) if isinstance(sub, dict)
        else torch.tensor(np.asarray(sub, np.float32), device=device)
        for name, sub in tree.items()
    }


def _to_numpy(tree: dict) -> dict:
    return {
        name: _to_numpy(sub) if isinstance(sub, dict)
        else sub.detach().cpu().numpy()
        for name, sub in tree.items()
    }


def sage_params_from_jax(np_tree: dict, device="cpu") -> dict:
    """Reference SAGE parameters (numpy arrays) -> the port's tensors."""
    return _to_torch(np_tree, device)


def sage_params_to_jax(params: dict) -> dict:
    """The port's SAGE parameters -> numpy arrays in the reference layout."""
    return _to_numpy(params)


def qnet_from_jax(np_tree: dict, device="cpu") -> dict:
    """Reference qnet (numpy arrays) -> the port's tensors."""
    return _to_torch(np_tree, device)


def qnet_to_jax(qnet: dict) -> dict:
    """The port's qnet -> numpy arrays in the reference layout."""
    return _to_numpy(qnet)
