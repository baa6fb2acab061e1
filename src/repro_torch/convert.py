"""Carry weights between the reference's numpy trees and the port.

The reference stores SAGE parameters as ``{"layer_i": {"w_self",
"w_neigh", "b"}}``, the qnet as ``{"l1": {"w", "b"}, ...}``, the LM
as ``{"embed", "lm_head", "final_norm", "layers": {...}}`` with the layers
stacked along a leading axis, the GNN zoo (PNA, GatedGCN, NequIP, MACE) as
nested ``ParamBuilder`` dicts (``{"layer_i": {..., "lin_self": {"0", "1",
"2"}}}``) and FM as ``{"table", "linear", "bias"}``; the port keeps every
layout, as dicts of tensors. JAX's PRNG cannot be reproduced in torch, so
parity tests initialise in the reference and carry the arrays across with
these functions.
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


def lm_params_from_jax(np_tree: dict, device="cpu", dtype=None) -> dict:
    """Reference LM parameters (numpy arrays) -> the port's tensors.

    JAX hands numpy its bf16 arrays as ``ml_dtypes.bfloat16``, which torch
    cannot read: every array goes through float32 (exact for bf16) and is
    then cast to ``dtype``, or back to bf16 or float32 as it came."""
    out = {}
    for name, sub in np_tree.items():
        if isinstance(sub, dict):
            out[name] = lm_params_from_jax(sub, device, dtype)
            continue
        arr = np.asarray(sub)
        dt = dtype or (torch.bfloat16 if arr.dtype.name == "bfloat16"
                       else torch.float32)
        out[name] = torch.tensor(arr.astype(np.float32)).to(
            device=device, dtype=dt)
    return out


def lm_params_to_jax(params: dict) -> dict:
    """The port's LM parameters -> float32 numpy arrays in the reference
    layout (a bf16 tensor widens exactly; ``jnp.asarray(x, jnp.bfloat16)``
    gives the reference's array back bit for bit)."""
    return {
        name: lm_params_to_jax(sub) if isinstance(sub, dict)
        else sub.detach().float().cpu().numpy()
        for name, sub in params.items()
    }


def gnn_params_from_jax(np_tree: dict, device="cpu") -> dict:
    """Reference PNA, GatedGCN, NequIP or MACE parameters (nested numpy
    dicts) -> the port's tensors."""
    return _to_torch(np_tree, device)


def gnn_params_to_jax(params: dict) -> dict:
    """The port's GNN-zoo parameters -> numpy arrays in the reference
    layout."""
    return _to_numpy(params)


def fm_params_from_jax(np_tree: dict, device="cpu") -> dict:
    """Reference FM parameters (numpy arrays) -> the port's tensors."""
    return _to_torch(np_tree, device)


def fm_params_to_jax(params: dict) -> dict:
    """The port's FM parameters -> numpy arrays in the reference layout."""
    return _to_numpy(params)
