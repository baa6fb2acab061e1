"""AdamW written out, in the reference's functional form.

Port of ``repro/optim/optimizers.py::adamw``. ``torch.optim.AdamW`` is not
a substitute: the reference divides the bias-corrected moments,
``(m / bc1) / (sqrt(v / bc2) + eps)``, where torch computes
``sqrt(v) / sqrt(bc2) + eps``, and the two apply weight decay differently.

An optimizer is a pair (init, update) over nested dicts of tensors:
    state = init(params)
    updates, state = update(grads, state, params)
    params = apply_updates(params, updates)
All arithmetic is float32, with the Python constants cast to float32 as
the reference's weakly-typed scalars are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leaf-wise over nested dicts of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


class Optimizer(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], tuple[Tree, Any]]


@dataclasses.dataclass
class OptState:
    step: int
    mu: Tree
    nu: Tree


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def adamw(
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    """AdamW with decoupled weight decay (no gradient clipping)."""

    def init(params: Tree) -> OptState:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)

        return OptState(step=0, mu=tree_map(zeros, params),
                        nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(grads: Tree, state: OptState, params: Tree):
        step = state.step + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state.nu, grads)
        t = torch.tensor(float(step), dtype=torch.float32)
        bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** t).item()
        bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** t).item()
        updates = tree_map(
            lambda m, v, p: -learning_rate * (
                (m / bc1) / (torch.sqrt(v / bc2) + eps)
                + weight_decay * p.float()
            ),
            mu, nu, params,
        )
        return updates, OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)
