"""AdamW and Adam written out, in the reference's functional form.

Port of ``repro/optim/optimizers.py``'s ``global_norm``,
``clip_by_global_norm``, ``adamw`` and ``adam``. ``torch.optim.AdamW`` is not
a substitute: the reference divides the bias-corrected moments,
``(m / bc1) / (sqrt(v / bc2) + eps)``, where torch computes
``sqrt(v) / sqrt(bc2) + eps``, and the two apply weight decay differently.

An optimizer is a pair (init, update) over nested dicts (or lists and
tuples) of tensors:
    state = init(params)
    updates, state = update(grads, state, params)
    params = apply_updates(params, updates)
All arithmetic is float32, with the Python constants cast to float32 as
the reference's weakly-typed scalars are. The clip scale is a tensor on
the gradients' device: clipping reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leaf-wise over nested dicts, lists and tuples of
    tensors (``rest`` must have the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """The leaves in the order :func:`tree_map` visits them."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(tree: Tree, leaves) -> Tree:
    """A tree of ``tree``'s structure holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


class Optimizer(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], tuple[Tree, Any]]


@dataclasses.dataclass
class OptState:
    step: int
    mu: Tree
    nu: Tree


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, summed leaf by leaf as the
    reference does (a 0-dim float32 tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree: Tree, max_norm: float
                        ) -> tuple[Tree, torch.Tensor]:
    """Scale every leaf by ``min(1, max_norm / (norm + 1e-12))``; returns
    the scaled tree and the norm before scaling."""
    norm = global_norm(tree)
    # a divide, not ``max_norm / t`` (torch multiplies by the reciprocal)
    scale = torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-12),
                        max=1.0)
    return tree_map(lambda x: x * scale, tree), norm


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def adamw(
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_grad_norm: float | None = None,
) -> Optimizer:
    """AdamW with optional global-norm clipping and decoupled weight
    decay."""

    def init(params: Tree) -> OptState:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)

        return OptState(step=0, mu=tree_map(zeros, params),
                        nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(grads: Tree, state: OptState, params: Tree):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
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


def adam(
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    max_grad_norm: float | None = None,
) -> Optimizer:
    return adamw(learning_rate, b1, b2, eps, 0.0, max_grad_norm)
