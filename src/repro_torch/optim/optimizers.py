"""AdamW, Adam, SGD and the LR schedules, in the reference's functional form.

Port of ``repro/optim/optimizers.py``: ``global_norm``,
``clip_by_global_norm``, ``adamw``, ``adam``, ``sgd``, ``cosine_schedule``
and ``warmup_cosine_schedule``. ``torch.optim.AdamW`` is not
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
the gradients' device: clipping reads nothing back to the host. A learning
rate is a float or a schedule, a callable of the (1-based) step count; a
schedule computes in float32 on the host, as the jnp version does, and
returns a 0-dim float32 tensor.

Over a mesh the leaves are DTensors (``launch.cell`` with a
``DeviceMesh``) and the same code runs on each device's shards:
:func:`global_norm`'s sum over a sharded leaf is a partial sum, which
DTensor all-reduces when the norm is used; the learning rate and the
bias corrections stay host scalars.
"""
from __future__ import annotations

import dataclasses
import math
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
    the scaled tree and the norm before scaling. A leaf narrower than
    float32 (bf16) is scaled in float32 and stays float32, as jnp promotes
    ``bf16 * f32``."""
    norm = global_norm(tree)
    # a divide, not ``max_norm / t`` (torch multiplies by the reciprocal)
    scale = torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-12),
                        max=1.0)
    return tree_map(
        lambda x: x.to(torch.promote_types(x.dtype, scale.dtype)) * scale,
        tree), norm


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def _schedule_value(lr, step: int) -> float:
    """The learning rate at ``step``: ``lr(step)`` for a schedule (its
    float32 value, exact as a Python float), else ``lr``."""
    return float(lr(step)) if callable(lr) else lr


def adamw(
    learning_rate: float | Callable[[int], torch.Tensor],
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
        lr = _schedule_value(learning_rate, step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state.nu, grads)
        # the clipped tree is read for the last time: free it before the
        # updates take their own tree (a float32 copy of the parameters)
        del grads
        t = torch.tensor(float(step), dtype=torch.float32)
        bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** t).item()
        bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** t).item()
        updates = tree_map(
            lambda m, v, p: -lr * (
                (m / bc1) / (torch.sqrt(v / bc2) + eps)
                + weight_decay * p.float()
            ),
            mu, nu, params,
        )
        return updates, OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)


def adam(
    learning_rate: float | Callable[[int], torch.Tensor],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    max_grad_norm: float | None = None,
) -> Optimizer:
    return adamw(learning_rate, b1, b2, eps, 0.0, max_grad_norm)


def sgd(
    learning_rate: float | Callable[[int], torch.Tensor],
    momentum: float = 0.0,
) -> Optimizer:
    """SGD with heavy-ball momentum: ``mu = momentum * mu + g`` and the
    update ``-lr * mu``; ``nu`` is carried unchanged, as in the
    reference."""

    def init(params: Tree) -> OptState:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)

        return OptState(step=0, mu=tree_map(zeros, params),
                        nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(grads: Tree, state: OptState, params: Tree):
        step = state.step + 1
        lr = _schedule_value(learning_rate, step)
        mu = tree_map(lambda m, g: momentum * m + g.float(), state.mu, grads)
        updates = tree_map(lambda m: -lr * m, mu)
        return updates, OptState(step=step, mu=mu, nu=state.nu)

    return Optimizer(init, update)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def cosine_schedule(base_lr: float, total_steps: int,
                    final_frac: float = 0.1) -> Callable[[int], torch.Tensor]:
    """``base_lr * (final_frac + (1 - final_frac) * (1 + cos(pi t)) / 2)``
    with ``t = clip(step / total_steps, 0, 1)``, in float32."""

    def fn(step) -> torch.Tensor:
        t = torch.clamp(torch.as_tensor(step, dtype=torch.float32)
                        / _f32(total_steps), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(_f32(math.pi) * t))
        return base_lr * (final_frac + (1 - final_frac) * cos)

    return fn


def warmup_cosine_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int, final_frac: float = 0.1
                           ) -> Callable[[int], torch.Tensor]:
    """Linear warmup to ``base_lr`` over ``warmup_steps``, then
    :func:`cosine_schedule` over the remaining steps."""
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1),
                          final_frac)

    def fn(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / _f32(max(warmup_steps, 1))
        return torch.where(step < warmup_steps, warm,
                           cos(step - warmup_steps))

    return fn
