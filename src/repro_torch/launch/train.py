"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Port of ``repro/launch/train.py``: the arch's smoke config trains a few
real steps (AdamW 1e-3, clip 1.0, tokens (4, 64) as their own targets)
with checkpointing every ``--ckpt-every`` steps and ``--resume`` from the
newest checkpoint, printing the reference's lines. What differs:

- ``--device`` defaults to the card and raises where there is none;
- ``--ckpt-dir`` defaults to ``repro_torch_ckpt`` in the temporary
  directory, so the two packages never share a checkpoint directory;
- each step's tokens come from a ``torch.Generator`` seeded with the step
  (the reference's ``jax.random`` draws cannot be repeated in torch), so
  a resumed run draws what an uninterrupted one would.

:func:`make_train_step` is the step of the reference's ``train_4k`` cell
(``repro/launch/cell.py:86-122``): the loss and gradients of each of
``accum`` microbatches, the float32 gradients summed (in place) and
divided by ``accum``, then the optimizer's update. ``main`` uses it with
``accum=1``. Over a mesh (tokens and parameters DTensors, ``launch.cell``
with a ``DeviceMesh``) a microbatch takes the same share of every
device's local rows (``sharding.split_local_rows``: no collective),
where the reference reshapes the global batch to ``(accum, b // accum,
s)``: a stated divergence. The microbatches then hold other rows, so
the summed gradient is the reference's up to float reassociation (and,
with MoE, up to which tokens an expert's capacity drops).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.device import resolve
from repro_torch.distributed import sharding as shlib
from repro_torch.optim.optimizers import (
    apply_updates,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

TOKEN_SEED = 1   # the reference draws its tokens from PRNGKey(1)


def value_and_grad(params, cfg, tokens, targets):
    """``lm_loss`` and its gradient with respect to every parameter, as a
    tree of ``params``' structure (each gradient in its parameter's
    dtype)."""
    from repro_torch.models.lm import transformer as tf

    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = tf.lm_loss(tree_unflatten(params, leaves), cfg, tokens, targets)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg, opt, accum: int = 1):
    """step(params, opt_state, tokens, targets) -> (params, opt_state,
    loss) for tokens and targets (B, S), B a multiple of ``accum``."""
    accum = max(accum, 1)

    def step(params, opt_state, tokens, targets):
        b, s = tokens.shape
        if b % accum:
            raise ValueError(f"batch {b} is not a multiple of accum {accum}")
        if accum == 1:
            loss, grads = value_and_grad(params, cfg, tokens, targets)
        else:
            # gradient accumulation: the activation peak scales with
            # b / accum, not b
            if shlib.is_dtensor(tokens):
                tm = shlib.split_local_rows(tokens, accum)
                gm = shlib.split_local_rows(targets, accum)
                grads = tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params)
            else:
                tm = tokens.reshape(accum, b // accum, s)
                gm = targets.reshape(accum, b // accum, s)
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)
            lsum = 0.0 if shlib.is_dtensor(tokens) else torch.zeros(
                (), dtype=torch.float32, device=tokens.device)
            for t, g in zip(tm, gm):
                loss, gr = value_and_grad(params, cfg, t, g)
                for acc, x in zip(tree_leaves(grads), tree_leaves(gr)):
                    acc.add_(x)
                lsum = lsum + loss
                del gr
            grads = tree_map(lambda x: x / accum, grads)
            loss = lsum / accum
        updates, new_opt = opt.update(grads, opt_state, params)
        return apply_updates(params, updates), new_opt, loss

    return step


def step_tokens(step: int, shape: tuple, vocab: int, device) -> torch.Tensor:
    """Step ``step``'s tokens, drawn from a generator seeded with it."""
    gen = torch.Generator().manual_seed(TOKEN_SEED * 1_000_003 + step)
    return torch.randint(0, vocab, shape, generator=gen).to(device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch import optim
    from repro_torch.configs.registry import get_arch
    from repro_torch.train import checkpoint as ckpt

    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise SystemExit(
            "train.py drives LM archs; GNN training uses "
            "examples/train_distributed_gnn.py (GreenDyGNN pipeline)"
        )
    from repro_torch.models.lm import transformer as tf

    dev = resolve(args.device)
    cfg = arch.make_smoke_config()
    params = tf.init(cfg, seed=0, device=dev)
    opt = optim.adamw(1e-3, max_grad_norm=1.0)
    opt_state = opt.init(params)
    start = 0
    if args.resume:
        try:
            (params, opt_state), start = ckpt.restore_checkpoint(
                args.ckpt_dir, (params, opt_state)
            )
            print(f"resumed from step {start}")
        except FileNotFoundError:
            print("no checkpoint found; starting fresh")

    step = make_train_step(cfg, opt)
    t0 = time.time()
    for i in range(start, start + args.steps):
        tokens = step_tokens(i, (4, 64), cfg.vocab, dev)
        params, opt_state, loss = step(params, opt_state, tokens, tokens)
        if (i + 1) % args.ckpt_every == 0:
            ckpt.save_checkpoint(args.ckpt_dir, i + 1, (params, opt_state))
            print(f"step {i + 1}: loss {float(loss):.4f} (checkpointed)")
        elif (i + 1) % 5 == 0:
            print(f"step {i + 1}: loss {float(loss):.4f}")
    print(f"{args.steps} steps in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
