"""The small LM cases the mesh tests share: configs, rules, seeded numpy
inputs, and the port's sharded programs run by 4 gloo processes.

No JAX here: ``python tests/_spmd_cases.py OUT.npz`` spawns the 4
processes of a (2, 2) ``("data", "model")`` mesh on the CPU (gloo, real
collectives), runs every case's sharded train step and decode step
(``launch.train.make_train_step``, ``transformer.decode_step`` over
DTensors at the cases' rules) and writes what rank 0 gathers, each
result as its whole tensor, to OUT.npz. ``tests/_spmd_reference.py``
runs the reference's ``jit`` programs on the same inputs.
"""
from __future__ import annotations

import os
import socket
import sys

import numpy as np

SEED = 0
B, S = 4, 32                 # the train step's batch and sequence
ACCUM = {"gqa": 2, "mla": 1}
DECODE_B, DECODE_SMAX = 4, 16
DECODE_LEN = 9               # the cache holds 9 positions; the step writes
LR = 1e-2
MESH = ((2, 2), ("data", "model"))

# the fields of both packages' LMConfig; float32, flash at S >= 16
COMMON = dict(n_layers=2, d_model=32, d_ff=64, vocab=64, dtype="float32",
              remat=True, blockwise_threshold=16, attn_block_k=16,
              loss_chunk=16)
CASES = {
    # TinyLlama's rules: 4 q heads over model, 2 KV heads replicated (a
    # device reads one), the cache on cache_seq
    "gqa": (dict(COMMON, name="spmd-gqa", n_heads=4, n_kv_heads=2,
                 d_head=16, attn_type="gqa", grad_accum=ACCUM["gqa"]),
            {"heads": "model", "kv_heads": None, "cache_seq": "model"}),
    # deepseek-v2's rules: MLA with the latent on model, MoE after one
    # dense layer
    "mla": (dict(COMMON, name="spmd-mla", n_heads=4, n_kv_heads=4,
                 d_head=16, attn_type="mla", q_lora=16, kv_lora=16,
                 d_nope=16, d_rope=8, d_v=16, moe=True, n_experts=4,
                 top_k=2, n_shared=1, d_ff_expert=16, first_k_dense=1,
                 capacity_factor=2.0, grad_accum=ACCUM["mla"]),
            {"heads": "model", "kv_lora": "model", "q_lora": None,
             "cache_seq": None}),
}


def rules_of(case: str, default_rules, multi: bool = False) -> dict:
    """The case's rules from a package's ``default_rules``: single-pod
    (or ``multi``-pod), ``cache_seq`` replicated unless the case says
    otherwise, its overrides (as ``cell_rules`` makes them)."""
    rules = default_rules(multi)
    rules.setdefault("cache_seq", None)
    rules.update(CASES[case][1])
    return rules


def numpy_params(shapes: dict, seed: int = SEED) -> dict:
    """Seeded float32 parameters of ``shapes`` (name -> shape, nested as
    the parameter tree; norms near 1)."""
    rng = np.random.default_rng(seed)

    def draw(tree, prefix=""):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out[k] = draw(v, prefix + k + "/")
            elif "norm" in k or k.startswith("ln_"):
                out[k] = (1 + 0.1 * rng.standard_normal(v)).astype(np.float32)
            else:
                out[k] = (0.3 * rng.standard_normal(v)).astype(np.float32)
        return out

    return draw(shapes)


def inputs(cfg_fields: dict, seed: int = SEED) -> dict:
    """Seeded tokens, targets, a decode token and a filled cache."""
    rng = np.random.default_rng(seed + 1)
    v, n_layers = cfg_fields["vocab"], cfg_fields["n_layers"]
    lead = (n_layers, DECODE_B, DECODE_SMAX)
    if cfg_fields["attn_type"] == "mla":
        cache = {"c": lead + (cfg_fields["kv_lora"],),
                 "r": lead + (cfg_fields["d_rope"],)}
    else:
        cache = {k: lead + (cfg_fields["n_kv_heads"], cfg_fields["d_head"])
                 for k in ("k", "v")}
    cache = {k: np.where(np.arange(DECODE_SMAX)[None, None, :, None]
                         < DECODE_LEN, 0.5 * rng.standard_normal(s).reshape(
                             s[0], s[1], s[2], -1), 0.0).reshape(s)
             .astype(np.float32) for k, s in cache.items()}
    return {"tokens": rng.integers(0, v, (B, S)),
            "targets": rng.integers(0, v, (B, S)),
            "token": rng.integers(0, v, (DECODE_B, 1)),
            "cache": cache}


def flat(tree, prefix: str = "") -> dict:
    """``{"a/b": leaf}`` of nested dicts and lists (a tuple is a leaf)."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, list) else None)
    if items is None:
        return {prefix.rstrip("/"): tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}{k}/"))
    return out


COLLECTIVES = ("psum", "pmean", "reduce_scatter", "all_gather_rows",
               "deferred_scatter", "deferred_allreduce")


def collective_tree(rank: int) -> dict:
    """Rank ``rank``'s seeded tree for the collective helpers (every dim 0
    a multiple of 2, a mesh dim's size)."""
    rng = np.random.default_rng(SEED + 10 + rank)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": [rng.standard_normal((2, 5)).astype(np.float32),
                  rng.standard_normal((6,)).astype(np.float32)]}


def mesh_groups(dim: int) -> list:
    """The ranks that share a collective over mesh dim ``dim`` of
    ``MESH`` (ranks in row-major order)."""
    ranks = np.arange(MESH[0][0] * MESH[0][1]).reshape(MESH[0])
    return [list(g) for g in np.moveaxis(ranks, dim, -1).reshape(
        -1, MESH[0][dim])]


# ------------------------------------------------------ the port's side
def torch_config(case: str):
    from repro_torch.models.lm import transformer as tf

    return tf.LMConfig(**CASES[case][0])


def param_shapes(case: str) -> dict:
    """The case's parameter tree as shapes (the port's ``init`` on
    ``meta``)."""
    from repro_torch.models.lm import transformer as tf

    params = tf.init(torch_config(case), device="meta")

    def shapes(t):
        return ({k: shapes(v) for k, v in t.items()} if isinstance(t, dict)
                else tuple(t.shape))

    return shapes(params)


def _worker(rank: int, world: int, port: int, out: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch import convert, optim
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.lm import transformer as tf

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        dmesh = mesh_lib.device_mesh(mesh_lib.Mesh(MESH[1], MESH[0]), "cpu")
        results = {}
        for case in CASES:
            cfg = torch_config(case)
            rules = rules_of(case, shlib.default_rules)
            data = inputs(CASES[case][0])
            params = convert.lm_params_from_jax(
                numpy_params(param_shapes(case)))
            axes = tf.param_axes(cfg)
            opt = optim.adamw(LR, weight_decay=0.1, max_grad_norm=1.0)
            tok_axes = ("batch", "seq")
            dp = shlib.distribute_tree(params, axes, rules, dmesh)
            toks = [shlib.distribute_tree(torch.from_numpy(data[k]),
                                          tok_axes, rules, dmesh)
                    for k in ("tokens", "targets")]
            step = make_train_step(cfg, opt, cfg.grad_accum)
            with shlib.use_rules(rules, dmesh):
                new, state, loss = step(dp, opt.init(dp), *toks)
            results[f"{case}/loss"] = shlib.replicated(loss).to_local()
            for k, v in flat(new).items():
                results[f"{case}/param/{k}"] = v.full_tensor()
            for k, v in flat(state.mu).items():
                results[f"{case}/mu/{k}"] = v.full_tensor()
            # a decode step over the cache at the case's rules
            cache = {k: torch.from_numpy(v) for k, v in data["cache"].items()}
            dc = shlib.distribute_tree(cache, tf.cache_specs(cfg), rules,
                                       dmesh)
            tok = shlib.distribute_tree(torch.from_numpy(data["token"]),
                                        tok_axes, rules, dmesh)
            with shlib.use_rules(rules, dmesh):
                logits, dc = tf.decode_step(dp, cfg, tok, dc, DECODE_LEN)
            results[f"{case}/logits"] = shlib.replicated(logits).to_local()
            for k, v in dc.items():
                results[f"{case}/cache/{k}"] = v.full_tensor()
        if rank == 0:
            np.savez(out, **{k: v.detach().numpy()
                             for k, v in results.items()})
        # the collective helpers over each mesh dim, on this rank's tree
        tree = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else
                [torch.from_numpy(x) for x in v]
                for k, v in collective_tree(rank).items()}
        mine = {}
        for dim, name in enumerate(MESH[1]):
            for fn in COLLECTIVES:
                got = {
                    "psum": lambda: coll.psum_over(tree, dmesh, name),
                    "pmean": lambda: coll.pmean_over(tree, dmesh, name),
                    "reduce_scatter": lambda: coll.reduce_scatter_over(
                        tree, dmesh, name),
                    "all_gather_rows": lambda: coll.all_gather_rows_over(
                        tree["w"], dmesh, name),
                    "deferred_scatter": lambda: coll.deferred_grad_sync_over(
                        tree, dmesh, name, scatter=True),
                    "deferred_allreduce":
                        lambda: coll.deferred_grad_sync_over(
                            tree, dmesh, name, scatter=False),
                }[fn]()
                for k, v in flat(got).items():
                    mine[f"{dim}/{fn}/{k}".rstrip("/")] = np.asarray(
                        v.wait() if hasattr(v, "wait") else v)
        np.savez(f"{out}.rank{rank}.npz", **mine)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(out: str) -> None:
    import torch.multiprocessing as mp

    world = MESH[0][0] * MESH[0][1]
    mp.spawn(_worker, args=(world, free_port(), out), nprocs=world)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", "src"))
    main(sys.argv[1])
