"""The reference's sharded ``jit`` programs of ``tests/_spmd_cases.py``:
``python tests/_spmd_reference.py OUT.npz`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and
``JAX_PLATFORMS=cpu``.

For each case, on a (2, 2) ``("data", "model")`` mesh of host devices:
the train step of ``repro/launch/cell.py``'s ``train_4k`` cell (the loss
and gradients of ``grad_accum`` microbatches of ``reshape(accum, b //
accum, s)``, then AdamW), and one ``decode_step`` over the case's cache,
``jit`` with ``in_shardings`` from the case's rules. Writes the loss, the
parameters and first moments after the step, the decode logits and the
cache, as numpy arrays.
"""
from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import _spmd_cases as cases  # noqa: E402
from repro import optim  # noqa: E402
from repro.distributed import sharding as shlib  # noqa: E402
from repro.launch.mesh import make_mesh_from_shape  # noqa: E402
from repro.models.lm import transformer as tf  # noqa: E402


def run_case(case: str, mesh) -> dict:
    fields, _ = cases.CASES[case]
    cfg = tf.LMConfig(**fields)
    rules = cases.rules_of(case, shlib.default_rules)
    data = cases.inputs(fields)
    _, axes = tf.init(jax.random.PRNGKey(0), cfg, abstract=True)
    shapes = jax.tree.map(lambda a: tuple(a.shape),
                          tf.init(jax.random.PRNGKey(0), cfg,
                                  abstract=True)[0])
    params = jax.tree.map(jnp.asarray, cases.numpy_params(shapes))
    param_sh = shlib.tree_specs(axes, rules, mesh)
    tok_sh = NamedSharding(mesh, shlib.spec_for(("batch", "seq"), rules,
                                                mesh))
    opt = optim.adamw(cases.LR, weight_decay=0.1, max_grad_norm=1.0)
    accum = cfg.grad_accum
    b, s = cases.B, cases.S

    def step_fn(params, opt_state, tokens, targets):
        with shlib.use_rules(rules, mesh):
            if accum == 1:
                loss, grads = jax.value_and_grad(tf.lm_loss)(
                    params, cfg, tokens, targets)
            else:
                tm = tokens.reshape(accum, b // accum, s)
                gm = targets.reshape(accum, b // accum, s)

                def micro(acc, xs):
                    t, g = xs
                    l, gr = jax.value_and_grad(tf.lm_loss)(params, cfg, t, g)
                    return (jax.tree.map(jnp.add, acc[0], gr),
                            acc[1] + l), None

                zero = jax.tree.map(lambda p: jnp.zeros(p.shape,
                                                        jnp.float32), params)
                (gsum, lsum), _ = jax.lax.scan(micro, (zero, 0.0), (tm, gm))
                grads = jax.tree.map(lambda g: g / accum, gsum)
                loss = lsum / accum
        updates, new_opt = opt.update(grads, opt_state, params)
        return optim.apply_updates(params, updates), new_opt, loss

    state = opt.init(params)
    state_sh = jax.tree.map(lambda _: NamedSharding(mesh, P()), state)
    state_sh = state_sh._replace(mu=param_sh, nu=param_sh) if hasattr(
        state_sh, "_replace") else type(state)(
        step=NamedSharding(mesh, P()), mu=param_sh, nu=param_sh)
    step = jax.jit(step_fn, in_shardings=(param_sh, state_sh, tok_sh,
                                          tok_sh))
    new, new_state, loss = step(params, state, jnp.asarray(data["tokens"]),
                                jnp.asarray(data["targets"]))
    out = {f"{case}/loss": np.asarray(loss)}
    out.update({f"{case}/param/{k}": np.asarray(v)
                for k, v in cases.flat(new).items()})
    out.update({f"{case}/mu/{k}": np.asarray(v)
                for k, v in cases.flat(new_state.mu).items()})

    cache = {k: jnp.asarray(v) for k, v in data["cache"].items()}
    cache_axes = tf.cache_specs(cfg)
    cache_sh = {k: NamedSharding(mesh, shlib.spec_for(cache_axes[k], rules,
                                                      mesh)) for k in cache}

    def decode(params, token, cache):
        with shlib.use_rules(rules, mesh):
            return tf.decode_step(params, cfg, token, cache,
                                  jnp.asarray(cases.DECODE_LEN, jnp.int32))

    logits, new_cache = jax.jit(decode, in_shardings=(
        param_sh, tok_sh, cache_sh))(params, jnp.asarray(data["token"]),
                                     cache)
    out[f"{case}/logits"] = np.asarray(logits)
    out.update({f"{case}/cache/{k}": np.asarray(v)
                for k, v in new_cache.items()})
    return out


def run_collectives() -> dict:
    """Each rank's result of the reference's collective helpers
    (``repro/distributed/collectives.py``) over each mesh dim, under
    ``vmap`` over the ranks that share it; keyed as the port's."""
    from repro.distributed import collectives as rcoll

    fns = {
        "psum": lambda t: rcoll.psum_tree(t, "i"),
        "pmean": lambda t: rcoll.pmean_tree(t, "i"),
        "reduce_scatter": lambda t: rcoll.reduce_scatter_tree(t, "i"),
        "all_gather_rows": lambda t: rcoll.all_gather_rows(t["w"], "i"),
        "deferred_scatter": lambda t: rcoll.deferred_grad_sync(t, "i", True),
        "deferred_allreduce":
            lambda t: rcoll.deferred_grad_sync(t, "i", False),
    }
    out = {}
    for dim in range(len(cases.MESH[1])):
        for group in cases.mesh_groups(dim):
            trees = [cases.collective_tree(r) for r in group]
            stacked = jax.tree.map(lambda *xs: np.stack(xs), *trees)
            for name in cases.COLLECTIVES:
                got = jax.vmap(fns[name], axis_name="i")(stacked)
                for i, r in enumerate(group):
                    mine = jax.tree.map(lambda x, i=i: np.asarray(x[i]), got)
                    for k, v in cases.flat(mine).items():
                        out[f"{r}/{dim}/{name}/{k}".rstrip("/")] = v
    return out


def main(path: str) -> None:
    mesh = make_mesh_from_shape(*cases.MESH)
    out = {}
    for case in cases.CASES:
        out.update(run_case(case, mesh))
    out.update({f"coll/{k}": v for k, v in run_collectives().items()})
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
