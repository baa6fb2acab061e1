"""The reference's shards for ``tests/test_torch_spmd_count.py``:
``python tests/_spmd_shards_reference.py OUT`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=512`` and
``JAX_PLATFORMS=cpu``. Writes:

* ``OUT.npz``: every device's shard of every leaf of each small case of
  ``tests/_spmd_cases.py`` (parameters, tokens, cache) put on a
  (2, 2, 2) ``("pod", "data", "model")`` mesh under the case's multi-pod
  rules, keyed ``case/path/device index in the mesh``
  (``addressable_shards``, in the mesh's device order);
* ``OUT.json``: each LM cell's argument shard shapes
  (``NamedSharding(...).shard_shape``) at 16 x 16 and 2 x 16 x 16, from
  the reference's own ``launch.cell.build_cell``.
"""
from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

import _spmd_cases as cases  # noqa: E402
from repro.configs.registry import ARCHS, get_arch  # noqa: E402
from repro.distributed import sharding as shlib  # noqa: E402
from repro.launch.cell import build_cell  # noqa: E402
from repro.launch.mesh import make_mesh_from_shape, make_production_mesh  # noqa: E402,E501
from repro.models.lm import transformer as tf  # noqa: E402


def key_str(path) -> str:
    out = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                out.append(str(getattr(k, attr)))
                break
    return "/".join(out)


def shards(mesh) -> dict:
    order = {d.id: i for i, d in enumerate(mesh.devices.flat)}
    out = {}
    for case, (fields, _) in cases.CASES.items():
        cfg = tf.LMConfig(**fields)
        rules = cases.rules_of(case, shlib.default_rules, multi=True)
        _, axes = tf.init(jax.random.PRNGKey(0), cfg, abstract=True)
        shapes = jax.tree.map(lambda a: tuple(a.shape), tf.init(
            jax.random.PRNGKey(0), cfg, abstract=True)[0])
        data = cases.inputs(fields)
        trees = {"params": (cases.numpy_params(shapes), axes),
                 "tokens": (data["tokens"], ("batch", "seq")),
                 "cache": (data["cache"], tf.cache_specs(cfg))}
        for name, (tree, ax) in trees.items():
            leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
            for path, leaf in leaves:
                a = ax
                for k in path:
                    a = a[getattr(k, "key", None)]
                arr = jax.device_put(leaf, NamedSharding(
                    mesh, shlib.spec_for(a, rules, mesh)))
                for s in arr.addressable_shards:
                    p = key_str(path)
                    out[f"{case}/{name}/{p}/{order[s.device.id]}"
                        .replace("//", "/")] = np.asarray(s.data)
    return out


def shard_shapes() -> dict:
    out = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for arch_id in ARCHS:
            arch = get_arch(arch_id)
            if arch.family != "lm":
                continue
            for shape in arch.shapes:
                cell = build_cell(arch, shape, mesh)
                leaves = jax.tree_util.tree_flatten_with_path(cell["args"])[0]
                shardings = jax.tree.leaves(cell["in_shardings"])
                got = {}
                for (path, sds), sh in zip(leaves, shardings):
                    if len(sds.shape):
                        got[key_str(path)] = list(sh.shard_shape(sds.shape))
                out[f"{arch_id}/{shape}/{'multi' if multi else 'single'}"] = got
    return out


def main(path: str) -> None:
    np.savez(path + ".npz", **shards(make_mesh_from_shape(
        (2, 2, 2), ("pod", "data", "model"))))
    with open(path + ".json", "w") as f:
        json.dump(shard_shapes(), f)


if __name__ == "__main__":
    main(sys.argv[1])
