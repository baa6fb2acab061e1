"""The port's mesh tooling against the JAX reference, on the CPU.

``repro_torch`` runs on one card and shards nothing, but it keeps the
reference's logical axes and rules so that the dry-run
(``launch.dryrun``) can state each argument's bytes per device under the
production meshes. Held here against ``repro``:

- the logical axes of every parameter leaf of every arch (``init``'s
  axes; LM: ``transformer.param_axes``, with ``vmap_init``'s ``"layers"``
  prefix on the stacked leaves) and the parameter shapes on ``meta``, at
  the smoke configs;
- the LM ``cache_specs``;
- ``sharding.spec_for`` under both default rule sets and under every
  (arch, shape)'s ``cell_rules``, over every leaf's axes at the full
  configs, and ``check_divisibility`` of each full-config leaf: equal to
  ``tuple`` of the reference's ``PartitionSpec``. The reference is given
  a ``SimpleNamespace`` with the production meshes' ``axis_names`` and
  ``shape``: a test process cannot make their 256 or 512 devices;
- the five collective helpers against ``jax.vmap(..., axis_name="i")`` of
  the reference's helpers over P = 4 ranks on numpy trees drawn from a
  seed: the sums within 1e-6, ``all_gather_rows`` exactly.
"""
from __future__ import annotations

import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.distributed import collectives as rcoll
from repro.distributed import sharding as rshard
from repro.launch import cell as rcell
from repro.models.lm import transformer as rtf
from repro_torch.configs import registry as preg
from repro_torch.distributed import collectives as pcoll
from repro_torch.distributed import sharding as pshard
from repro_torch.launch import cell as pcell
from repro_torch.launch import mesh as pmesh
from repro_torch.launch.dryrun import leaves_with_axes
from repro_torch.models.lm import transformer as ptf
from _jax_release import release_jax_executables  # noqa: F401

ARCHS = tuple(rreg.ARCHS)
LM_ARCHS = tuple(a for a in ARCHS if rreg.get_arch(a).family == "lm")
CELLS = tuple((a, s) for a in ARCHS for s in rreg.get_arch(a).shapes)


def _ref_init(arch_id: str, cfg):
    """The reference's ``init(key, cfg, abstract=True)``: (shapes, axes)."""
    import importlib

    module = importlib.import_module(rreg.get_arch(arch_id).model_module)
    return module.init(jax.random.PRNGKey(0), cfg, abstract=True)


def _port_init(arch_id: str, cfg):
    """The port's (params, axes) on ``meta``."""
    arch = preg.get_arch(arch_id)
    if arch.family == "lm":
        return ptf.init(cfg, device="meta", with_axes=True)
    if arch.family == "recsys":
        from repro_torch.models.recsys import fm

        return fm.init(cfg, device="meta")
    return pcell._init(pcell._model(arch_id), cfg, 0, torch.device("meta"))


def _leaves(params, axes, path=""):
    """(path, leaf, axes) over a nested-dict tree and its axes tree."""
    for k in axes:
        if isinstance(axes[k], dict):
            yield from _leaves(params[k], axes[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", params[k], tuple(axes[k])


def _ns(mesh: pmesh.Mesh):
    """The reference's view of a production mesh (no devices)."""
    return types.SimpleNamespace(axis_names=mesh.axis_names,
                                 shape=dict(mesh.shape))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_param_axes_and_shapes_equal_the_reference(arch_id):
    rcfg = rreg.get_arch(arch_id).make_smoke_config()
    pcfg = preg.get_arch(arch_id).make_smoke_config()
    r_params, r_axes = _ref_init(arch_id, rcfg)
    p_params, p_axes = _port_init(arch_id, pcfg)
    want = {p: (tuple(leaf.shape), a)
            for p, leaf, a in _leaves(r_params, r_axes)}
    got = {p: (tuple(leaf.shape), a)
           for p, leaf, a in _leaves(p_params, p_axes)}
    assert got == want
    assert all(leaf.device.type == "meta"
               for _, leaf, _ in _leaves(p_params, p_axes))


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_cache_specs_equal_the_reference(arch_id):
    rcfg = rreg.get_arch(arch_id).make_config()
    pcfg = preg.get_arch(arch_id).make_config()
    want = {k: tuple(v) for k, v in rtf.cache_specs(rcfg).items()}
    assert ptf.cache_specs(pcfg) == want
    cache = ptf.init_cache(pcfg, 2, 64, device="meta")
    ref = jax.eval_shape(lambda: rtf.init_cache(rcfg, 2, 64))
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}


def test_production_meshes():
    single = pmesh.make_production_mesh()
    multi = pmesh.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    elastic = pmesh.make_mesh_from_shape((1, 16, 16),
                                         ("pod", "data", "model"))
    assert elastic.size == 256 and elastic.shape["pod"] == 1


def _full_axes(arch_id: str) -> list[tuple]:
    """Every leaf's axes at the full config (the port's, equal to the
    reference's by the test above), LM caches included."""
    pcfg = preg.get_arch(arch_id).make_config()
    params, axes = _port_init(arch_id, pcfg)
    out = [(tuple(leaf.shape), a) for _, leaf, a in _leaves(params, axes)]
    if preg.get_arch(arch_id).family == "lm":
        cache = ptf.init_cache(pcfg, 8, 256, device="meta")
        specs = ptf.cache_specs(pcfg)
        out += [(tuple(cache[k].shape), specs[k]) for k in cache]
    return out


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_spec_for_and_divisibility_under_the_default_rules(arch_id, multi):
    mesh = pmesh.make_production_mesh(multi_pod=multi)
    p_rules, r_rules = (pshard.default_rules(multi),
                        rshard.default_rules(multi))
    assert p_rules == r_rules
    for shape, axes in _full_axes(arch_id):
        got = pshard.spec_for(axes, p_rules, mesh)
        want = rshard.spec_for(axes, r_rules, _ns(mesh))
        assert got == tuple(want), (axes, got, want)
        assert pshard.check_divisibility(shape, got, mesh) == \
            rshard.check_divisibility(shape, want, _ns(mesh)), (shape, got)
    assert pshard.spec_for(("batch",), None, mesh) == ()


@pytest.mark.parametrize("arch_id,shape", CELLS)
def test_cell_rules_and_specs_equal_the_reference(arch_id, shape):
    for multi in (False, True):
        mesh = pmesh.make_production_mesh(multi_pod=multi)
        got = pcell.cell_rules(preg.get_arch(arch_id), shape, mesh)
        want = rcell.cell_rules(rreg.get_arch(arch_id), shape, _ns(mesh))
        assert got == want
        cell = pcell.build_cell(preg.get_arch(arch_id), shape, "meta")
        for t, axes in leaves_with_axes(cell["args"], cell["arg_axes"]):
            if axes is None:
                continue
            assert len(axes) == t.dim(), (t.shape, axes)
            p = pshard.spec_for(axes, got, mesh)
            r = rshard.spec_for(axes, want, _ns(mesh))
            assert p == tuple(r), (axes, p, r)


def test_use_rules_installs_and_restores():
    rules = pshard.default_rules(False)
    mesh = pmesh.make_production_mesh()
    assert pshard.current_rules() is None and pshard.current_mesh() is None
    with pshard.use_rules(rules, mesh):
        assert pshard.current_rules() is rules
        assert pshard.current_mesh() is mesh
        assert pshard.spec_for(("batch", "seq", "embed")) == \
            ("data", None, None)
        x = torch.ones(3)
        assert pshard.shard_activation(x, ("batch",)) is x
    assert pshard.current_rules() is None
    spec = pshard.spec_for(("embed_rows", "mlp"), rules, mesh)
    assert pshard.tree_specs({"a": {"w": ("embed_rows", "mlp")}},
                             rules, mesh) == {"a": {"w": spec}}
    assert pshard.per_device_shape((4096, 1000), spec, mesh) == (256, 63)


# ------------------------------------------------------------ collectives
P_RANKS = 4


def _trees(seed: int):
    """P ranks' trees of numpy float32 leaves (dim 0 divisible by P)."""
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((8, 3)).astype(np.float32),
             "b": {"v": rng.standard_normal((4,)).astype(np.float32)}}
            for _ in range(P_RANKS)]


def _stack(trees):
    return jax.tree.map(lambda *xs: np.stack(xs), *trees)


def _to_torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _rank(tree, r):
    return jax.tree.map(lambda a: np.asarray(a)[r], tree)


def _vmap(fn, stacked):
    return jax.vmap(fn, axis_name="i")(stacked)


def _close(got_list, want_stacked, exact=False):
    for r, got in enumerate(got_list):
        want = _rank(want_stacked, r)
        got = jax.tree.map(lambda t: t.numpy(), got)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            if exact:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["psum_tree", "pmean_tree",
                                  "reduce_scatter_tree", "deferred_scatter",
                                  "deferred_allreduce"])
def test_collective_helpers_equal_the_reference_under_vmap(name, seed):
    trees = _trees(seed)
    stacked = _stack(trees)
    ports = [_to_torch(t) for t in trees]
    if name.startswith("deferred"):
        scatter = name == "deferred_scatter"
        got = pcoll.deferred_grad_sync(ports, scatter=scatter)
        want = _vmap(lambda t: rcoll.deferred_grad_sync(t, "i", scatter),
                     stacked)
    else:
        got = getattr(pcoll, name)(ports)
        want = _vmap(lambda t: getattr(rcoll, name)(t, "i"), stacked)
    assert len(got) == P_RANKS
    _close(got, want)


@pytest.mark.parametrize("rows", [1, 5])
def test_all_gather_rows_equals_the_reference_exactly(rows):
    rng = np.random.default_rng(rows)
    xs = [rng.standard_normal((rows, 6)).astype(np.float32)
          for _ in range(P_RANKS)]
    got = pcoll.all_gather_rows([torch.from_numpy(x) for x in xs])
    want = _vmap(lambda x: rcoll.all_gather_rows(x, "i"), np.stack(xs))
    _close(got, want, exact=True)


def test_reduce_scatter_refuses_uneven_rows():
    ranks = [{"w": torch.ones(6, 2)} for _ in range(P_RANKS)]
    with pytest.raises(ValueError, match="multiple"):
        pcoll.reduce_scatter_tree(ranks)
    with pytest.raises(ValueError, match="no ranks"):
        pcoll.psum_tree([])
