"""The port's GNN zoo (PNA, GatedGCN, NequIP, MACE and the irreps algebra)
against the JAX reference, on the CPU.

The same numpy inputs go through ``repro.models.gnn`` and
``repro_torch.models.gnn``, with the reference's parameters carried across
(``convert.gnn_params_from_jax``): every ``common`` function with and
without an edge mask (empty and fully masked segments, tied maxima), each
irreps function, each model's output and its gradient with respect to
every parameter, and one ``launch.cell`` train step of each arch against
the reference's ``step_fn`` on the same materialized inputs (smoke
configs). The CG tensors, ``_real_to_complex`` and ``tp_paths`` are
bit-equal (a copy of the reference's numpy). Tolerances, float32 in both
packages: ``OP`` for one op, ``MODEL`` for a model's output; a gradient
leaf is held to ``GRADS``: max |port - reference| within ``rel`` of the
leaf's largest |reference| plus ``abs`` (sums in another order, through
up to 3 layers). PNA's gradients are held to ``GRADS_PNA``: its std
aggregator multiplies rounding by up to 1 / (2 sqrt(1e-5)) = 158: in the
masked case both packages' float32 gradients of ``layer_1/w_msg_src`` lie
1.5e-4 of the leaf's largest from the port's float64 one. A gradient the
port leaves unset (a parameter the output does not reach, as the last
GatedGCN layer's edge update) is held as zeros, as JAX gives it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gatedgcn as rcfg_gatedgcn
from repro.configs import mace as rcfg_mace
from repro.configs import nequip as rcfg_nequip
from repro.configs import pna as rcfg_pna
from repro.configs import registry as rreg
from repro.graph.synthetic import molecule_batch, power_law_graph
from repro.models.gnn import common as rcommon
from repro.models.gnn import gatedgcn as rgatedgcn
from repro.models.gnn import irreps as rirreps
from repro.models.gnn import mace as rmace
from repro.models.gnn import nequip as rnequip
from repro.models.gnn import pna as rpna
from repro_torch import convert
from repro_torch.configs import gatedgcn as pcfg_gatedgcn
from repro_torch.configs import mace as pcfg_mace
from repro_torch.configs import nequip as pcfg_nequip
from repro_torch.configs import pna as pcfg_pna
from repro_torch.configs import registry as preg
from repro_torch.launch import cell as pcell
from repro_torch.models.gnn import common as pcommon
from repro_torch.models.gnn import gatedgcn as pgatedgcn
from repro_torch.models.gnn import irreps as pirreps
from repro_torch.models.gnn import mace as pmace
from repro_torch.models.gnn import nequip as pnequip
from repro_torch.models.gnn import pna as ppna
from _jax_release import release_jax_executables  # noqa: F401

OP = dict(rtol=1e-5, atol=1e-6)
MODEL = dict(rtol=1e-4, atol=1e-5)
GRADS = dict(rel=2e-5, abs=1e-6)
GRADS_PNA = dict(rel=5e-4, abs=1e-6)
CONFIGS = {"pna": (pcfg_pna, rcfg_pna),
           "gatedgcn": (pcfg_gatedgcn, rcfg_gatedgcn),
           "nequip": (pcfg_nequip, rcfg_nequip),
           "mace": (pcfg_mace, rcfg_mace)}
MODELS = {"pna": (ppna, rpna), "gatedgcn": (pgatedgcn, rgatedgcn),
          "nequip": (pnequip, rnequip), "mace": (pmace, rmace)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's thread pool only adds wake-up latency."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol, what=""):
    want = _np(want)
    got = np.zeros_like(want) if got is None else _np(got)
    if "rel" in tol:
        err = float(np.max(np.abs(got - want), initial=0.0))
        bound = tol["rel"] * float(np.max(np.abs(want), initial=0.0))
        assert err <= bound + tol["abs"], (what, err, bound)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _tree_close(got, want, tol, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _tree_close(got[k], want[k], tol, f"{path}/{k}")
        else:
            _close(got[k], want[k], tol, f"{path}/{k}")


def _vjp_both(pfn, rfn, p_args, r_args, seed=0):
    """Outputs and gradients of ``sum(out * cot)`` (a fixed random
    cotangent) with respect to every float argument, in both packages;
    ``*_args`` are lists whose float entries are differentiated."""
    r_out, r_vjp = jax.vjp(rfn, *r_args)
    cot = np.random.default_rng(seed).standard_normal(
        np.shape(r_out)).astype(np.float32)
    r_grads = r_vjp(jnp.asarray(cot))
    leaves = [a.detach().clone().requires_grad_(a.is_floating_point())
              if isinstance(a, torch.Tensor) else a for a in p_args]
    p_out = pfn(*leaves)
    diff = [a for a in leaves
            if isinstance(a, torch.Tensor) and a.requires_grad]
    p_grads = (torch.autograd.grad((p_out * torch.from_numpy(cot)).sum(),
                                   diff, allow_unused=True)
               if p_out.requires_grad else [None] * len(diff))
    r_float = [g for a, g in zip(p_args, r_grads)
               if isinstance(a, torch.Tensor) and a.is_floating_point()]
    return p_out, r_out, p_grads, r_float


# ---------------------------------------------------------------- numpy CG
@pytest.mark.parametrize("l1,l2,l3", [(a, b, c) for a in range(3)
                                      for b in range(3) for c in range(3)])
def test_clebsch_gordan_bit_equal(l1, l2, l3):
    got = pirreps.clebsch_gordan(l1, l2, l3)
    want = rirreps.clebsch_gordan(l1, l2, l3)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    dev = pirreps.cg_tensor(l1, l2, l3, torch.device("cpu"))
    assert np.array_equal(dev.numpy(), np.asarray(want, np.float32))
    assert dev is pirreps.cg_tensor(l1, l2, l3, torch.device("cpu"))


@pytest.mark.parametrize("l", [0, 1, 2])
def test_real_to_complex_bit_equal(l):
    assert np.array_equal(pirreps._real_to_complex(l),
                          rirreps._real_to_complex(l))


@pytest.mark.parametrize("l_in,l_sh,l_max", [([0, 1, 2], [0, 1, 2], 2),
                                             ([0], [0, 1, 2], 2),
                                             ([0, 1], [0, 1], 1)])
def test_tp_paths_equal(l_in, l_sh, l_max):
    assert pirreps.tp_paths(l_in, l_sh, l_max) == rirreps.tp_paths(
        l_in, l_sh, l_max)


# ---------------------------------------------------------------- common
def _segment_case(seed=0, e=60, n=12, d=5, ties=True):
    """Messages with tied maxima (rows repeated to one destination), nodes
    9-11 with no edge and node 8 reached only by masked edges."""
    rng = np.random.default_rng(seed)
    msgs = rng.standard_normal((e, d)).astype(np.float32)
    dst = rng.integers(0, 8, e)
    if ties:
        msgs[1] = msgs[0]
        dst[1] = dst[0]
        msgs[3, -1] = msgs[2, -1]
        dst[3] = dst[2]
    dst[-4:] = 8
    mask = rng.random(e) < 0.8
    mask[-4:] = False
    mask[:4] = True
    return msgs, dst, mask, n


SEGMENT_FNS = ["scatter_sum", "scatter_mean", "scatter_max", "scatter_min",
               "scatter_std"]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", SEGMENT_FNS)
def test_segment_ops_and_gradients(name, masked):
    msgs, dst, mask, n = _segment_case()
    m = mask if masked else None

    def pfn(x):
        return getattr(pcommon, name)(
            x, torch.from_numpy(dst), n,
            None if m is None else torch.from_numpy(m))

    def rfn(x):
        return getattr(rcommon, name)(
            x, jnp.asarray(dst), n, None if m is None else jnp.asarray(m))

    p_out, r_out, pg, rg = _vjp_both(pfn, rfn, [torch.from_numpy(msgs)],
                                     [jnp.asarray(msgs)])
    _close(p_out, r_out, OP)
    _close(pg[0], rg[0], OP)
    empty = _np(p_out)[9:] if not masked else _np(p_out)[8:]
    want = np.sqrt(np.float32(1e-5)) if name == "scatter_std" else 0.0
    np.testing.assert_allclose(empty, want, rtol=1e-6)


@pytest.mark.parametrize("name", ["scatter_max", "scatter_min"])
def test_tied_maxima_split_the_gradient(name):
    """Four equal messages into one node: each gets a quarter of the
    tangent, as in JAX."""
    msgs = np.array([[1.0], [1.0], [1.0], [1.0], [0.5]], np.float32)
    dst = np.array([0, 0, 0, 0, 1])
    if name == "scatter_min":
        msgs = -msgs
    x = torch.from_numpy(msgs).requires_grad_(True)
    getattr(pcommon, name)(x, torch.from_numpy(dst), 2).sum().backward()
    want = jax.grad(lambda v: getattr(rcommon, name)(
        v, jnp.asarray(dst), 2).sum())(jnp.asarray(msgs))
    _close(x.grad, want, OP)
    np.testing.assert_allclose(_np(x.grad)[:4, 0], 0.25)


@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax(masked):
    msgs, dst, mask, n = _segment_case(seed=1, d=1)
    scores = msgs[:, 0]
    m = mask if masked else None

    def pfn(s):
        return pcommon.segment_softmax(
            s, torch.from_numpy(dst), n,
            None if m is None else torch.from_numpy(m))

    def rfn(s):
        return rcommon.segment_softmax(
            s, jnp.asarray(dst), n, None if m is None else jnp.asarray(m))

    p_out, r_out, pg, rg = _vjp_both(pfn, rfn, [torch.from_numpy(scores)],
                                     [jnp.asarray(scores)])
    _close(p_out, r_out, OP)
    _close(pg[0], rg[0], OP)


@pytest.mark.parametrize("masked", [False, True])
def test_in_degrees_float32(masked):
    _, dst, mask, n = _segment_case()
    m = mask if masked else None
    got = pcommon.in_degrees(torch.from_numpy(dst.astype(np.int32)), n,
                             None if m is None else torch.from_numpy(m))
    want = rcommon.in_degrees(jnp.asarray(dst), n,
                              None if m is None else jnp.asarray(m))
    assert got.dtype == torch.float32
    assert np.array_equal(_np(got), np.asarray(want))


def test_layer_norm():
    rng = np.random.default_rng(2)
    x, g, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((7, 6), (6,), (6,)))
    p_out, r_out, pg, rg = _vjp_both(
        pcommon.layer_norm, rcommon.layer_norm,
        [torch.from_numpy(a) for a in (x, g, b)],
        [jnp.asarray(a) for a in (x, g, b)])
    _close(p_out, r_out, OP)
    for a, b_ in zip(pg, rg):
        _close(a, b_, OP)


# ---------------------------------------------------------------- irreps
def _feats(rng, n, mul, l_max=2):
    return {l: rng.standard_normal((n, mul, 2 * l + 1)).astype(np.float32)
            for l in range(l_max + 1)}


@pytest.mark.parametrize("l_max", [0, 1, 2])
def test_spherical_harmonics(l_max):
    vec = np.random.default_rng(3).standard_normal((11, 3)).astype(
        np.float32)
    got = pirreps.spherical_harmonics(torch.from_numpy(vec), l_max)
    want = rirreps.spherical_harmonics(jnp.asarray(vec), l_max)
    _tree_close(got, want, OP)
    for l in range(l_max + 1):
        p_out, r_out, pg, rg = _vjp_both(
            lambda v: pirreps.spherical_harmonics(v, l_max)[l],
            lambda v: rirreps.spherical_harmonics(v, l_max)[l],
            [torch.from_numpy(vec)], [jnp.asarray(vec)], seed=l)
        _close(pg[0], rg[0], OP)


def test_irreps_linear_gate_and_norm():
    rng = np.random.default_rng(4)
    f = _feats(rng, 6, 4)
    w = {str(l): rng.standard_normal((4, 4)).astype(np.float32)
         for l in range(3)}
    gates = rng.standard_normal((6, 8)).astype(np.float32)
    pf = {l: torch.from_numpy(a) for l, a in f.items()}
    rf = {l: jnp.asarray(a) for l, a in f.items()}
    _tree_close(
        pirreps.irreps_linear({k: torch.from_numpy(v) for k, v in w.items()},
                              pf),
        rirreps.irreps_linear({k: jnp.asarray(v) for k, v in w.items()}, rf),
        OP)
    _tree_close(pirreps.irreps_gate(pf, torch.from_numpy(gates)),
                rirreps.irreps_gate(rf, jnp.asarray(gates)), OP)
    _close(pirreps.irreps_norm_sq(pf), rirreps.irreps_norm_sq(rf), OP)


def test_tensor_product_and_gradients():
    rng = np.random.default_rng(5)
    e, mul = 9, 3
    f = _feats(rng, e, mul)
    sh = {l: rng.standard_normal((e, 2 * l + 1)).astype(np.float32)
          for l in range(3)}
    paths = rirreps.tp_paths([0, 1, 2], [0, 1, 2], 2)
    w = {p: rng.standard_normal((e, mul)).astype(np.float32) for p in paths}
    keys = [("f", l) for l in f] + [("sh", l) for l in sh] + [
        ("w", p) for p in paths]
    arrays = [{"f": f, "sh": sh, "w": w}[k][i] for k, i in keys]

    def unpack(args):
        d = {"f": {}, "sh": {}, "w": {}}
        for (k, i), a in zip(keys, args):
            d[k][i] = a
        return d

    for l3 in range(3):
        def pfn(*args, l3=l3):
            d = unpack(args)
            return pirreps.tensor_product(d["f"], d["sh"], d["w"], 2)[l3]

        def rfn(*args, l3=l3):
            d = unpack(args)
            return rirreps.tensor_product(d["f"], d["sh"], d["w"], 2)[l3]

        p_out, r_out, pg, rg = _vjp_both(
            pfn, rfn, [torch.from_numpy(a) for a in arrays],
            [jnp.asarray(a) for a in arrays], seed=l3)
        _close(p_out, r_out, OP)
        for a, b in zip(pg, rg):
            _close(a, b, OP)


def test_bessel_basis_and_cosine_cutoff():
    r = np.array([0.0, 1e-12, 0.3, 1.7, 4.99, 5.0, 6.5], np.float32)
    for pfn, rfn in [
        (lambda x: pirreps.bessel_basis(x, 8, 5.0),
         lambda x: rirreps.bessel_basis(x, 8, 5.0)),
        (lambda x: pirreps.cosine_cutoff(x, 5.0),
         lambda x: rirreps.cosine_cutoff(x, 5.0)),
    ]:
        p_out, r_out, pg, rg = _vjp_both(pfn, rfn, [torch.from_numpy(r)],
                                         [jnp.asarray(r)])
        _close(p_out, r_out, OP)
        _close(pg[0], rg[0], dict(rtol=1e-5, atol=1e-4))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk", [0, 8, 16])
def test_aggregate_tp_messages(chunk, masked):
    """Chunked (a loop of checkpointed blocks) against the reference's
    scan, and unchunked, with the radial MLP's weights differentiated."""
    rng = np.random.default_rng(6)
    n, e, mul, n_rbf = 10, 32, 3, 4
    h = _feats(rng, n, mul)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    vec = rng.standard_normal((e, 3)).astype(np.float32)
    rbf = rng.standard_normal((e, n_rbf)).astype(np.float32)
    mask = rng.random(e) < 0.7
    paths = rirreps.tp_paths([0, 1, 2], [0, 1, 2], 2)
    w_rad = rng.standard_normal((n_rbf, len(paths) * mul)).astype(np.float32)
    m = mask if masked else None

    def pfn(h0, h1, h2, w):
        sh = pirreps.spherical_harmonics(torch.from_numpy(vec), 2)
        agg = pirreps.aggregate_tp_messages(
            {0: h0, 1: h1, 2: h2}, torch.from_numpy(src),
            torch.from_numpy(dst), sh, torch.from_numpy(rbf),
            lambda b: (b @ w).reshape(b.shape[0], len(paths), mul), paths,
            2, n, mul, None if m is None else torch.from_numpy(m), chunk)
        return torch.cat([agg[l].reshape(n, -1) for l in range(3)], -1)

    def rfn(h0, h1, h2, w):
        sh = rirreps.spherical_harmonics(jnp.asarray(vec), 2)
        agg = rirreps.aggregate_tp_messages(
            {0: h0, 1: h1, 2: h2}, jnp.asarray(src), jnp.asarray(dst), sh,
            jnp.asarray(rbf),
            lambda b: (b @ w).reshape(b.shape[0], len(paths), mul), paths,
            2, n, mul, None if m is None else jnp.asarray(m), chunk)
        return jnp.concatenate([agg[l].reshape(n, -1) for l in range(3)], -1)

    arrays = [h[0], h[1], h[2], w_rad]
    p_out, r_out, pg, rg = _vjp_both(
        pfn, rfn, [torch.from_numpy(a) for a in arrays],
        [jnp.asarray(a) for a in arrays])
    _close(p_out, r_out, MODEL)
    for a, b in zip(pg, rg):
        _close(a, b, GRADS)


def test_aggregate_tp_messages_refuses_a_ragged_chunk():
    rng = np.random.default_rng(7)
    h = {l: torch.from_numpy(a) for l, a in _feats(rng, 4, 2).items()}
    ei = torch.zeros(10, dtype=torch.long)
    sh = pirreps.spherical_harmonics(torch.ones(10, 3), 2)
    with pytest.raises(AssertionError):
        pirreps.aggregate_tp_messages(
            h, ei, ei, sh, torch.ones(10, 2),
            lambda b: torch.ones(b.shape[0], 15, 2),
            pirreps.tp_paths([0, 1, 2], [0, 1, 2], 2), 2, 4, 2, None, 4)


# ---------------------------------------------------------------- models
@pytest.fixture(scope="module")
def graph():
    return power_law_graph(200, avg_degree=5, n_feat=16, n_classes=5, seed=0)


@pytest.fixture(scope="module")
def mols():
    return molecule_batch(n_mols=4, n_atoms=8, n_edges_per_mol=24, seed=0)


def _carry(arch, cfg_p, cfg_r, seed=0):
    """The reference's parameters at ``cfg_r`` and the same values as the
    port's tensors."""
    r_params, _ = MODELS[arch][1].init(jax.random.PRNGKey(seed), cfg_r)
    return (convert.gnn_params_from_jax(jax.tree.map(np.asarray, r_params)),
            r_params)


def _model_vs_reference(arch, p_apply, r_apply, cfg_p, cfg_r,
                        grads_tol=GRADS):
    """Output and every parameter's gradient of ``sum(out * cot)``; the
    reference's under one ``jax.jit`` (faster here than op by op)."""
    p_params, r_params = _carry(arch, cfg_p, cfg_r)
    cot = np.random.default_rng(1).standard_normal(
        jax.eval_shape(r_apply, r_params).shape).astype(np.float32)

    def r_loss(p):
        out = r_apply(p)
        return jnp.sum(out * cot), out

    (_, r_out), r_grads = jax.jit(jax.value_and_grad(r_loss, has_aux=True))(
        r_params)
    leaves = jax.tree_util.tree_leaves(p_params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    p_out = p_apply(p_params)
    (p_out * torch.from_numpy(cot)).sum().backward()
    _close(p_out, r_out, MODEL)
    p_grads = jax.tree.map(lambda t: t.grad, p_params)
    _tree_close(p_grads, r_grads, grads_tol)


@pytest.mark.parametrize("masked", [False, True])
def test_pna(graph, masked):
    cfg_p = ppna.PNAConfig(d_in=16, d_hidden=12, n_classes=5, n_layers=2)
    cfg_r = rpna.PNAConfig(d_in=16, d_hidden=12, n_classes=5, n_layers=2)
    mask = np.random.default_rng(2).random(graph.edge_index.shape[1]) < 0.8
    m = mask if masked else None
    _model_vs_reference(
        "pna",
        lambda p: ppna.apply_full(
            p, cfg_p, torch.from_numpy(graph.features),
            torch.from_numpy(graph.edge_index),
            None if m is None else torch.from_numpy(m)),
        lambda p: rpna.apply_full(
            p, cfg_r, jnp.asarray(graph.features),
            jnp.asarray(graph.edge_index),
            None if m is None else jnp.asarray(m)),
        cfg_p, cfg_r, GRADS_PNA)


@pytest.mark.parametrize("variant", ["plain", "masked", "edge_feat"])
def test_gatedgcn(graph, variant):
    d_e = 3 if variant == "edge_feat" else 0
    cfg_p = pgatedgcn.GatedGCNConfig(d_in=16, d_hidden=10, n_classes=5,
                                     n_layers=3, d_edge_in=d_e)
    cfg_r = rgatedgcn.GatedGCNConfig(d_in=16, d_hidden=10, n_classes=5,
                                     n_layers=3, d_edge_in=d_e)
    rng = np.random.default_rng(3)
    e = graph.edge_index.shape[1]
    mask = rng.random(e) < 0.8 if variant == "masked" else None
    feat = (rng.standard_normal((e, 3)).astype(np.float32)
            if variant == "edge_feat" else None)
    _model_vs_reference(
        "gatedgcn",
        lambda p: pgatedgcn.apply_full(
            p, cfg_p, torch.from_numpy(graph.features),
            torch.from_numpy(graph.edge_index),
            None if feat is None else torch.from_numpy(feat),
            None if mask is None else torch.from_numpy(mask)),
        lambda p: rgatedgcn.apply_full(
            p, cfg_r, jnp.asarray(graph.features),
            jnp.asarray(graph.edge_index),
            None if feat is None else jnp.asarray(feat),
            None if mask is None else jnp.asarray(mask)),
        cfg_p, cfg_r)


GEOMETRIC_VARIANTS = ["graph_id", "summed", "chunked"]


@pytest.mark.parametrize("variant", GEOMETRIC_VARIANTS)
@pytest.mark.parametrize("arch", ["nequip", "mace"])
def test_geometric(mols, arch, variant):
    """Energies per molecule (``graph_id``), summed over all atoms, and
    per molecule with 4 edge chunks of 24."""
    pmod, rmod = MODELS[arch]
    chunk = 24 if variant == "chunked" else 0
    kw = dict(d_hidden=6, n_layers=2, n_rbf=4, edge_chunk=chunk)
    cfg_p = (pnequip.NequIPConfig if arch == "nequip"
             else pmace.MACEConfig)(**kw)
    cfg_r = (rnequip.NequIPConfig if arch == "nequip"
             else rmace.MACEConfig)(**kw)
    gid = None if variant == "summed" else mols["graph_id"]
    n_g = mols["n_mols"]
    _model_vs_reference(
        arch,
        lambda p: pmod.apply(
            p, cfg_p, torch.from_numpy(mols["species"]),
            torch.from_numpy(mols["positions"]),
            torch.from_numpy(mols["edge_index"]),
            torch.from_numpy(mols["edge_mask"]),
            None if gid is None else torch.from_numpy(gid), n_g),
        lambda p: rmod.apply(
            p, cfg_r, jnp.asarray(mols["species"]),
            jnp.asarray(mols["positions"]), jnp.asarray(mols["edge_index"]),
            jnp.asarray(mols["edge_mask"]),
            None if gid is None else jnp.asarray(gid), n_g),
        cfg_p, cfg_r)


def test_mace_unweighted_tp():
    rng = np.random.default_rng(8)
    a, b = _feats(rng, 5, 3), _feats(rng, 5, 3)
    got = pmace._unweighted_tp(
        {l: torch.from_numpy(v) for l, v in a.items()},
        {l: torch.from_numpy(v) for l, v in b.items()}, 2)
    want = rmace._unweighted_tp({l: jnp.asarray(v) for l, v in a.items()},
                                {l: jnp.asarray(v) for l, v in b.items()}, 2)
    _tree_close(got, want, OP)


# ---------------------------------------------------------------- init
def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", list(MODELS))
def test_smoke_init_tree_shapes_and_axes(arch):
    port, ref = CONFIGS[arch]
    pmod, rmod = MODELS[arch]
    p_params, p_axes = pmod.init(port.make_smoke_config(), seed=3,
                                 device="cpu")
    r_params, r_axes = rmod.init(jax.random.PRNGKey(0),
                                 ref.make_smoke_config())
    assert _shapes(p_params) == _shapes(r_params)
    assert p_axes == r_axes
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in jax.tree_util.tree_leaves(p_params))


@pytest.mark.parametrize("arch", list(MODELS))
def test_full_config_shapes_without_drawing(arch):
    port, ref = CONFIGS[arch]
    pmod, rmod = MODELS[arch]
    p_params, p_axes = pmod.init(port.make_config(), device="meta")
    r_params, r_axes = rmod.init(jax.random.PRNGKey(0), ref.make_config(),
                                 abstract=True)
    assert _shapes(p_params) == _shapes(r_params)
    assert p_axes == r_axes
    assert all(t.device.type == "meta"
               for t in jax.tree_util.tree_leaves(p_params))


def test_init_is_seeded_and_refuses_a_missing_card():
    cfg = pcfg_pna.make_smoke_config()
    a, _ = ppna.init(cfg, seed=5, device="cpu")
    b, _ = ppna.init(cfg, seed=5, device="cpu")
    c, _ = ppna.init(cfg, seed=6, device="cpu")
    assert torch.equal(a["w_in"], b["w_in"])
    assert not torch.equal(a["w_in"], c["w_in"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ppna.init(cfg)


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("make", ["make_config", "make_smoke_config"])
@pytest.mark.parametrize("arch", list(CONFIGS))
def test_configs_match_the_reference(arch, make):
    port, ref = CONFIGS[arch]
    assert dataclasses.asdict(getattr(port, make)()) == dataclasses.asdict(
        getattr(ref, make)())


@pytest.mark.parametrize("arch_id", list(rreg._MODULES))
def test_registry_resolves_every_reference_arch(arch_id):
    got, want = preg.get_arch(arch_id), rreg.get_arch(arch_id)
    assert got.arch_id == want.arch_id and got.family == want.family
    assert got.shapes == want.shapes
    assert got.model_module == want.model_module.replace(
        "repro.", "repro_torch.", 1)


# ---------------------------------------------------------------- cells
def _smoke_arch(arch_def, smoke):
    """``arch_def`` with its full config replaced by ``smoke`` (keeping
    the cell's ``d_in`` or ``edge_chunk``)."""
    def make_config(d_in=None, n_classes=None, edge_chunk=None):
        kw = {k: v for k, v in (("d_in", d_in), ("edge_chunk", edge_chunk))
              if v is not None}
        return dataclasses.replace(smoke, **kw)

    return dataclasses.replace(arch_def, make_config=make_config)


def _reference_step(arch_def_r, shape, args_np):
    from repro.launch.cell import build_gnn_cell
    from repro.launch.mesh import make_mesh_from_shape
    from repro.optim.optimizers import OptState

    mesh = make_mesh_from_shape((1, 1), ("data", "model"))
    cell = build_gnn_cell(arch_def_r, shape, mesh)
    params = args_np[0]
    zeros = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), params)
    opt = OptState(step=jnp.zeros((), jnp.int32), mu=zeros,
                   nu=jax.tree.map(jnp.copy, zeros))
    inputs = [jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
              for a in args_np[1:]]
    for got, want in zip(inputs, cell["args"][2:]):
        assert got.shape == want.shape, (got.shape, want.shape)
    return jax.jit(cell["step_fn"])(params, opt, *inputs)


@pytest.mark.parametrize("arch,shape", [("pna", "full_graph_sm"),
                                        ("gatedgcn", "molecule"),
                                        ("nequip", "molecule"),
                                        ("mace", "full_graph_sm")])
def test_cell_step_against_the_reference(arch, shape):
    port, ref = CONFIGS[arch]
    arch_p = _smoke_arch(port.ARCH, port.make_smoke_config())
    arch_r = _smoke_arch(ref.ARCH, ref.make_smoke_config())
    cell = pcell.build_gnn_cell(arch_p, shape, device="cpu", seed=0)
    params, opt_state, *inputs = cell["args"]
    args_np = [convert.gnn_params_to_jax(params)] + [_np(t) for t in inputs]
    r_params, r_opt, r_loss = _reference_step(arch_r, shape, args_np)
    new_params, new_opt, loss = cell["step_fn"](params, opt_state, *inputs)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5)
    grads_tol = dict(GRADS_PNA if arch == "pna" else GRADS, abs=0.0)
    _tree_close(new_opt.mu, r_opt.mu, grads_tol)     # 0.1 x clipped grads
    _adam_step_close(new_params, r_params, r_opt.mu)
    assert new_opt.step == int(r_opt.step) == 1
    assert cell["meta"]["n_edges"] % pcell.EDGE_PAD == 0


def _adam_step_close(got, want, mu, lr=3e-3, path=""):
    """New parameters after AdamW's first step, which moves an element by
    about lr * sign(g): equal (rtol 1e-5, atol 1e-6) wherever |mu| is at
    least 1e-3 of its leaf's largest; where the gradient is smaller the
    step's direction is float32 rounding, and only its size (<= lr) is
    held."""
    for k in want:
        if isinstance(want[k], dict):
            _adam_step_close(got[k], want[k], mu[k], lr, f"{path}/{k}")
            continue
        g, w, m = _np(got[k]), np.asarray(want[k]), np.abs(np.asarray(mu[k]))
        big = m >= 1e-3 * m.max(initial=0.0)
        np.testing.assert_allclose(g[big], w[big], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{path}/{k}")
        assert np.all(np.abs(g - w) <= 2 * lr + 1e-6), f"{path}/{k}"


@pytest.mark.parametrize("arch,shape,want", [
    ("pna", "minibatch_lg", (180_224, 179_200, 602, 0)),
    ("nequip", "minibatch_lg", (180_224, 179_200, 602, 0)),
    ("mace", "ogb_products", (2_449_029, 61_865_984, 100, 524_288)),
    ("gatedgcn", "ogb_products", (2_449_029, 61_859_328, 100, 0)),
    ("pna", "full_graph_sm", (2_708, 10_752, 1_433, 0)),
    ("mace", "molecule", (3_840, 8_192, 16, 0)),
])
def test_graph_arrays_at_one_device(arch, shape, want):
    from repro.configs.shapes import GNN_SHAPES as R_SHAPES
    from repro.launch.cell import _gnn_graph_arrays
    from repro.launch.mesh import make_mesh_from_shape

    got = pcell._gnn_graph_arrays(preg.get_arch(arch),
                                  pcell.GNN_SHAPES[shape])
    mesh = make_mesh_from_shape((1, 1), ("data", "model"))
    assert got == want == _gnn_graph_arrays(rreg.get_arch(arch),
                                            R_SHAPES[shape], mesh)
