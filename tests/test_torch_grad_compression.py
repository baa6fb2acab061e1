"""The port's gradient compression against the JAX reference, on the CPU.

int8 and top-k with error feedback are bit-equal to the reference's
functions on the same numpy-seeded gradients: the decompressed gradients
and the new error, over a few steps that carry the error, on a tree in
the SAGE layout and on one holding tuples and lists. The wire bytes and
the SAGE model's per-sync bytes are equal for every scheme.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compute as rcompute
from repro.train import grad_compression as rgc
from repro.train.cluster import default_grad_bytes as ref_default_bytes
from repro_torch.graph import datasets as pds
from repro_torch.train import cluster as pcluster
from repro_torch.train import compute as pcompute
from repro_torch.train import grad_compression as pgc
from _jax_release import release_jax_executables  # noqa: F401

SCHEMES = ("none", "int8", "topk")


def _sage_grads(rng, d_in=64, hidden=16, n_cls=41):
    """Gradients in the SAGE layout, each leaf at its own scale (a layer-0
    gradient is small, a bias larger), one bias row exactly zero."""
    dims = [(d_in, hidden), (hidden, n_cls)]
    tree = {}
    for i, (a, b) in enumerate(dims):
        scale = 10.0 ** rng.uniform(-5, 0)
        bias = rng.standard_normal(b).astype(np.float32)
        bias[: b // 4] = 0.0
        tree[f"layer_{i}"] = {
            "w_self": (rng.standard_normal((a, b)) * scale).astype(np.float32),
            "w_neigh": (rng.standard_normal((a, b)) * scale).astype(np.float32),
            "b": bias,
        }
    return tree


def _tuple_grads(rng):
    """A tree holding tuples and a list (``(w, b)`` layer parameters)."""
    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"enc": (arr(12, 7), arr(7)), "head": [arr(7, 3), (arr(3),)]}


TREES = {"sage": _sage_grads, "tuples": _tuple_grads}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [np.asarray(tree)]


def _port_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _port_leaves(t)]
    return [tree.numpy()]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree)


def _same_structure(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(
            _same_structure(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _same_structure(x, y) for x, y in zip(a, b))
    return torch.is_tensor(b)


def _bit_equal(ref_tree, port_tree):
    ra, pa = _leaves(ref_tree), _port_leaves(port_tree)
    assert len(ra) == len(pa)
    for r, p in zip(ra, pa):
        assert r.dtype == p.dtype and r.shape == p.shape
        assert r.tobytes() == p.tobytes()


def _compress(scheme, frac):
    if scheme == "int8":
        return rgc.compress_int8, pgc.compress_int8
    return (lambda g, e: rgc.compress_topk(g, e, frac),
            lambda g, e: pgc.compress_topk(g, e, frac))


@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("scheme,frac", [("int8", None), ("topk", 0.05),
                                         ("topk", 0.25)])
def test_compress_bit_equal_over_steps(scheme, frac, tree):
    """Three steps, each compressing fresh gradients plus the carried
    error: the decompressed gradients and the new error bit-equal."""
    rng = np.random.default_rng(3)
    ref_fn, port_fn = _compress(scheme, frac)
    r_err = _map(lambda a: jnp.zeros(a.shape, jnp.float32),
                 TREES[tree](np.random.default_rng(0)))
    p_err = pgc.init_error_feedback(
        _map(torch.tensor, TREES[tree](np.random.default_rng(0))))
    for _ in range(3):
        g = TREES[tree](rng)
        r_deq, r_err = ref_fn(_map(jnp.asarray, g), r_err)
        p_deq, p_err = port_fn(_map(torch.tensor, g), p_err)
        assert _same_structure(_map(torch.tensor, g), p_deq)
        assert _same_structure(_map(torch.tensor, g), p_err)
        _bit_equal(r_deq, p_deq)
        _bit_equal(r_err, p_err)


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_decompressed_plus_error_is_the_input(scheme):
    """``deq + err == g + e``, exactly: top-k splits each entry, and the
    int8 residual ``g - deq`` is exact (deq within a factor 2 of g)."""
    rng = np.random.default_rng(5)
    _, port_fn = _compress(scheme, 0.05)
    g = _map(torch.tensor, _sage_grads(rng))
    e = _map(lambda a: torch.tensor(a) * 1e-3, _sage_grads(rng))
    deq, err = port_fn(g, e)
    for gi, ei, di, ri in zip(_port_leaves(g), _port_leaves(e),
                              _port_leaves(deq), _port_leaves(err)):
        np.testing.assert_array_equal(di + ri, gi + ei)


def test_int8_rounds_half_to_even():
    """At scale 1 (max |g| = 127) the quotients are the inputs, and the
    halves round to the even integer, as ``jnp.round`` does."""
    g = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 127.0, 3.25],
                 np.float32)
    rq, rs = rgc.quantize_int8(jnp.asarray(g))
    pq, ps = pgc.quantize_int8(torch.tensor(g))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    assert pq.dtype == torch.int8
    assert ps.item() == float(rs)
    np.testing.assert_array_equal(pq.numpy(), [0, 2, 2, 0, -2, 126, 127, 3])


@pytest.mark.parametrize("frac", [0.05, 0.25])
def test_topk_keeps_k_entries(frac):
    g = {"a": torch.tensor(np.random.default_rng(1).standard_normal(
        (64, 32)).astype(np.float32))}
    kept, _ = pgc.compress_topk(g, pgc.init_error_feedback(g), frac)
    assert int((kept["a"] != 0).sum()) == max(int(frac * 64 * 32), 1)


@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_wire_bytes_equal(scheme, tree):
    g = TREES[tree](np.random.default_rng(2))
    for frac in (0.05, 0.25):
        assert pgc.wire_bytes(_map(torch.tensor, g), scheme, frac) \
            == rgc.wire_bytes(_map(jnp.asarray, g), scheme, frac)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("dataset", ["reddit", "ooc_community",
                                     "full_graph_sm"])
def test_model_wire_bytes_equal(dataset, scheme):
    """The SAGE model's per-sync bytes under each scheme; ``"none"`` is
    the cluster's default gradient payload."""
    graph = pds.materialize(dataset, seed=0)
    port = pcompute.model_wire_bytes(graph, scheme, 0.05)
    assert port == rcompute.model_wire_bytes(graph, scheme, 0.05)
    if scheme == "none":
        assert port == pcluster.default_grad_bytes(graph) \
            == ref_default_bytes(graph)


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_error_feedback_converges(scheme):
    """Summed (compressed) gradients over many steps converge to the
    summed true gradients: the error carries what was dropped."""
    rng = np.random.default_rng(0)
    g = {"a": torch.tensor(rng.standard_normal((64, 32)).astype(np.float32)),
         "b": torch.tensor(rng.standard_normal(128).astype(np.float32))}
    _, port_fn = _compress(scheme, 0.1)
    e = pgc.init_error_feedback(g)
    sent = {k: torch.zeros_like(v) for k, v in g.items()}
    n = 50
    for _ in range(n):
        deq, e = port_fn(g, e)
        sent = {k: sent[k] + deq[k] for k in g}
    for k in g:
        rel = float(torch.linalg.norm(sent[k] - g[k] * n)
                    / torch.linalg.norm(g[k] * n))
        assert rel < 0.2, (k, rel)


def test_unknown_scheme_raises():
    g = {"a": torch.ones(3)}
    with pytest.raises(ValueError):
        pgc.check_scheme("zfp")
    with pytest.raises(ValueError):
        pgc.wire_bytes(g, "zfp")
    with pytest.raises(ValueError):
        rgc.wire_bytes({"a": jnp.ones(3)}, "zfp")
    for scheme in SCHEMES:
        pgc.check_scheme(scheme)
