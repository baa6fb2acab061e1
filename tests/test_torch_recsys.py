"""The port's FM recommender and its embedding bags against the JAX
reference, on the CPU.

The same numpy inputs go through ``repro.models.recsys`` and
``repro_torch.models.recsys``, with the reference's parameters carried
across (``convert.fm_params_from_jax``): ``embedding_bag`` in its three
modes, with and without per-lookup weights and with empty bags (values
and the table's gradient); ``lookup_fields``; FM's ``scores``,
``bce_loss`` and its gradient, ``retrieval_scores``; one
``launch.cell.build_fm_cell`` step of every FM shape against the
reference's ``step_fn`` at the smoke config. ``field_offsets`` and the
vocabularies are bit-equal. Tolerances, float32 in both packages: ``OP``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import fm as rcfg
from repro.models.recsys import embedding as remb
from repro.models.recsys import fm as rfm
from repro_torch import convert
from repro_torch.configs import fm as pcfg
from repro_torch.launch import cell as pcell
from repro_torch.models.recsys import embedding as pemb
from repro_torch.models.recsys import fm as pfm
from _jax_release import release_jax_executables  # noqa: F401

OP = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's thread pool only adds wake-up latency."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def smoke():
    """(port cfg, port params, reference cfg, reference params, offsets)
    at the smoke config, the reference's parameters carried across."""
    cfg_r = rcfg.make_smoke_config()
    r_params, _ = rfm.init(jax.random.PRNGKey(0), cfg_r)
    p_params = convert.fm_params_from_jax(jax.tree.map(np.asarray, r_params))
    return (pcfg.make_smoke_config(), p_params, cfg_r, r_params,
            rfm.offsets(cfg_r))


def _ids(cfg, batch, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, v, batch) for v in cfg.vocab_sizes], 1)


# ------------------------------------------------------------ embedding bag
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_and_table_gradient(mode, weighted):
    """17 lookups into 7 bags, bags 5 and 6 empty (max: -inf there, as
    ``segment_max`` leaves them; their rows are left out of the
    gradient's cotangent)."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((30, 4)).astype(np.float32)
    idx = rng.integers(0, 30, 17)
    idx[3] = idx[2]                          # a row looked up twice
    seg = np.sort(rng.integers(0, 5, 17))
    w = rng.uniform(0.5, 2.0, 17).astype(np.float32) if weighted else None
    n_bags = 7
    got = pemb.embedding_bag(
        torch.from_numpy(table).requires_grad_(True), torch.from_numpy(idx),
        torch.from_numpy(seg), n_bags, mode,
        None if w is None else torch.from_numpy(w))
    r_fn = lambda t: remb.embedding_bag(  # noqa: E731
        t, jnp.asarray(idx), jnp.asarray(seg), n_bags, mode,
        None if w is None else jnp.asarray(w))
    want = r_fn(jnp.asarray(table))
    np.testing.assert_allclose(_np(got), np.asarray(want), **OP)
    cot = rng.standard_normal((n_bags, 4)).astype(np.float32)
    cot[5:] = 0.0
    table_t = torch.from_numpy(table).requires_grad_(True)
    out = pemb.embedding_bag(table_t, torch.from_numpy(idx),
                             torch.from_numpy(seg), n_bags, mode,
                             None if w is None else torch.from_numpy(w))
    (out[:5] * torch.from_numpy(cot[:5])).sum().backward()
    r_grad = jax.grad(lambda t: jnp.sum(r_fn(t)[:5] * cot[:5]))(
        jnp.asarray(table))
    np.testing.assert_allclose(_np(table_t.grad), np.asarray(r_grad), **OP)


def test_field_offsets_bit_equal():
    for vocab in ([10, 20, 5], list(rfm.CRITEO_VOCABS), [7]):
        got, want = pemb.field_offsets(vocab), remb.field_offsets(vocab)
        assert got.dtype == want.dtype == np.int64
        assert np.array_equal(got, want)


def test_lookup_fields(smoke):
    cfg, p_params, cfg_r, r_params, offs = smoke
    ids = _ids(cfg, 9)
    got = pemb.lookup_fields(p_params["table"], torch.from_numpy(ids),
                             torch.from_numpy(offs))
    want = remb.lookup_fields(r_params["table"], jnp.asarray(ids),
                              jnp.asarray(offs))
    assert np.array_equal(_np(got), np.asarray(want))


# ---------------------------------------------------------------------- FM
def test_vocabularies_and_configs():
    assert pfm.CRITEO_VOCABS == rfm.CRITEO_VOCABS
    assert sum(pfm.CRITEO_VOCABS) == 33_775_577
    for make in ("make_config", "make_smoke_config"):
        got, want = getattr(pcfg, make)(), getattr(rcfg, make)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.total_rows == want.total_rows
    assert pcfg.make_config().total_rows == 33_775_616


def test_scores(smoke):
    cfg, p_params, cfg_r, r_params, offs = smoke
    ids = _ids(cfg, 33, seed=2)
    got = pfm.scores(p_params, cfg, torch.from_numpy(ids),
                     torch.from_numpy(offs))
    want = rfm.scores(r_params, cfg_r, jnp.asarray(ids), jnp.asarray(offs))
    np.testing.assert_allclose(_np(got), np.asarray(want), **OP)


def test_bce_loss_and_gradient(smoke):
    cfg, p_params, cfg_r, r_params, offs = smoke
    ids = _ids(cfg, 64, seed=3)
    labels = np.random.default_rng(3).integers(0, 2, 64).astype(np.float32)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p_params.items()}
    loss = pfm.bce_loss(leaves, cfg, torch.from_numpy(ids),
                        torch.from_numpy(labels), torch.from_numpy(offs))
    loss.backward()
    r_loss, r_grads = jax.value_and_grad(rfm.bce_loss)(
        r_params, cfg_r, jnp.asarray(ids), jnp.asarray(labels),
        jnp.asarray(offs))
    np.testing.assert_allclose(float(loss.detach()), float(r_loss),
                               rtol=1e-6)
    for k in r_grads:
        np.testing.assert_allclose(_np(leaves[k].grad), np.asarray(r_grads[k]),
                                   err_msg=k, **OP)


def test_retrieval_scores(smoke):
    """Against the reference's, and against ``scores`` over the rows
    (query ‖ candidate), candidate ids in the last field."""
    cfg, p_params, cfg_r, r_params, offs = smoke
    rng = np.random.default_rng(4)
    query = _ids(cfg, 1, seed=4)[0, :-1]
    cand_ids = rng.integers(0, cfg.vocab_sizes[-1], 40)
    rows = offs[-1] + cand_ids
    got = pfm.retrieval_scores(p_params, cfg, torch.from_numpy(query),
                               torch.from_numpy(offs[:-1]),
                               torch.from_numpy(rows))
    want = rfm.retrieval_scores(r_params, cfg_r, jnp.asarray(query),
                                jnp.asarray(offs[:-1]), jnp.asarray(rows))
    np.testing.assert_allclose(_np(got), np.asarray(want), **OP)
    full = np.concatenate([np.repeat(query[None], 40, 0), cand_ids[:, None]],
                          1)
    direct = pfm.scores(p_params, cfg, torch.from_numpy(full),
                        torch.from_numpy(offs))
    np.testing.assert_allclose(_np(got), _np(direct), **OP)


@pytest.mark.parametrize("make", ["make_smoke_config", "make_config"])
def test_init_tree_shapes_and_axes(make):
    """Smoke: drawn (CPU); full: on the meta device, nothing drawn (the
    33,775,616 x 10 table) against the reference's abstract init."""
    full = make == "make_config"
    p_params, p_axes = pfm.init(getattr(pcfg, make)(), seed=1,
                                device="meta" if full else "cpu")
    r_params, r_axes = rfm.init(jax.random.PRNGKey(0), getattr(rcfg, make)(),
                                abstract=full)
    assert {k: tuple(v.shape) for k, v in p_params.items()} == {
        k: tuple(v.shape) for k, v in r_params.items()}
    assert p_axes == r_axes
    assert all(v.device.type == ("meta" if full else "cpu")
               for v in p_params.values())


def test_init_draws_the_reference_scales():
    """normal(0, 0.02) table, normal(0, 0.01) linear, zero bias."""
    cfg = dataclasses.replace(pcfg.make_smoke_config(),
                              vocab_sizes=(4000, 3000, 1000, 500, 900, 600))
    params, _ = pfm.init(cfg, seed=0, device="cpu")
    assert abs(float(params["table"].std()) - 0.02) < 1e-3
    assert abs(float(params["linear"].std()) - 0.01) < 5e-4
    assert float(params["bias"].abs().max()) == 0.0


# ------------------------------------------------------------------- cells
def _smoke_arch(arch_def, smoke_cfg):
    return dataclasses.replace(arch_def, make_config=lambda: smoke_cfg)


@pytest.mark.parametrize("shape", ["train_batch", "serve_p99", "serve_bulk",
                                   "retrieval_cand"])
def test_cell_step_against_the_reference(shape):
    from repro.launch.cell import build_fm_cell
    from repro.launch.mesh import make_mesh_from_shape
    from repro.optim.optimizers import OptState

    arch_p = _smoke_arch(pcfg.ARCH, pcfg.make_smoke_config())
    arch_r = _smoke_arch(rcfg.ARCH, rcfg.make_smoke_config())
    cell = pcell.build_fm_cell(arch_p, shape, device="cpu", seed=0)
    mesh = make_mesh_from_shape((1, 1), ("data", "model"))
    ref = build_fm_cell(arch_r, shape, mesh)
    assert cell["kind"] == ref["kind"]
    params = cell["args"][0]
    inputs = [a for a in cell["args"] if isinstance(a, torch.Tensor)]
    r_params = convert.fm_params_to_jax(params)
    r_inputs = [jnp.asarray(_np(t).astype(np.int32)
                            if t.dtype == torch.int64 else _np(t))
                for t in inputs]
    for got, want in zip(r_inputs, ref["args"][-len(r_inputs):]):
        assert got.shape == want.shape
    step = jax.jit(ref["step_fn"])
    if cell["kind"] == "serve_step":
        got = cell["step_fn"](params, *inputs)
        np.testing.assert_allclose(_np(got), np.asarray(step(r_params,
                                                             *r_inputs)),
                                   **OP)
        return
    zeros = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), r_params)
    r_opt = OptState(step=jnp.zeros((), jnp.int32), mu=zeros,
                     nu=jax.tree.map(jnp.copy, zeros))
    r_new, r_opt, r_loss = step(r_params, r_opt, *r_inputs)
    new, opt, loss = cell["step_fn"](params, cell["args"][1], *inputs)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-6)
    for k in r_new:
        np.testing.assert_allclose(_np(opt.mu[k]), np.asarray(r_opt.mu[k]),
                                   rtol=1e-5, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(_np(new[k]), np.asarray(r_new[k]),
                                   err_msg=k, **OP)


def test_cell_inputs_cover_the_fields():
    cfg = pcfg.make_smoke_config()
    ids = pcell.fm_inputs(cfg, "serve_bulk")["ids"]
    assert ids.dtype == np.int64 and ids.shape == (262_144, cfg.n_fields)
    assert np.all(ids.max(0) == np.asarray(cfg.vocab_sizes) - 1)
    assert np.all(ids.min(0) == 0)
    ret = pcell.fm_inputs(cfg, "retrieval_cand")
    assert ret["candidate_rows"].shape == (1_000_000,)
    assert ret["candidate_rows"].max() < cfg.total_rows
    assert ret["query_ids"].shape == (cfg.n_fields - 1,)
