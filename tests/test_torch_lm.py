"""The port's LM serving slice against the JAX reference, on the CPU.

Layers and attention paths take the same numpy inputs on both sides. The
model tests run ``tinyllama-smoke`` with the reference's parameters
carried across by ``convert.lm_params_from_jax``; replacing
``blockwise_threshold=64, attn_block_k=32`` on both sides sends a
128-token prompt through the flash path (the port's plain version on the
CPU, the reference's XLA blockwise scan).

Tolerances: float32 atol 2e-5 / rtol 1e-4 for attention (the reference's
flash tolerance), 1e-4 on logits (three layers of float32 in another
summation order). bf16 attention atol 4e-2 / rtol 2e-2: the port follows
the Pallas kernel (float32 scores and accumulator), the reference's XLA
blockwise path rounds scores and accumulator to bf16 (a stated
divergence, ROADMAP.md queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.configs import tinyllama_1p1b as rtiny
from repro.models.lm import attention as rattn
from repro.models.lm import layers as rlayers
from repro.models.lm import transformer as rtf
from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.configs import tinyllama_1p1b as ptiny
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve
from repro_torch.models.lm import attention as pattn
from repro_torch.models.lm import layers as players
from repro_torch.models.lm import transformer as ptf
from _jax_release import release_jax_executables  # noqa: F401

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=4e-2, rtol=2e-2)
LOGITS = dict(atol=1e-4, rtol=1e-4)
FLASH = dict(blockwise_threshold=64, attn_block_k=32)
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's thread pool only adds wake-up latency."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _randn(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtypes):
    tdt, jdt = dtypes
    return ([torch.tensor(a).to(tdt) for a in arrays],
            [jnp.asarray(a, jdt) for a in arrays])


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_rms_norm(dtypes):
    x, w = _randn(np.random.default_rng(1), (2, 5, 64), (64,))
    (tx, tw), (jx, jw) = _both([x, w], dtypes)
    got, want = players.rms_norm(tx, tw), rlayers.rms_norm(jx, jw)
    assert got.dtype == dtypes[0]
    tol = F32 if dtypes[0] == torch.float32 else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_apply_rope(dtypes):
    rng = np.random.default_rng(2)
    (x,) = _randn(rng, (2, 7, 4, 16))
    pos = rng.integers(0, 4096, (2, 7))
    (tx,), (jx,) = _both([x], dtypes)
    got = players.apply_rope(tx, torch.tensor(pos), 10_000.0)
    want = rlayers.apply_rope(jx, jnp.asarray(pos), 10_000.0)
    assert got.dtype == dtypes[0]
    tol = dict(atol=1e-4, rtol=1e-4) if dtypes[0] == torch.float32 \
        else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(players.rope_freqs(16)),
                               _np(rlayers.rope_freqs(16)), rtol=1e-6)


def test_swiglu():
    x, g, u, d = _randn(np.random.default_rng(3), (2, 3, 16), (16, 40),
                        (16, 40), (40, 16))
    (tx, tg, tu, td), (jx, jg, ju, jd) = _both([x, g, u, d], DTYPES[0])
    np.testing.assert_allclose(_np(players.swiglu(tx, tg, tu, td)),
                               _np(rlayers.swiglu(jx, jg, ju, jd)), **F32)


# --------------------------------------------------------------- attention
def _qkv(seed, s=256):
    return _randn(np.random.default_rng(seed), (2, s, 8, 32), (2, s, 2, 32),
                  (2, s, 2, 32))


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_attention(dtypes, causal):
    t, j = _both(_qkv(4, 64), dtypes)
    got = pattn.dense_attention(*t, causal=causal)
    want = rattn.dense_attention(*j, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtypes[0] == torch.float32 else BF16))


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention(dtypes, causal):
    t, j = _both(_qkv(5), dtypes)
    got = pattn.blockwise_attention(*t, causal=causal, block_k=64)
    want = rattn.blockwise_attention(*j, causal=causal, block_k=64)
    assert got.dtype == dtypes[0]
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtypes[0] == torch.float32 else BF16))


def test_blockwise_attention_checks_the_block():
    t, _ = _both(_qkv(6, 96), DTYPES[0])
    with pytest.raises(AssertionError):
        pattn.blockwise_attention(*t, causal=True, block_k=64)


def test_decode_attention():
    rng = np.random.default_rng(7)
    q, kc, vc = _randn(rng, (3, 1, 8, 32), (3, 24, 2, 32), (3, 24, 2, 32))
    lens = np.array([5, 24, 1], np.int32)
    (tq, tk, tv), (jq, jk, jv) = _both([q, kc, vc], DTYPES[0])
    got = pattn.decode_attention(tq, tk, tv, torch.tensor(lens))
    want = rattn.decode_attention(jq, jk, jv, jnp.asarray(lens))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("make", ["make_config", "make_smoke_config"])
def test_configs_match_the_reference(make):
    got = dataclasses.asdict(getattr(ptiny, make)())
    want = dataclasses.asdict(getattr(rtiny, make)())
    assert got == want


def test_registry():
    arch = preg.get_arch("tinyllama-1.1b")
    assert arch.family == "lm" and arch.shapes == rtiny.ARCH.shapes
    assert arch.model_module == "repro_torch.models.lm.transformer"
    assert preg._MODULES == {k: v.replace("repro.", "repro_torch.", 1)
                             for k, v in rreg._MODULES.items()}
    for arch_id in ("pna", "mace", "gatedgcn", "nequip", "fm"):
        assert preg.get_arch(arch_id).model_module.startswith(
            "repro_torch.models.")
    assert preg.get_arch("qwen3-1.7b").arch_id == "qwen3-1.7b"
    assert preg.get_arch("minicpm3-4b").arch_id == "minicpm3-4b"
    with pytest.raises(KeyError):
        preg.get_arch("gpt-5")


# ------------------------------------------------------------------- model
def _cfgs(**kw):
    return (dataclasses.replace(ptiny.make_smoke_config(), **kw),
            dataclasses.replace(rtiny.make_smoke_config(), **kw))


@pytest.fixture(scope="module")
def models():
    """(port cfg, port params, reference cfg, reference params) for the
    smoke config, plain and with qk_norm."""
    out = {}
    for qk_norm in (False, True):
        pcfg, rcfg = _cfgs(qk_norm=qk_norm)
        rparams, _ = rtf.init(jax.random.PRNGKey(0), rcfg)
        pparams = convert.lm_params_from_jax(
            jax.tree.map(np.asarray, rparams))
        out[qk_norm] = (pcfg, pparams, rcfg, rparams)
    return out


@pytest.fixture(scope="module")
def toks():
    return np.random.default_rng(8).integers(0, 256, (2, 128))


def test_init_layout_matches_the_reference():
    pcfg, rcfg = _cfgs(qk_norm=True)
    got = ptf.init(pcfg, seed=0, device="cpu")
    want, _ = rtf.init(jax.random.PRNGKey(0), rcfg)
    flat_got = {k: v for k, v in _flatten(got)}
    flat_want = {k: np.asarray(v) for k, v in _flatten(want)}
    assert flat_got.keys() == flat_want.keys()
    for name, w in flat_want.items():
        assert tuple(flat_got[name].shape) == w.shape, name
        assert flat_got[name].dtype == torch.float32, name
    assert torch.equal(flat_got["layers/ln_attn"],
                       torch.ones(pcfg.n_layers, pcfg.d_model))
    assert abs(float(flat_got["embed"].std()) - 0.02) < 2e-3
    # normal(0, 1/sqrt(fan_in)) per layer, fan_in = d_model for wq
    assert abs(float(flat_got["layers/wq"].std()) * 8.0 - 1.0) < 0.05
    bf = ptf.init(dataclasses.replace(pcfg, dtype="bfloat16"), device="cpu")
    assert bf["layers"]["wq"].dtype == torch.bfloat16


def _flatten(tree, prefix=""):
    for name, sub in tree.items():
        if isinstance(sub, dict):
            yield from _flatten(sub, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", sub


def test_convert_round_trip_is_exact_in_bf16():
    pcfg, rcfg = _cfgs(dtype="bfloat16")
    rparams, _ = rtf.init(jax.random.PRNGKey(3), rcfg)
    pparams = convert.lm_params_from_jax(jax.tree.map(np.asarray, rparams))
    assert pparams["layers"]["wq"].dtype == torch.bfloat16
    back = dict(_flatten(convert.lm_params_to_jax(pparams)))
    want = dict(_flatten(rparams))
    assert back.keys() == want.keys()
    for name, b in want.items():
        assert np.array_equal(
            np.asarray(jnp.asarray(back[name], jnp.bfloat16)).view(np.uint16),
            np.asarray(b).view(np.uint16)), name


@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
def test_prefill_through_the_flash_path(models, toks, qk_norm, monkeypatch):
    pcfg, pparams, rcfg, rparams = models[qk_norm]
    pcfg = dataclasses.replace(pcfg, **FLASH)
    rcfg = dataclasses.replace(rcfg, **FLASH)
    calls = []
    plain = flash_ops.flash_attention_plain

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)

    monkeypatch.setattr(flash_ops, "flash_attention_plain", counted)
    before = flash_attention.launches
    got = ptf.prefill(pparams, pcfg, torch.tensor(toks))
    want = rtf.prefill(rparams, rcfg, jnp.asarray(toks))
    assert len(calls) == pcfg.n_layers        # one flash call per layer
    assert flash_attention.launches == before  # the CPU launches nothing
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)


def test_prefill_through_the_dense_path(models, toks):
    pcfg, pparams, rcfg, rparams = models[False]
    got = ptf.prefill(pparams, pcfg, torch.tensor(toks[:, :32]))
    want = rtf.prefill(rparams, rcfg, jnp.asarray(toks[:, :32]))
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)


def _ref_decode(rcfg, rparams, toks, n):
    step = jax.jit(lambda p, t, c, i: rtf.decode_step(p, rcfg, t, c, i))
    cache = rtf.init_cache(rcfg, toks.shape[0], 16)
    outs = []
    for t in range(n):
        logits, cache = step(rparams, jnp.asarray(toks[:, t:t + 1]), cache,
                             jnp.asarray(t, jnp.int32))
        outs.append(np.asarray(logits))
    return np.stack(outs, axis=1)


def _port_decode(pcfg, pparams, toks, n):
    cache = ptf.init_cache(pcfg, toks.shape[0], 16, device="cpu")
    outs = []
    for t in range(n):
        logits, cache = ptf.decode_step(pparams, pcfg,
                                        torch.tensor(toks[:, t:t + 1]),
                                        cache, t)
        outs.append(_np(logits))
    return np.stack(outs, axis=1), cache


@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
def test_decode_steps_match_the_reference(models, toks, qk_norm):
    pcfg, pparams, rcfg, rparams = models[qk_norm]
    got, cache = _port_decode(pcfg, pparams, toks, 8)
    want = _ref_decode(rcfg, rparams, toks, 8)
    np.testing.assert_allclose(got, want, **LOGITS)
    # the cache was written in place, up to the eighth position
    assert bool((cache["k"][:, :, :8] != 0).any(dim=(-1, -2)).all())
    assert not bool(cache["k"][:, :, 8:].any())


def test_decode_matches_prefill(models, toks):
    """As ``tests/test_models_lm.py``: eight cached decode steps give the
    logits of one forward pass over the same eight tokens."""
    pcfg, pparams, _, _ = models[True]
    dec, _ = _port_decode(pcfg, pparams, toks, 8)
    hid = ptf.forward(pparams, pcfg, torch.tensor(toks[:, :8]))
    ref = _np(ptf.logits_of(pparams, pcfg, hid))
    np.testing.assert_allclose(dec, ref, atol=2e-3)


def test_serve_run_tokens_equal_the_reference_loop(models):
    """``serve.run`` against the reference's serving loop
    (``repro/launch/serve.py``) on the same prompts and parameters."""
    pcfg, pparams, rcfg, rparams = models[False]
    batch, prompt_len, gen_len = 4, 8, 16
    prompts = np.random.default_rng(9).integers(0, rcfg.vocab,
                                                (batch, prompt_len))
    res = serve.run(pcfg, batch=batch, prompt_len=prompt_len,
                    gen_len=gen_len, device="cpu", prompts=prompts,
                    params=pparams)

    decode = jax.jit(lambda p, t, c, i: rtf.decode_step(p, rcfg, t, c, i))
    cache = rtf.init_cache(rcfg, batch, prompt_len + gen_len)
    jp = jnp.asarray(prompts)
    for i in range(prompt_len):
        logits, cache = decode(rparams, jp[:, i:i + 1], cache,
                               jnp.asarray(i, jnp.int32))
    np.testing.assert_allclose(_np(res.prompt_logits), _np(logits), **LOGITS)
    tokens = jnp.argmax(logits, axis=-1)[:, None]
    out = [tokens]
    for s in range(gen_len - 1):
        logits, cache = decode(rparams, tokens, cache,
                               jnp.asarray(prompt_len + s, jnp.int32))
        tokens = jnp.argmax(logits, axis=-1)[:, None]
        out.append(tokens)
    want = np.asarray(jnp.concatenate(out, axis=1))
    assert res.tokens.shape == (batch, gen_len)
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    assert res.decode_s > 0


def test_serve_main_runs_the_smoke_config(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "tinyllama-1.1b",
                                     "--gen-len", "4", "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert "decoded 4 x 4" in out and "first sequence:" in out


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pcfg, _ = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ptf.init(pcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.run(pcfg, batch=1, prompt_len=1, gen_len=1)
