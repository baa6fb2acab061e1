"""The port's qwen3 and MLA (minicpm3) slice against the JAX reference, on
the CPU, and the flash wrappers at a v head dim other than q's.

The same numpy inputs go through both packages; the models run the smoke
configs (``qwen3-smoke``, ``minicpm3-smoke``: 3 layers, d_model 64) with
the reference's parameters carried across by
``convert.lm_params_from_jax``. Lowering ``blockwise_threshold`` and
``attn_block_k`` on both sides sends a prompt through the flash path (the
port's plain version on the CPU, the reference's XLA blockwise scan); at
MLA's smoke widths its q/k head dim is ``d_nope + d_rope`` = 24 and its v
head dim ``d_v`` = 16, as minicpm3-4b's are 96 and 64. The plain flash
forward and backward also run at (192, 128), deepseek-v2's pair. The CUDA
kernels' (96, 64) and (192, 128) instances are held against the same plain
versions on the card by ``chip_smoke.py``.

Tolerances (float32 unless stated):
- attention, plain forward against the reference's ``blockwise_attention``
  and ``dense_attention``: atol 2e-5 / rtol 1e-4 (the reference's flash
  tolerance; sums in another order); bf16 atol 4e-2 / rtol 2e-2 (the port
  keeps float32 scores and accumulator where the reference's scan rounds
  them to bf16, ROADMAP.md queue 3 item 2);
- the plain backward against ``jax.vjp`` of ``blockwise_attention``: atol
  1e-5 / rtol 1e-4; bf16 each gradient within 4e-2 of the float32 exact
  gradient's largest |value| (as ``tests/test_torch_lm_train.py``);
- logits of prefill and decode: atol 1e-4 / rtol 1e-4 (three layers of
  float32 in another summation order); decode against prefill within the
  port (the absorbed path against the expanded one): atol 2e-3;
- ``lm_loss``: the value rtol 1e-5, gradients atol 1e-5 / rtol 1e-4.
"""
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import minicpm3_4b as rmini
from repro.configs import qwen3_1p7b as rqwen
from repro.configs import registry as rreg
from repro.models.lm import attention as rattn
from repro.models.lm import transformer as rtf
from repro_torch import convert
from repro_torch.configs import minicpm3_4b as pmini
from repro_torch.configs import qwen3_1p7b as pqwen
from repro_torch.configs import registry as preg
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve
from repro_torch.launch import train as ptrain
from repro_torch.models.lm import attention as pattn
from repro_torch.models.lm import transformer as ptf
from _jax_release import release_jax_executables  # noqa: F401

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=4e-2, rtol=2e-2)
ATTN_GRAD = dict(atol=1e-5, rtol=1e-4)
LOGITS = dict(atol=1e-4, rtol=1e-4)
LOSS = dict(rtol=1e-5, atol=0.0)
GRADS = dict(atol=1e-5, rtol=1e-4)
PREFILL_FLASH = dict(blockwise_threshold=64, attn_block_k=32)
LOSS_FLASH = dict(blockwise_threshold=16, attn_block_k=16)
ARCHS = {"qwen3": (pqwen, rqwen), "minicpm3": (pmini, rmini)}


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


def _flatten(tree, prefix=""):
    for name, sub in tree.items():
        if isinstance(sub, dict):
            yield from _flatten(sub, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", sub


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("make", ["make_config", "make_smoke_config"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_configs_match_the_reference(arch, make):
    port, ref = ARCHS[arch]
    got = dataclasses.asdict(getattr(port, make)())
    want = dataclasses.asdict(getattr(ref, make)())
    assert got == want


@pytest.mark.parametrize("arch_id, arch", [("qwen3-1.7b", "qwen3"),
                                           ("minicpm3-4b", "minicpm3")])
def test_registry_returns_the_new_archs(arch_id, arch):
    port, ref = ARCHS[arch]
    got = preg.get_arch(arch_id)
    assert got is port.ARCH and got.arch_id == ref.ARCH.arch_id == arch_id
    for field in ("family", "shapes", "rule_overrides", "notes"):
        assert getattr(got, field) == getattr(ref.ARCH, field), field
    assert got.model_module == "repro_torch.models.lm.transformer"
    assert arch_id in preg.ARCHS
    assert preg._MODULES == {k: v.replace("repro.", "repro_torch.", 1)
                             for k, v in rreg._MODULES.items()}
    for other in ("pna", "mace", "gatedgcn", "nequip", "fm"):
        assert preg.get_arch(other).model_module.startswith(
            "repro_torch.models.")


def test_full_configs_take_the_kernels_compiled_head_dims():
    """minicpm3's attention runs the (96, 64) instance, qwen3's (128,
    128): the pairs the CUDA kernels are compiled for."""
    mini, qwen = pmini.make_config(), pqwen.make_config()
    assert (mini.d_nope + mini.d_rope, mini.d_v) in flash_ops.HEAD_DIMS
    assert (qwen.d_head, qwen.d_head) in flash_ops.HEAD_DIMS


# ---------------------------------------------------- flash at D_v != D
def _attn(seed, hq, hkv, d, dv, s=64, sk=None):
    rng = np.random.default_rng(seed)
    sk = sk or s
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((2, s, hq, d), (2, sk, hkv, d), (2, sk, hkv, dv),
                       (2, s, hq, dv))]


DV_CASES = [(24, 16, 4, 4), (24, 16, 4, 2), (96, 64, 2, 2), (96, 64, 4, 1),
            (192, 128, 2, 2), (192, 128, 4, 1)]
DV_IDS = ["24-16-mha", "24-16-gqa", "96-64-mha", "96-64-gqa", "192-128-mha",
          "192-128-gqa"]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d, dv, hq, hkv", DV_CASES, ids=DV_IDS)
def test_plain_forward_at_a_v_dim_of_its_own(d, dv, hq, hkv, causal):
    q, k, v, _ = _attn(d + dv + hkv, hq, hkv, d, dv)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal, block_q=32, block_k=16)
    assert got.shape == (2, 64, hq, dv)
    want = rattn.blockwise_attention(jq, jk, jv, causal=causal, block_k=16)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(
        _np(got), _np(rattn.dense_attention(jq, jk, jv, causal=causal)),
        **F32)
    # the model's blockwise path, through the wrapper
    np.testing.assert_allclose(
        _np(pattn.blockwise_attention(tq, tk, tv, causal=causal,
                                      block_k=16)), _np(want), **F32)


def test_plain_forward_at_a_v_dim_of_its_own_with_more_keys():
    q, k, v, _ = _attn(5, 4, 2, 96, 64, s=32, sk=96)
    got = flash_attention(*map(torch.tensor, (q, k, v)), causal=True,
                          block_q=16, block_k=32)
    want = rattn.dense_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("d, dv, hq, hkv", DV_CASES, ids=DV_IDS)
def test_plain_forward_at_a_v_dim_of_its_own_in_bf16(d, dv, hq, hkv):
    q, k, v, _ = _attn(30 + d + hkv, hq, hkv, d, dv)
    got = flash_attention(*(torch.tensor(x).to(torch.bfloat16)
                            for x in (q, k, v)), causal=True, block_q=32,
                          block_k=16)
    assert got.dtype == torch.bfloat16 and got.shape[-1] == dv
    want = rattn.blockwise_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=True,
        block_k=16)
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d, dv, hq, hkv", DV_CASES, ids=DV_IDS)
def test_plain_backward_at_a_v_dim_of_its_own(d, dv, hq, hkv, causal):
    q, k, v, do = _attn(50 + d + hkv, hq, hkv, d, dv)
    _, vjp = jax.vjp(lambda a, b, c: rattn.blockwise_attention(
        a, b, c, causal=causal, block_k=16), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.tensor, (q, k, v, do))
    o, lse = flash_ops.flash_attention_lse(tq, tk, tv, causal, 32, 16)
    got = flash_ops.flash_attention_bwd(tq, tk, tv, o, tdo, causal, lse)
    for name, a, b, like in zip("qkv", got, want, (q, k, v)):
        assert a.shape == like.shape
        np.testing.assert_allclose(_np(a), _np(b), **ATTN_GRAD,
                                   err_msg=f"d{name}")
    # through autograd: the FlashAttention Function's CPU branch
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = flash_attention(*leaves, causal=causal, block_q=32, block_k=16)
    for a, b in zip(torch.autograd.grad(out, leaves, tdo), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d, dv, hq, hkv", DV_CASES, ids=DV_IDS)
def test_bf16_plain_backward_at_a_v_dim_of_its_own(d, dv, hq, hkv):
    """bf16 against ``jax.vjp`` of the reference in bf16, and both near
    the float32 gradient of the same bf16 inputs."""
    raw = _attn(70 + d + hkv, hq, hkv, d, dv)
    q, k, v, do = (np.asarray(jnp.asarray(x, jnp.bfloat16)
                              .astype(jnp.float32)) for x in raw)
    _, vjp = jax.vjp(lambda a, b, c: rattn.blockwise_attention(
        a, b, c, causal=True, block_k=16),
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    want = vjp(jnp.asarray(do, jnp.bfloat16))
    tq, tk, tv, tdo = (torch.tensor(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    o, lse = flash_ops.flash_attention_lse(tq, tk, tv, True, 32, 16)
    got = flash_ops.flash_attention_bwd_plain(tq, tk, tv, o, tdo, True,
                                              lse=lse)
    leaves = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
    exact = torch.autograd.grad(
        flash_ops.flash_attention_plain(*leaves, True, 32, 16), leaves,
        torch.tensor(do))
    for name, a, b, c in zip("qkv", got, want, exact):
        assert a.dtype == torch.bfloat16
        tol = float(c.abs().max())
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=4e-2 * tol,
                                   err_msg=f"d{name}")
        np.testing.assert_allclose(_np(a), _np(c), rtol=0, atol=1e-2 * tol,
                                   err_msg=f"d{name}")


def _zeros(d, dv, dtype=torch.bfloat16):
    """q, k, v and o, do, dq, dk, dv of (1, 8, 2, .) at the pair."""
    qk = [torch.zeros(1, 8, 2, d, dtype=dtype) for _ in range(2)]
    vo = [torch.zeros(1, 8, 2, dv, dtype=dtype) for _ in range(3)]
    return (qk[0], qk[1], vo[0], vo[1], vo[2],
            torch.zeros(1, 8, 2, d, dtype=dtype),
            torch.zeros(1, 8, 2, d, dtype=dtype),
            torch.zeros(1, 8, 2, dv, dtype=dtype))


@pytest.mark.parametrize("d, dv", flash_ops.HEAD_DIMS)
def test_kernel_checks_take_the_compiled_pairs(d, dv):
    """The pairs the CUDA kernels are compiled for pass the wrappers'
    checks (forward and backward), on CUDA-shaped metadata; the backward
    stops only at the device."""
    q, k, v, o, do, dq, dk, dv_t = _zeros(d, dv)
    flash_ops.check_kernel_operands(q, k, v)
    flash_ops.check_kernel_operands(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_ops.launch_bwd(q, k, v, o, do, torch.zeros(1, 2, 8), dq, dk,
                             dv_t, True)


@pytest.mark.parametrize("d, dv", [(96, 96), (64, 96), (96, 32), (64, 32),
                                   (24, 16), (128, 64), (192, 192)])
def test_kernel_checks_refuse_other_pairs(d, dv):
    q, k, v, o, do, dq, dk, dv_t = _zeros(d, dv)
    with pytest.raises(ValueError, match="compiled for D"):
        flash_ops.check_kernel_operands(q, k, v)
    with pytest.raises(ValueError, match="compiled for D"):
        flash_ops.launch_bwd(q, k, v, o, do, torch.zeros(1, 2, 8), dq, dk,
                             dv_t, True)


def test_wrappers_refuse_operands_at_the_wrong_head_dim():
    q, k, v, o, do, dq, dk, dv = _zeros(96, 64, torch.float32)
    with pytest.raises(ValueError, match="D_v"):        # o at q's D
        flash_ops.flash_attention_bwd(q, k, v, q, do)
    with pytest.raises(ValueError, match="D_v"):        # k and v's Sk
        flash_attention(q, k, v[:, :4], block_q=8, block_k=4)
    with pytest.raises(ValueError, match="head dim"):   # dv at q's D
        flash_ops.launch_bwd(q, k, v, o, do, torch.zeros(1, 2, 8), dq, dk,
                             dq, True)


def _c_signature(stem, entry):
    """The C entry's parameter types as ctypes would take them."""
    text = (_build.CSRC / f"{stem}.cu").read_text()
    body = re.search(rf'extern "C" int {entry}\((.*?)\)\s*{{', text,
                     re.S).group(1)
    kinds = []
    for arg in body.split(","):
        arg = " ".join(arg.split())
        kinds.append(_build._P if "*" in arg else
                     _build._L if arg.startswith("long long") else _build._I)
    return tuple(kinds)


@pytest.mark.parametrize("entry", ["flash_attention_fwd",
                                   "flash_attention_bwd"])
def test_flash_entries_argtypes_match_the_c_signatures(entry):
    stem, argtypes = _build.ENTRIES[entry]
    assert _c_signature(stem, entry) == tuple(argtypes)


def test_flash_sources_dispatch_the_compiled_pairs():
    """Each C entry dispatches exactly ``HEAD_DIMS`` for both dtypes."""
    for stem in ("flash_attention", "flash_attention_bwd"):
        text = (pathlib.Path(_build.CSRC) / f"{stem}.cu").read_text()
        pairs = {tuple(map(int, m)) for m in re.findall(
            r"<(\d+), (\d+)>\(", text.split('extern "C"')[-1])}
        assert pairs == set(flash_ops.HEAD_DIMS), stem


# ------------------------------------------------------------------- models
def _cfgs(arch, **kw):
    port, ref = ARCHS[arch]
    return (dataclasses.replace(port.make_smoke_config(), **kw),
            dataclasses.replace(ref.make_smoke_config(), **kw))


@pytest.fixture(scope="module")
def models():
    """arch -> (port cfg, port params, reference cfg, reference params)."""
    out = {}
    for arch in ARCHS:
        pcfg, rcfg = _cfgs(arch)
        rparams, _ = rtf.init(jax.random.PRNGKey(0), rcfg)
        out[arch] = (pcfg, convert.lm_params_from_jax(
            jax.tree.map(np.asarray, rparams)), rcfg, rparams)
    return out


@pytest.fixture(scope="module")
def toks():
    return np.random.default_rng(8).integers(0, 250, (2, 128))


def test_mla_init_layout_matches_the_reference():
    pcfg, rcfg = _cfgs("minicpm3")
    got = dict(_flatten(ptf.init(pcfg, seed=0, device="cpu")))
    want = {k: np.asarray(v) for k, v in _flatten(
        rtf.init(jax.random.PRNGKey(0), rcfg)[0])}
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert got[name].dtype == torch.float32, name
    for name in ("layers/q_norm", "layers/kv_norm", "layers/ln_attn"):
        assert bool((got[name] == 1).all()), name
    # normal(0, 1/sqrt(fan_in)) with fan_in = the leaf's first dim
    for name, fan_in in (("layers/w_uq", pcfg.q_lora),
                         ("layers/w_dkv", pcfg.d_model),
                         ("layers/wo", pcfg.n_heads)):
        assert abs(float(got[name].std()) * fan_in ** 0.5 - 1.0) < 0.1, name
    bf = ptf.init(dataclasses.replace(pcfg, dtype="bfloat16"), device="cpu")
    assert bf["layers"]["w_uk"].dtype == torch.bfloat16


def test_mla_convert_round_trip_is_exact_in_bf16():
    _, rcfg = _cfgs("minicpm3", dtype="bfloat16")
    rparams, _ = rtf.init(jax.random.PRNGKey(3), rcfg)
    pparams = convert.lm_params_from_jax(jax.tree.map(np.asarray, rparams))
    assert pparams["layers"]["w_uv"].dtype == torch.bfloat16
    back = dict(_flatten(convert.lm_params_to_jax(pparams)))
    want = dict(_flatten(rparams))
    assert back.keys() == want.keys()
    for name, b in want.items():
        assert np.array_equal(
            np.asarray(jnp.asarray(back[name], jnp.bfloat16)).view(np.uint16),
            np.asarray(b).view(np.uint16)), name


def test_mla_cache_layout_matches_the_reference():
    pcfg, rcfg = _cfgs("minicpm3")
    got = ptf.init_cache(pcfg, 2, 16, device="cpu")
    want = rtf.init_cache(rcfg, 2, 16)
    assert sorted(got) == sorted(want) == ["c", "r"]
    for key in got:
        assert tuple(got[key].shape) == want[key].shape
        assert not bool(got[key].any())


@pytest.mark.parametrize("path", ["dense", "flash"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_matches_the_reference(models, toks, arch, path,
                                       monkeypatch):
    pcfg, pparams, rcfg, rparams = models[arch]
    n = 32 if path == "dense" else 128
    if path == "flash":
        pcfg = dataclasses.replace(pcfg, **PREFILL_FLASH)
        rcfg = dataclasses.replace(rcfg, **PREFILL_FLASH)
    calls = []
    plain = flash_ops.flash_attention_plain

    def counted(*args, **kw):
        calls.append((args[0].shape, args[2].shape))
        return plain(*args, **kw)

    monkeypatch.setattr(flash_ops, "flash_attention_plain", counted)
    got = ptf.prefill(pparams, pcfg, torch.tensor(toks[:, :n]))
    want = rtf.prefill(rparams, rcfg, jnp.asarray(toks[:, :n]))
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)
    if path == "dense":
        assert calls == []
        return
    assert len(calls) == pcfg.n_layers            # one flash call a layer
    if arch == "minicpm3":                        # q/k 24 wide, v 16
        assert calls[0] == ((2, n, 4, 24), (2, n, 4, 16))


def _ref_decode(rcfg, rparams, toks, n):
    step = jax.jit(lambda p, t, c, i: rtf.decode_step(p, rcfg, t, c, i))
    cache = rtf.init_cache(rcfg, toks.shape[0], 16)
    outs = []
    for t in range(n):
        logits, cache = step(rparams, jnp.asarray(toks[:, t:t + 1]), cache,
                             jnp.asarray(t, jnp.int32))
        outs.append(np.asarray(logits))
    return np.stack(outs, axis=1), cache


def _port_decode(pcfg, pparams, toks, n):
    cache = ptf.init_cache(pcfg, toks.shape[0], 16, device="cpu")
    outs = []
    for t in range(n):
        logits, cache = ptf.decode_step(pparams, pcfg,
                                        torch.tensor(toks[:, t:t + 1]),
                                        cache, t)
        outs.append(_np(logits))
    return np.stack(outs, axis=1), cache


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_steps_match_the_reference(models, toks, arch):
    pcfg, pparams, rcfg, rparams = models[arch]
    got, cache = _port_decode(pcfg, pparams, toks, 8)
    want, rcache = _ref_decode(rcfg, rparams, toks, 8)
    np.testing.assert_allclose(got, want, **LOGITS)
    # the cache was written in place, up to the eighth position, as the
    # reference's
    for key in cache:
        np.testing.assert_allclose(_np(cache[key]), np.asarray(rcache[key]),
                                   **LOGITS, err_msg=key)
        assert not bool(cache[key][:, :, 8:].any())


def test_mla_absorbed_decode_matches_the_expanded_prefill(models, toks):
    """Eight cached decode steps through the absorbed path give the logits
    of one forward pass over the same tokens through the expanded K/V."""
    pcfg, pparams, _, _ = models["minicpm3"]
    dec, _ = _port_decode(pcfg, pparams, toks, 8)
    hid = ptf.forward(pparams, pcfg, torch.tensor(toks[:, :8]))
    np.testing.assert_allclose(dec, _np(ptf.logits_of(pparams, pcfg, hid)),
                               atol=2e-3)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serve_run_tokens_equal_the_reference_loop(models, arch):
    pcfg, pparams, rcfg, rparams = models[arch]
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
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  np.asarray(jnp.concatenate(out, axis=1)))


LOSS_CASES = {"dense": {}, "blockwise": LOSS_FLASH,
              "chunked": dict(loss_chunk=16)}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("case", list(LOSS_CASES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_lm_loss_and_grads_match_the_reference(models, arch, case, remat):
    pcfg, pparams, _, rparams = models[arch]
    kw = dict(LOSS_CASES[case], remat=remat)
    pcfg, rcfg = _cfgs(arch, **kw)
    rng = np.random.default_rng(10)
    tokens = rng.integers(0, pcfg.vocab, (2, 64))
    targets = rng.integers(0, pcfg.vocab, (2, 64))
    want_loss, want_grads = jax.value_and_grad(rtf.lm_loss)(
        rparams, rcfg, jnp.asarray(tokens), jnp.asarray(targets))
    got_loss, got_grads = ptrain.value_and_grad(
        pparams, pcfg, torch.tensor(tokens), torch.tensor(targets))
    np.testing.assert_allclose(float(got_loss), float(want_loss), **LOSS)
    flat_want = dict(_flatten(want_grads))
    flat_got = dict(_flatten(got_grads))
    assert flat_got.keys() == flat_want.keys()
    for name, w in flat_want.items():
        np.testing.assert_allclose(_np(flat_got[name]), _np(w), **GRADS,
                                   err_msg=name)
    attn = ("w_uq", "w_dkv", "w_uk", "w_uv", "w_kr") if arch == "minicpm3" \
        else ("wq", "wk", "wv")
    for name in attn:   # every layer's attention gets a gradient
        g = got_grads["layers"][name].abs().flatten(1).amax(dim=1)
        assert bool((g > 0).all()), name


@pytest.mark.parametrize("arch_id", ["qwen3-1.7b", "minicpm3-4b"])
def test_launchers_run_the_smoke_config(arch_id, capsys, monkeypatch,
                                        tmp_path):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch_id,
                                     "--gen-len", "4", "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert "decoded 4 x 4" in out and "first sequence:" in out
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", arch_id, "--device", "cpu", "--steps", "5",
        "--ckpt-every", "5", "--ckpt-dir", str(tmp_path)])
    ptrain.main()
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"step 5: loss -?\d+\.\d{4} \(checkpointed\)",
                        lines[0])
