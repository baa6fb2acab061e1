"""The port's MoE slice (moonshot-v1-16b-a3b, deepseek-v2-236b) against the
JAX reference, on the CPU.

The same numpy inputs go through both packages. ``moe.py`` is held
function by function (``route_topk``, ``build_dispatch``, ``moe_ffn``);
the models run the smoke configs (``moonshot-smoke``, ``deepseek-smoke``:
3 layers, d_model 64, 8 experts, top-2, 2 shared experts,
``first_k_dense=1``) with the reference's parameters carried across by
``convert.lm_params_from_jax``. Lowering ``blockwise_threshold`` and
``attn_block_k`` on both sides sends a prompt through the flash path (the
port's plain version on the CPU); deepseek's smoke MLA runs q/k 24 wide
and v 16, as deepseek-v2's 192 and 128 (the CUDA kernels' (192, 128)
instance, held against the same plain versions on the card by
``chip_smoke.py``).

Tolerances (float32 unless stated):
- routing: the experts, in order, and the dispatch table and combine
  slots are bit-equal, ties and capacity overflow included; the routing
  weights atol 1e-7 / rtol 1e-6 (a float32 softmax, summed in another
  order);
- ``moe_ffn``: atol 1e-5 / rtol 1e-4, with and without ``no_drop``; its
  gradients atol 1e-5 / rtol 1e-4;
- logits of prefill and decode: atol 1e-4 / rtol 1e-4 (three layers of
  float32 in another summation order);
- ``lm_loss``: the value rtol 1e-5, gradients atol 1e-5 / rtol 1e-4;
- parameters carried across in bf16 and back: bit-equal.
"""
import dataclasses
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v2_236b as rdeep
from repro.configs import moonshot_v1_16b_a3b as rmoon
from repro.configs import registry as rreg
from repro.models.lm import moe as rmoe
from repro.models.lm import transformer as rtf
from repro.train import checkpoint as rck
from repro_torch import convert
from repro_torch import optim as poptim
from repro_torch.configs import deepseek_v2_236b as pdeep
from repro_torch.configs import moonshot_v1_16b_a3b as pmoon
from repro_torch.configs import registry as preg
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve
from repro_torch.launch import train as ptrain
from repro_torch.models import param as pparam
from repro_torch.models.lm import moe as pmoe
from repro_torch.models.lm import transformer as ptf
from repro_torch.train import checkpoint as pck
from _jax_release import release_jax_executables  # noqa: F401

WEIGHTS = dict(atol=1e-7, rtol=1e-6)
FFN = dict(atol=1e-5, rtol=1e-4)
LOGITS = dict(atol=1e-4, rtol=1e-4)
LOSS = dict(rtol=1e-5, atol=0.0)
GRADS = dict(atol=1e-5, rtol=1e-4)
PREFILL_FLASH = dict(blockwise_threshold=64, attn_block_k=32)
LOSS_FLASH = dict(blockwise_threshold=16, attn_block_k=16)
ARCHS = {"moonshot": (pmoon, rmoon), "deepseek": (pdeep, rdeep)}
IDS = {"moonshot": "moonshot-v1-16b-a3b", "deepseek": "deepseek-v2-236b"}


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


@pytest.mark.parametrize("arch", list(ARCHS))
def test_registry_returns_the_moe_archs(arch):
    port, ref = ARCHS[arch]
    got = preg.get_arch(IDS[arch])
    assert got is port.ARCH and got.arch_id == ref.ARCH.arch_id == IDS[arch]
    for field in ("family", "shapes", "rule_overrides", "notes"):
        assert getattr(got, field) == getattr(ref.ARCH, field), field
    assert got.model_module == "repro_torch.models.lm.transformer"
    assert IDS[arch] in preg.ARCHS
    assert preg._MODULES == {k: v.replace("repro.", "repro_torch.", 1)
                             for k, v in rreg._MODULES.items()}
    for other in ("pna", "mace", "gatedgcn", "nequip", "fm"):
        assert preg.get_arch(other).model_module.startswith(
            "repro_torch.models.")


def test_full_configs_take_the_kernels_compiled_head_dims():
    """deepseek-v2's MLA runs the (192, 128) instance, moonshot's GQA the
    (128, 128) one."""
    deep, moon = pdeep.make_config(), pmoon.make_config()
    assert (deep.d_nope + deep.d_rope, deep.d_v) == (192, 128)
    assert (192, 128) in flash_ops.HEAD_DIMS
    assert (moon.d_head, moon.d_head) in flash_ops.HEAD_DIMS


# ----------------------------------------------------------------- routing
def _logits(seed, t, e, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((t, e)).astype(dtype)


@pytest.mark.parametrize("t, e, k", [(64, 8, 2), (200, 64, 6), (37, 160, 6)])
def test_route_topk_matches_the_reference(t, e, k):
    lg = _logits(t + e + k, t, e)
    want_w, want_e = rmoe.route_topk(jnp.asarray(lg), k)
    got_w, got_e = pmoe.route_topk(torch.tensor(lg), k)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **WEIGHTS)
    assert got_w.dtype == torch.float32


def test_route_topk_matches_the_reference_on_bf16_logits():
    """bf16 logits (as the bf16 models' ``x @ router_w`` gives them) tie
    often: the same experts in the same order."""
    lg = np.asarray(jnp.asarray(_logits(3, 512, 64), jnp.bfloat16)
                    .astype(jnp.float32))
    want_w, want_e = rmoe.route_topk(jnp.asarray(lg, jnp.bfloat16), 6)
    got_w, got_e = pmoe.route_topk(torch.tensor(lg).to(torch.bfloat16), 6)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **WEIGHTS)


@pytest.mark.parametrize("probs, k", [
    ([.1, .3, .3, .2, .3, .05], 2),        # three equal at the top
    ([.2, .2, .2, .2, .1, .1], 3),         # ties across the k boundary
    ([.25, .25, .25, .25], 4),             # all equal
    ([.05, .15, .3, .15, .3, .05], 5),     # ties inside and past the top k
], ids=["top-tie", "boundary", "all-equal", "inside-and-past"])
def test_route_topk_ties_keep_the_lower_index_first(probs, k):
    lg = np.log(np.asarray([probs, probs[::-1]], np.float32))
    want_w, want_e = rmoe.route_topk(jnp.asarray(lg), k)
    got_w, got_e = pmoe.route_topk(torch.tensor(lg), k)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **WEIGHTS)
    # where torch.topk itself would order the ties otherwise
    if probs == [.1, .3, .3, .2, .3, .05]:
        assert got_e[0].tolist() == [1, 2]


def _experts(seed, t, e, k, skew=None):
    rng = np.random.default_rng(seed)
    if skew is not None:   # every token's first pick is expert `skew`
        rest = [rng.permutation([x for x in range(e) if x != skew])[:k - 1]
                for _ in range(t)]
        return np.stack([np.concatenate([[skew], r]) for r in rest]).astype(
            np.int32)
    return np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(
        np.int32)


@pytest.mark.parametrize("t, e, k, cap, skew", [
    (64, 8, 2, 20, None),     # the smoke prefill's capacity (1.25)
    (64, 8, 2, 64, None),     # no_drop: capacity t
    (64, 8, 2, 3, None),      # most assignments overflow
    (50, 8, 3, 1, 0),         # capacity 1, one expert wanted by all
    (17, 4, 3, 17, 2),        # no_drop with a skewed expert
], ids=["cf-1.25", "no-drop", "overflow", "capacity-1", "skew-no-drop"])
def test_build_dispatch_bit_equal_to_the_reference(t, e, k, cap, skew):
    ex = _experts(t * e + cap, t, e, k, skew)
    want_d, want_c = rmoe.build_dispatch(jnp.asarray(ex), e, cap)
    got_d, got_c = pmoe.build_dispatch(torch.tensor(ex), e, cap)
    assert got_d.dtype == got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    dropped = int((got_c < 0).sum())
    counts = np.bincount(ex.reshape(-1), minlength=e)
    assert dropped == int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("t", [1, 4, 7, 64, 4096, 8192])
def test_capacity_is_the_reference_rule(t):
    for e, k in ((8, 2), (64, 6), (160, 6)):
        want = min(max(int(k * t * 1.25 / e), 1), t)
        assert pmoe.capacity_of(t, e, k, 1.25, False) == want
        assert pmoe.capacity_of(t, e, k, 1.25, True) == t


def _ffn_inputs(seed, t=64, d=16, e=8, f=12):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, d)).astype(np.float32),
            rng.standard_normal((d, e)).astype(np.float32),
            (rng.standard_normal((e, d, f)) * .3).astype(np.float32),
            (rng.standard_normal((e, d, f)) * .3).astype(np.float32),
            (rng.standard_normal((e, f, d)) * .3).astype(np.float32))


@pytest.mark.parametrize("no_drop", [False, True], ids=["capacity", "no-drop"])
@pytest.mark.parametrize("shape", [(64, 16, 8, 12, 2), (40, 24, 16, 8, 6)],
                         ids=["smoke", "top-6"])
def test_moe_ffn_matches_the_reference(shape, no_drop):
    t, d, e, f, k = shape
    args = _ffn_inputs(sum(shape), t, d, e, f)
    want = rmoe.moe_ffn(*map(jnp.asarray, args), k, 1.25, no_drop)
    got = pmoe.moe_ffn(*map(torch.tensor, args), k, 1.25, no_drop)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN)


@pytest.mark.parametrize("no_drop", [False, True], ids=["capacity", "no-drop"])
def test_moe_ffn_gradients_match_the_reference(no_drop):
    args = _ffn_inputs(11)
    dy = np.random.default_rng(12).standard_normal((64, 16)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda *a: rmoe.moe_ffn(*a, 2, 1.25, no_drop),
                     *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dy))
    leaves = [torch.tensor(a).requires_grad_() for a in args]
    out = pmoe.moe_ffn(*leaves, 2, 1.25, no_drop)
    got = torch.autograd.grad(out, leaves, torch.tensor(dy))
    for name, a, b in zip(("x", "router", "gate", "up", "down"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRADS,
                                   err_msg=name)


# ------------------------------------------------------------------ params
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
    return np.random.default_rng(8).integers(0, 256, (2, 128))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_layout_matches_the_reference(arch):
    """``dense_layer_0`` at d_ff, ``layers`` stacked over
    ``n_scan_layers``, the reference's leaves, shapes and dtypes."""
    pcfg, rcfg = _cfgs(arch)
    params = ptf.init(pcfg, seed=0, device="cpu")
    got = dict(_flatten(params))
    want = {k: np.asarray(v) for k, v in _flatten(
        rtf.init(jax.random.PRNGKey(0), rcfg)[0])}
    assert got.keys() == want.keys()
    assert list(params) == list(rtf.init(jax.random.PRNGKey(0), rcfg)[0])
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert got[name].dtype == torch.float32, name
    n = pcfg.n_scan_layers
    assert n == pcfg.n_layers - 1
    assert got["layers/w_gate"].shape == (n, 8, 64, 32)
    assert got["layers/router"].shape == (n, 64, 8)
    assert got["layers/ws_down"].shape == (n, 64, 64)
    assert got["dense_layer_0/w_gate"].shape == (64, 160)
    bf = ptf.init(dataclasses.replace(pcfg, dtype="bfloat16"), device="cpu")
    assert bf["layers"]["w_up"].dtype == torch.bfloat16
    assert bf["dense_layer_0"]["w_down"].dtype == torch.bfloat16


def test_expert_stacks_scale_is_the_reference_rule():
    """fan_in = the leaf's first dim, as the reference's ``ParamBuilder``
    takes it: E for the expert stacks (E, D, F) and (E, F, D), so their
    scale is 1/sqrt(E), not 1/sqrt(D)."""
    cfg = dataclasses.replace(pmoon.make_smoke_config(), n_experts=4,
                              d_ff_expert=256, d_model=256, n_layers=2)
    params = ptf.init(cfg, seed=1, device="cpu")
    ref = rtf.init(jax.random.PRNGKey(1), dataclasses.replace(
        rmoon.make_smoke_config(), n_experts=4, d_ff_expert=256,
        d_model=256, n_layers=2))[0]
    for name in ("w_gate", "w_up", "w_down"):
        got = float(params["layers"][name].std())
        want = float(np.asarray(ref["layers"][name]).std())
        assert abs(got * math.sqrt(4) - 1.0) < 0.02, name
        assert abs(want * math.sqrt(4) - 1.0) < 0.02, name
    # and the router, the shared experts and the dense layer by their D
    for name, fan_in in (("layers/router", 256), ("layers/ws_gate", 256),
                         ("dense_layer_0/w_gate", 256)):
        leaf = dict(_flatten(params))[name]
        assert abs(float(leaf.std()) * math.sqrt(fan_in) - 1.0) < 0.05, name


def test_stacked_leaves_are_drawn_one_layer_at_a_time():
    """A stacked leaf is its layers drawn one after another from the
    generator, each scaled by the unstacked fan-in."""
    gen = torch.Generator().manual_seed(5)
    got = pparam.normal((4, 3, 2), gen, layers=3, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(5)
    want = torch.stack([torch.randn((4, 3, 2), generator=gen) / 2.0
                        for _ in range(3)]).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_convert_round_trip_is_exact_in_bf16(arch):
    _, rcfg = _cfgs(arch, dtype="bfloat16")
    rparams, _ = rtf.init(jax.random.PRNGKey(3), rcfg)
    pparams = convert.lm_params_from_jax(jax.tree.map(np.asarray, rparams))
    assert pparams["layers"]["w_gate"].dtype == torch.bfloat16
    assert pparams["dense_layer_0"]["w_gate"].dtype == torch.bfloat16
    back = dict(_flatten(convert.lm_params_to_jax(pparams)))
    want = dict(_flatten(rparams))
    assert back.keys() == want.keys()
    for name, b in want.items():
        assert np.array_equal(
            np.asarray(jnp.asarray(back[name], jnp.bfloat16)).view(np.uint16),
            np.asarray(b).view(np.uint16)), name


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_layout_matches_the_reference(arch):
    """One cache row per layer, dense layers first, as the reference's."""
    pcfg, rcfg = _cfgs(arch)
    got = ptf.init_cache(pcfg, 2, 16, device="cpu")
    want = rtf.init_cache(rcfg, 2, 16)
    assert sorted(got) == sorted(want)
    for key in got:
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].shape[0] == pcfg.n_layers
        assert not bool(got[key].any())


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("path", ["dense", "flash"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_matches_the_reference(models, toks, arch, path,
                                       monkeypatch):
    pcfg, pparams, rcfg, rparams = models[arch]
    n = 32 if path == "dense" else 128
    if path == "flash":
        pcfg = dataclasses.replace(pcfg, **PREFILL_FLASH)
        rcfg = dataclasses.replace(rcfg, **PREFILL_FLASH)
    calls, routed = [], []
    plain = flash_ops.flash_attention_plain
    route = pmoe.route_topk

    def counted(*args, **kw):
        calls.append((args[0].shape, args[2].shape))
        return plain(*args, **kw)

    def recorded(*args, **kw):
        out = route(*args, **kw)
        routed.append(out[1].shape)
        return out

    monkeypatch.setattr(flash_ops, "flash_attention_plain", counted)
    monkeypatch.setattr(pmoe, "route_topk", recorded)
    got = ptf.prefill(pparams, pcfg, torch.tensor(toks[:, :n]))
    want = rtf.prefill(rparams, rcfg, jnp.asarray(toks[:, :n]))
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)
    # the dense layer routes nothing; each MoE layer routes all tokens
    assert routed == [(2 * n, pcfg.top_k)] * pcfg.n_scan_layers
    if path == "dense":
        assert calls == []
        return
    assert len(calls) == pcfg.n_layers            # one flash call a layer
    if arch == "deepseek":                        # q/k 24 wide, v 16
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
    for key in cache:
        np.testing.assert_allclose(_np(cache[key]), np.asarray(rcache[key]),
                                   **LOGITS, err_msg=key)
        assert not bool(cache[key][:, :, 8:].any())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_routes_without_drops(models, toks, arch, monkeypatch):
    """A cached step routes at capacity T (no drop): every (token, k)
    assignment gets a slot."""
    pcfg, pparams, _, _ = models[arch]
    slots = []
    build = pmoe.build_dispatch

    def recorded(experts, n_experts, capacity):
        out = build(experts, n_experts, capacity)
        slots.append((capacity, experts.shape[0], int((out[1] < 0).sum())))
        return out

    monkeypatch.setattr(pmoe, "build_dispatch", recorded)
    _port_decode(pcfg, pparams, toks, 3)
    assert len(slots) == 3 * pcfg.n_scan_layers
    assert all(cap == t == 2 and dropped == 0 for cap, t, dropped in slots)


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
    _, pparams, _, rparams = models[arch]
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
    # every MoE layer's router and experts, and the dense layer, learn
    for name in ("router", "w_gate", "ws_gate"):
        g = got_grads["layers"][name].abs().flatten(1).amax(dim=1)
        assert bool((g > 0).all()), name
    assert bool(got_grads["dense_layer_0"]["w_gate"].abs().max() > 0)


def test_checkpoint_round_trip_of_an_moe_tree(models, tmp_path):
    """(params, AdamW state) of an MoE model, ``dense_layer_0`` included:
    the port's files byte-equal to the reference's, and restored into a
    fresh tree leaf for leaf."""
    pcfg, pparams, rcfg, rparams = models["deepseek"]
    opt = poptim.adamw(1e-3)
    pstate = opt.init(pparams)
    tree = (pparams, pstate)
    pck.save_checkpoint(str(tmp_path / "p"), 3, tree)
    rck.save_checkpoint(str(tmp_path / "r"), 3,
                        jax.tree.map(np.asarray, rparams))
    pck.save_checkpoint(str(tmp_path / "q"), 3, pparams)
    names = sorted(os.listdir(tmp_path / "r" / "step_0000000003"))
    assert any(n.startswith("dense_layer_0") for n in names)
    assert names == sorted(os.listdir(tmp_path / "q" / "step_0000000003"))
    for name in names:
        a = (tmp_path / "q" / "step_0000000003" / name).read_bytes()
        b = (tmp_path / "r" / "step_0000000003" / name).read_bytes()
        if name.endswith(".npy"):
            assert a == b, name
    fresh = ptf.init(pcfg, seed=7, device="cpu")
    restored, step = pck.restore_checkpoint(str(tmp_path / "p"),
                                            (fresh, opt.init(fresh)))
    assert step == 3
    flat_a, flat_b = pck._flatten(restored), pck._flatten(tree)
    assert flat_a.keys() == flat_b.keys()
    for key, x in flat_b.items():
        y = flat_a[key]
        assert (x == y) if isinstance(x, int) else torch.equal(x, y), key


@pytest.mark.parametrize("arch", list(ARCHS))
def test_launchers_run_the_smoke_config(arch, capsys, monkeypatch, tmp_path):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", IDS[arch],
                                     "--gen-len", "4", "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert "decoded 4 x 4" in out and "first sequence:" in out
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", IDS[arch], "--device", "cpu", "--steps", "5",
        "--ckpt-every", "5", "--ckpt-dir", str(tmp_path)])
    ptrain.main()
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"step 5: loss -?\d+\.\d{4} \(checkpointed\)",
                        lines[0])
