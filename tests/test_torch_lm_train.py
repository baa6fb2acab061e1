"""The port's LM training slice against the JAX reference, on the CPU.

The same numpy inputs go through both packages; the models run
``tinyllama-smoke`` (3 layers, d_model 64) with the reference's parameters
carried across by ``convert.lm_params_from_jax``. On the CPU the flash
wrapper runs its plain forward and ``flash_attention_bwd_plain``; the CUDA
backward kernel is held against that plain version on the card by
``chip_smoke.py`` (``phase_lm_train``), which also shows the kernel
launching on the training path. Here the ``FlashAttention`` Function's
CPU branch is checked to call the plain backward; its CUDA branch is left
to ``chip_smoke.py``.

Tolerances (float32 unless stated):
- schedules and SGD: rtol 1e-6 (one float32 rounding of a few operations);
- the attention gradient against ``jax.vjp`` of the reference's
  ``blockwise_attention``: atol 1e-5, rtol 1e-4 (another summation order);
- the plain forward's log-sum-exp against ``torch.logsumexp`` of the
  masked scores: atol 1e-5, rtol 1e-6 (an online max and sum against a
  two-pass one, l summed over at most 64 keys);
- bf16: the plain backward against ``jax.vjp`` of the reference in bf16,
  each gradient within 4e-2 of the exact gradient's largest |value|, and
  against the float32 exact gradient of the same bf16 inputs within 1e-2
  of it. The reference rounds to bf16 at more places (its scores, its
  accumulator, every intermediate of its autodiff) and lands up to 2.4e-2
  from the exact gradient at these shapes; the port rounds P and dS once
  each (2^-9 relative) and its outputs, and lands within 4.5e-3;
- ``lm_loss``: the value rtol 1e-5, gradients atol 1e-5 / rtol 1e-4
  (three layers of float32 in another order);
- three accumulated AdamW steps: parameters atol 1e-4, and 99.9% of the
  elements of each within 1e-5. AdamW divides each element's first moment
  by its own RMS, so where an element's gradient changes sign over the
  steps the update amplifies the gradients' float32 differences (held to
  atol 1e-5 / rtol 1e-4 above): the largest seen is 7.0e-5 in ``w_down``,
  0.7% of a step of lr 1e-2.
Remat is held bit for bit within the port.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as roptim
from repro.configs import greendygnn_sage as rsage
from repro.configs import tinyllama_1p1b as rtiny
from repro.launch import train as rtrain
from repro.models.lm import attention as rattn
from repro.models.lm import transformer as rtf
from repro_torch import convert
from repro_torch import optim as poptim
from repro_torch.configs import greendygnn_sage as psage
from repro_torch.configs import registry as preg
from repro_torch.configs import tinyllama_1p1b as ptiny
from repro_torch.kernels.flash_attention import flash_attention_bwd
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import train as ptrain
from repro_torch.models.lm import transformer as ptf
from repro_torch.optim.optimizers import tree_leaves
from _elsewhere import elsewhere
from _jax_release import release_jax_executables  # noqa: F401

SCHED = dict(rtol=1e-6, atol=0.0)
ATTN_GRAD = dict(atol=1e-5, rtol=1e-4)
LOSS = dict(rtol=1e-5, atol=0.0)
GRADS = dict(atol=1e-5, rtol=1e-4)
STEP_PARAMS = dict(atol=1e-4, rtol=0.0)
FLASH = dict(blockwise_threshold=16, attn_block_k=16)


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


# --------------------------------------------------------------- optimizers
@pytest.mark.parametrize("kind", ["cosine", "warmup_cosine"])
def test_schedules_match_the_reference(kind):
    w, total = 7, 50
    if kind == "cosine":
        got, want = (poptim.cosine_schedule(3e-4, total, 0.1),
                     roptim.cosine_schedule(3e-4, total, 0.1))
    else:
        got, want = (poptim.warmup_cosine_schedule(3e-4, w, total),
                     roptim.warmup_cosine_schedule(3e-4, w, total))
    for step in (0, 1, w - 1, w, w + 1, total, total + 5):
        g = got(step)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(
            float(g), float(want(jnp.asarray(step, jnp.int32))), **SCHED)


def _grads(rng, n=3):
    return [{"a": rng.standard_normal((4, 3)).astype(np.float32),
             "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
            for _ in range(n)]


def _run_both(popt, ropt, params, grads):
    pp = {"a": torch.tensor(params["a"]),
          "b": {"c": torch.tensor(params["b"]["c"])}}
    rp = jax.tree.map(jnp.asarray, params)
    ps, rs = popt.init(pp), ropt.init(rp)
    for g in grads:
        pg = {"a": torch.tensor(g["a"]), "b": {"c": torch.tensor(g["b"]["c"])}}
        upd, ps = popt.update(pg, ps, pp)
        pp = poptim.apply_updates(pp, upd)
        rupd, rs = ropt.update(jax.tree.map(jnp.asarray, g), rs, rp)
        rp = roptim.apply_updates(rp, rupd)
    return pp, ps, rp, rs


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_the_reference(momentum):
    rng = np.random.default_rng(11)
    params = _grads(rng, 1)[0]
    sched = (poptim.cosine_schedule(0.1, 10),
             roptim.cosine_schedule(0.1, 10))
    pp, ps, rp, rs = _run_both(poptim.sgd(sched[0], momentum),
                               roptim.sgd(sched[1], momentum), params,
                               _grads(rng))
    assert ps.step == int(rs.step) == 3
    for (name, got), (_, want) in zip(_flatten(pp), _flatten(rp)):
        np.testing.assert_allclose(_np(got), _np(want), **SCHED, err_msg=name)
    for got, want in zip(tree_leaves(ps.mu), jax.tree.leaves(rs.mu)):
        np.testing.assert_allclose(_np(got), _np(want), **SCHED)
    # nu is carried unchanged
    assert all(not bool(t.any()) for t in tree_leaves(ps.nu))


def test_adamw_with_a_schedule_matches_the_reference():
    rng = np.random.default_rng(12)
    params = _grads(rng, 1)[0]
    pp, ps, rp, rs = _run_both(
        poptim.adamw(poptim.warmup_cosine_schedule(1e-2, 2, 10),
                     weight_decay=0.1, max_grad_norm=1.0),
        roptim.adamw(roptim.warmup_cosine_schedule(1e-2, 2, 10),
                     weight_decay=0.1, max_grad_norm=1.0),
        params, _grads(rng))
    for (name, got), (_, want) in zip(_flatten(pp), _flatten(rp)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_clip_keeps_bf16_leaves_in_float32():
    """As jnp promotes ``bf16 * f32``: the clipped leaf is float32."""
    g = {"w": torch.full((4,), 3.0, dtype=torch.bfloat16)}
    clipped, norm = poptim.clip_by_global_norm(g, 1.0)
    assert clipped["w"].dtype == torch.float32
    want, _ = roptim.clip_by_global_norm(
        {"w": jnp.full((4,), 3.0, jnp.bfloat16)}, 1.0)
    np.testing.assert_allclose(_np(clipped["w"]), _np(want["w"]), rtol=1e-6)
    assert float(norm) == 6.0


# ------------------------------------------------------- attention gradient
def _attn_inputs(seed, g, s=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((2, s, 2 * g, 32), (2, s, 2, 32), (2, s, 2, 32),
                       (2, s, 2 * g, 32))]


@pytest.mark.parametrize("g", [1, 4], ids=["mha", "gqa4"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bwd_plain_matches_jax_grad_of_the_reference(g, causal):
    q, k, v, do = _attn_inputs(20 + g, g)
    _, vjp = jax.vjp(lambda a, b, c: rattn.blockwise_attention(
        a, b, c, causal=causal, block_k=16), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.tensor, (q, k, v, do))
    o = flash_ops.flash_attention_plain(tq, tk, tv, causal, 16, 16)
    got = flash_ops.flash_attention_bwd_plain(tq, tk, tv, o, tdo, causal)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(_np(a), _np(b), **ATTN_GRAD,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("g", [1, 4], ids=["mha", "gqa4"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bwd_plain_matches_torch_autograd(g, causal):
    q, k, v, do = map(torch.tensor, _attn_inputs(30 + g, g))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = flash_ops.flash_attention_plain(*leaves, causal, 16, 16)
    want = torch.autograd.grad(o, leaves, do)
    got = flash_ops.flash_attention_bwd_plain(q, k, v, o.detach(), do,
                                              causal, block_q=32)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(_np(a), _np(b), **ATTN_GRAD,
                                   err_msg=f"d{name}")


def test_flash_attention_carries_the_function_only_under_grad(monkeypatch):
    """The Function's CPU branch calls the plain backward with the
    forward's log-sum-exp (its CUDA branch, the kernel, is checked by
    chip_smoke.py); without grad the wrapper returns the plain forward's
    tensor, with no graph."""
    q, k, v, do = map(torch.tensor, _attn_inputs(40, 4, 32))
    calls = []
    plain = flash_ops.flash_attention_bwd_plain

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)

    monkeypatch.setattr(flash_ops, "flash_attention_bwd_plain", counted)
    with torch.no_grad():
        assert flash_ops.flash_attention(q, k, v, True, 16, 16).grad_fn is None
    qr = q.clone().requires_grad_()
    o = flash_ops.flash_attention(qr, k, v, True, 16, 16)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    (dq,) = torch.autograd.grad(o, qr, do)
    assert calls == [q.shape]
    assert flash_attention_bwd.launches == 0   # the CPU launches nothing
    _, lse = flash_ops.flash_attention_lse(q, k, v, True, 16, 16)
    np.testing.assert_allclose(
        _np(dq), _np(plain(q, k, v, o.detach(), do, True, lse=lse)[0]),
        rtol=0, atol=0)


def _lse():
    """The forward's lse for (1, 8, 2, D) operands: (B, Hq, Sq)."""
    return torch.zeros(1, 2, 8)


def test_bwd_refuses_other_devices_and_checks_kernel_operands():
    q, k, v, do = (elsewhere(torch.zeros(1, 8, 2, 32)) for _ in range(4))
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_bwd(q, k, v, q, do)
    # the launch's checks run before anything is built: CPU tensors and a
    # head dim the kernel is not compiled for are refused
    cpu = [torch.zeros(1, 8, 2, 32) for _ in range(8)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_ops.launch_bwd(*cpu[:5], _lse(), *cpu[5:], True)
    odd = [torch.zeros(1, 8, 2, 24) for _ in range(8)]
    with pytest.raises(ValueError, match="compiled"):
        flash_ops.launch_bwd(*odd[:5], _lse(), *odd[5:], True)


def _bf16_operands():
    return [torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16) for _ in range(8)]


def _misaligned(ops):
    """q starting 2 bytes past a 16-byte boundary."""
    flat = torch.zeros(1 + 8 * 2 * 32, dtype=torch.bfloat16)
    return [flat[1:].view(1, 8, 2, 32)] + ops[1:]


def _odd_stride(ops):
    """k as a head view of rows 36 elements apart (72 bytes)."""
    return ops[:1] + [torch.zeros(1, 8, 2, 36, dtype=torch.bfloat16)
                      [..., :32]] + ops[2:]


@pytest.mark.parametrize("case, lse, match", [
    ("misaligned", _lse(), "16-byte boundary"),
    ("odd stride", _lse(), "multiples of 8"),
    ("lse shape", torch.zeros(1, 8, 2), "lse must be"),
    ("lse dtype", torch.zeros(1, 2, 8, dtype=torch.bfloat16), "lse must be"),
    ("lse strided", torch.zeros(1, 8, 2).transpose(1, 2), "lse must be"),
])
def test_launch_bwd_refuses_misaligned_operands_and_a_wrong_lse(case, lse,
                                                                match):
    """``launch_bwd``'s operand checks hold on the CPU, before a device
    or a build is asked for: bf16 operands must start on 16-byte
    boundaries with (b, s, h) strides in multiples of 8 elements (the
    kernels' 16-byte ``cp.async`` copies), and ``lse`` must be the
    forward's contiguous float32 (B, Hq, Sq)."""
    ops = _bf16_operands()
    ops = {"misaligned": _misaligned, "odd stride": _odd_stride}.get(
        case, lambda x: x)(ops)
    with pytest.raises(ValueError, match=match):
        flash_ops.launch_bwd(*ops[:5], lse, *ops[5:], True)
    # the well-formed operands pass every check and stop only at the device
    good = _bf16_operands()
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_ops.launch_bwd(*good[:5], _lse(), *good[5:], True)


def test_launch_bwd_takes_any_stride_along_a_dim_of_size_one():
    """A batch of one may carry any batch stride, also in a tensor
    PyTorch calls contiguous (as the model's ``do.contiguous()`` does
    after a transpose): the kernels never step along it, so the checks
    pass it, and the launch hands the kernels a stride of 0 there."""
    ops = _bf16_operands()
    ops[4] = ops[4].as_strided(ops[4].shape, (1, 64, 32, 1))
    assert ops[4].is_contiguous()
    assert flash_ops.bsh_strides(ops[4]) == (0, 64, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_ops.launch_bwd(*ops[:5], _lse(), *ops[5:], True)


@pytest.mark.parametrize("g", [1, 4], ids=["mha", "gqa4"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_forward_lse_is_the_logsumexp_of_the_masked_scores(g, causal):
    """The log-sum-exp the plain forward returns (the kernels' ``lse``
    output, the backward's ``L``) from its online max and sum, against
    ``torch.logsumexp`` of the scaled, masked scores; its ``o`` is the
    forward's without ``lse``."""
    q, k, v, _ = map(torch.tensor, _attn_inputs(60 + g, g))
    o, lse = flash_ops.flash_attention_lse(q, k, v, causal, 16, 16)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    assert torch.equal(o, flash_ops.flash_attention(q, k, v, causal, 16, 16))
    kf = k.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kf) / q.shape[-1] ** 0.5
    if causal:
        pos = torch.arange(q.shape[1])
        s = s.masked_fill(pos[None, :] > pos[:, None], flash_ops.NEG_INF)
    np.testing.assert_allclose(_np(lse), _np(torch.logsumexp(s, dim=-1)),
                               atol=1e-5, rtol=1e-6)


def _bf16_case(seed, g):
    """bf16 inputs (rounded from seeded float32 draws) as numpy float32."""
    return [np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
            for x in _attn_inputs(seed, g)]


def _bf16_plain_grads(q, k, v, do, causal):
    tq, tk, tv, tdo = (torch.tensor(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    o, lse = flash_ops.flash_attention_lse(tq, tk, tv, causal, 16, 16)
    got = flash_ops.flash_attention_bwd_plain(tq, tk, tv, o, tdo, causal,
                                              lse=lse)
    assert all(x.dtype == torch.bfloat16 for x in got)
    return got


def _exact_grads(q, k, v, do, causal):
    """The float32 gradient of the float32 forward at the same values."""
    leaves = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
    o = flash_ops.flash_attention_plain(*leaves, causal, 16, 16)
    return torch.autograd.grad(o, leaves, torch.tensor(do))


@pytest.mark.parametrize("g", [1, 4], ids=["mha", "gqa4"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bf16_bwd_plain_matches_jax_grad_of_the_reference_in_bf16(g, causal):
    q, k, v, do = _bf16_case(70 + g, g)
    _, vjp = jax.vjp(lambda a, b, c: rattn.blockwise_attention(
        a, b, c, causal=causal, block_k=16),
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    want = vjp(jnp.asarray(do, jnp.bfloat16))
    got = _bf16_plain_grads(q, k, v, do, causal)
    for name, a, b, c in zip("qkv", got, want,
                             _exact_grads(q, k, v, do, causal)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                   atol=4e-2 * float(c.abs().max()),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("g", [1, 4], ids=["mha", "gqa4"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bf16_bwd_plain_is_near_the_float32_gradient(g, causal):
    q, k, v, do = _bf16_case(80 + g, g)
    got = _bf16_plain_grads(q, k, v, do, causal)
    for name, a, b in zip("qkv", got, _exact_grads(q, k, v, do, causal)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                   atol=1e-2 * float(b.abs().max()),
                                   err_msg=f"d{name}")


# --------------------------------------------------------------------- loss
def _cfgs(**kw):
    return (dataclasses.replace(ptiny.make_smoke_config(), **kw),
            dataclasses.replace(rtiny.make_smoke_config(), **kw))


@pytest.fixture(scope="module")
def ref_params():
    _, rcfg = _cfgs()
    rparams, _ = rtf.init(jax.random.PRNGKey(0), rcfg)
    return rparams, convert.lm_params_from_jax(
        jax.tree.map(np.asarray, rparams))


@pytest.fixture(scope="module")
def toks():
    rng = np.random.default_rng(8)
    return rng.integers(0, 256, (2, 64)), rng.integers(0, 256, (2, 64))


LOSS_CASES = {"dense": {}, "blockwise": FLASH, "chunked": dict(loss_chunk=16)}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_lm_loss_and_grads_match_the_reference(ref_params, toks, case):
    pcfg, rcfg = _cfgs(**LOSS_CASES[case])
    rparams, pparams = ref_params
    tokens, targets = toks
    want_loss, want_grads = jax.value_and_grad(rtf.lm_loss)(
        rparams, rcfg, jnp.asarray(tokens), jnp.asarray(targets))
    got_loss, got_grads = ptrain.value_and_grad(
        pparams, pcfg, torch.tensor(tokens), torch.tensor(targets))
    np.testing.assert_allclose(float(got_loss), float(want_loss), **LOSS)
    flat_want = dict(_flatten(want_grads))
    flat_got = dict(_flatten(got_grads))
    assert flat_got.keys() == flat_want.keys()
    for name, w in flat_want.items():
        assert flat_got[name].dtype == torch.float32, name
        np.testing.assert_allclose(_np(flat_got[name]), _np(w), **GRADS,
                                   err_msg=name)


def test_blockwise_loss_goes_through_the_plain_backward(ref_params, toks,
                                                        monkeypatch):
    pcfg, _ = _cfgs(**FLASH)
    calls = []
    plain = flash_ops.flash_attention_bwd_plain

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)

    monkeypatch.setattr(flash_ops, "flash_attention_bwd_plain", counted)
    _, grads = ptrain.value_and_grad(ref_params[1], pcfg,
                                     *map(torch.tensor, toks))
    assert len(calls) == pcfg.n_layers   # one backward a layer
    for name in ("wq", "wk", "wv"):
        assert bool(grads["layers"][name].abs().sum() > 0), name


@pytest.mark.parametrize("case", ["blockwise", "chunked"])
def test_remat_is_bit_identical(ref_params, toks, case):
    pcfg, _ = _cfgs(**LOSS_CASES[case])
    tokens, targets = map(torch.tensor, toks)
    plain = ptrain.value_and_grad(ref_params[1], pcfg, tokens, targets)
    remat = ptrain.value_and_grad(
        ref_params[1], dataclasses.replace(pcfg, remat=True), tokens,
        targets)
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(tree_leaves(plain[1]), tree_leaves(remat[1])):
        assert torch.equal(a, b)


def test_forward_mode_remats_only_in_training(ref_params, monkeypatch):
    pcfg, _ = _cfgs(remat=True)
    calls = []
    real = ptf.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(ptf, "checkpoint", counted)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    ptf.forward(ref_params[1], pcfg, tokens, mode="prefill")
    ptf.prefill(ref_params[1], pcfg, tokens)
    assert calls == []
    ptf.forward(ref_params[1], pcfg, tokens)   # mode="train"
    assert calls == ["_layer_apply"] * pcfg.n_layers


# --------------------------------------------------------------------- step
def _reference_step(rcfg, ropt, accum):
    """``repro/launch/cell.py``'s train step (lines 91-122), without the
    mesh and its sharding rules."""

    def step_fn(params, opt_state, tokens, targets):
        b, s = tokens.shape
        tm = tokens.reshape(accum, b // accum, s)
        gm = targets.reshape(accum, b // accum, s)

        def micro(acc, xs):
            t, g = xs
            l, gr = jax.value_and_grad(rtf.lm_loss)(params, rcfg, t, g)
            acc_g, acc_l = acc
            return (jax.tree.map(jnp.add, acc_g, gr), acc_l + l), None

        zero = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        (gsum, lsum), _ = jax.lax.scan(micro, (zero, jnp.asarray(0.0)),
                                       (tm, gm))
        grads = jax.tree.map(lambda g: g / accum, gsum)
        loss = lsum / accum
        updates, new_opt = ropt.update(grads, opt_state, params)
        return roptim.apply_updates(params, updates), new_opt, loss

    return jax.jit(step_fn)


def test_accumulated_warmup_cosine_steps_match_the_reference(ref_params):
    pcfg, rcfg = _cfgs(**FLASH)
    rparams, pparams = ref_params
    kw = dict(weight_decay=0.1, max_grad_norm=1.0)
    popt = poptim.adamw(poptim.warmup_cosine_schedule(1e-2, 2, 10), **kw)
    ropt = roptim.adamw(roptim.warmup_cosine_schedule(1e-2, 2, 10), **kw)
    pstep = ptrain.make_train_step(pcfg, popt, accum=2)
    rstep = _reference_step(rcfg, ropt, 2)
    ps, rs = popt.init(pparams), ropt.init(rparams)
    rng = np.random.default_rng(9)
    for _ in range(3):
        tokens = rng.integers(0, 256, (4, 32))
        targets = rng.integers(0, 256, (4, 32))
        pparams, ps, pl = pstep(pparams, ps, torch.tensor(tokens),
                                torch.tensor(targets))
        rparams, rs, rl = rstep(rparams, rs, jnp.asarray(tokens),
                                jnp.asarray(targets))
        np.testing.assert_allclose(float(pl), float(rl), **LOSS)
    assert ps.step == int(rs.step) == 3
    for (name, got), (_, want) in zip(sorted(_flatten(pparams)),
                                      sorted(_flatten(rparams))):
        np.testing.assert_allclose(_np(got), _np(want), **STEP_PARAMS,
                                   err_msg=name)
        close = np.abs(_np(got) - _np(want)) <= 1e-5
        assert close.mean() >= 0.999, (name, close.mean())


def test_train_step_refuses_a_batch_accum_does_not_divide(ref_params):
    pcfg, _ = _cfgs()
    step = ptrain.make_train_step(pcfg, poptim.adamw(1e-3), accum=3)
    with pytest.raises(ValueError, match="multiple of accum"):
        step(ref_params[1], None, torch.zeros((4, 8), dtype=torch.long),
             torch.zeros((4, 8), dtype=torch.long))


# ------------------------------------------------------------------ launcher
def _main(monkeypatch, capsys, *argv):
    monkeypatch.setattr("sys.argv", ["train", *argv])
    ptrain.main()
    return capsys.readouterr().out.splitlines()


NUM = r"-?\d+\.\d{4}"


def test_launcher_trains_checkpoints_and_resumes(monkeypatch, capsys,
                                                 tmp_path):
    ck = str(tmp_path / "ck")
    base = ["--arch", "tinyllama-1.1b", "--device", "cpu", "--ckpt-dir", ck]
    out = _main(monkeypatch, capsys, *base, "--steps", "10",
                "--ckpt-every", "5")
    assert len(out) == 3
    assert re.fullmatch(rf"step 5: loss {NUM} \(checkpointed\)", out[0])
    assert re.fullmatch(rf"step 10: loss {NUM} \(checkpointed\)", out[1])
    assert re.fullmatch(r"10 steps in \d+\.\ds", out[2])
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_0000000005", "step_0000000010"]

    out = _main(monkeypatch, capsys, *base, "--steps", "5", "--resume")
    assert out[0] == "resumed from step 10"
    assert re.fullmatch(rf"step 15: loss {NUM}", out[1])
    assert re.fullmatch(r"5 steps in \d+\.\ds", out[2])


def test_launcher_resume_without_a_checkpoint(monkeypatch, capsys, tmp_path):
    out = _main(monkeypatch, capsys, "--arch", "tinyllama-1.1b", "--device",
                "cpu", "--ckpt-dir", str(tmp_path / "none"), "--steps", "1",
                "--resume")
    assert out[0] == "no checkpoint found; starting fresh"


def test_launcher_refuses_a_gnn_arch_with_the_reference_message(monkeypatch):
    msgs = []
    for main in (ptrain.main, rtrain.main):
        monkeypatch.setattr("sys.argv", ["train", "--arch",
                                         "greendygnn-sage"])
        with pytest.raises(SystemExit) as info:
            main()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] and "GNN training" in msgs[0]


def test_launcher_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["train", "--arch", "tinyllama-1.1b",
                                     "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ptrain.main()


# -------------------------------------------------------------------- config
@pytest.mark.parametrize("make", ["make_config", "make_smoke_config"])
def test_greendygnn_sage_config_matches_the_reference(make):
    got = dataclasses.asdict(getattr(psage, make)())
    want = dataclasses.asdict(getattr(rsage, make)())
    assert got == want
    arch = preg.get_arch("greendygnn-sage")
    assert arch.family == rsage.ARCH.family == "gnn"
    assert arch.shapes == rsage.ARCH.shapes
    assert arch.model_module == "repro_torch.models.gnn.sage"
