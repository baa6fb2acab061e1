"""The port's flash attention against the JAX reference, on the CPU.

A port of ``TestFlashAttention`` (``tests/test_kernels.py``): the same
cases, with inputs drawn by numpy from a seed and handed to both sides.
On the CPU the port's wrappers take ``flash_attention_plain``, so these
tests hold the plain version (and the wrappers' layout and GQA mapping)
against the reference's Pallas kernel in interpret mode and its dense
oracle. The CUDA kernel is held against the same plain version on the
card by ``chip_smoke.py``.

Tolerances: float32 atol 2e-5 / rtol 1e-4 (the reference's own; sums
taken in another order), bf16 atol 4e-2 / rtol 2e-2 (the reference's
bf16 tolerance: p and the output are rounded to bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.flash_attention.kernel import (
    flash_attention_kernel as ref_kernel,
)
from repro.kernels.flash_attention.ref import attention_ref as ref_oracle
from repro.models.lm.attention import dense_attention as ref_dense
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_kernel,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.lm.attention import dense_attention
from _elsewhere import elsewhere
from _jax_release import release_jax_executables  # noqa: F401

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=4e-2, rtol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's thread pool only adds wake-up latency."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, q_shape, kv_shape=None):
    rng = np.random.default_rng(seed)
    kv_shape = kv_shape or q_shape
    return (rng.standard_normal(q_shape).astype(np.float32),
            rng.standard_normal(kv_shape).astype(np.float32),
            rng.standard_normal(kv_shape).astype(np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.tensor(a).to(dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("s,d,causal", [
    (128, 64, True), (256, 64, True), (128, 128, False), (512, 32, True),
])
def test_matches_reference_kernel(s, d, causal):
    q, k, v = _qkv(s + d, (3, s, d))
    got = flash_attention_kernel(*_t(q, k, v), causal=causal,
                                 block_q=64, block_k=64)
    want = ref_kernel(*_j(q, k, v), causal=causal, block_q=64, block_k=64,
                      interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)
    oracle = ref_oracle(*_j(q, k, v), causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(oracle), **F32)
    np.testing.assert_allclose(_f32(attention_ref(*_t(q, k, v), causal)),
                               _f32(oracle), **F32)


@pytest.mark.parametrize("block_q,block_k", [
    (32, 32), (64, 128), (128, 64),
    pytest.param(ops.TILE_Q, ops.TILE_K, id="bf16-kernel-tiles"),
])
def test_block_shape_sweep(block_q, block_k):
    q, k, v = _qkv(7, (2, 256, 32))
    got = flash_attention_kernel(*_t(q, k, v), causal=True,
                                 block_q=block_q, block_k=block_k)
    want = ref_kernel(*_j(q, k, v), causal=True, block_q=block_q,
                      block_k=block_k, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)
    np.testing.assert_allclose(
        _f32(got), _f32(ref_oracle(*_j(q, k, v), causal=True)), **F32)


def test_bf16():
    q, k, v = _qkv(9, (2, 128, 64))
    got = flash_attention_kernel(*_t(q, k, v, dtype=torch.bfloat16),
                                 causal=True, block_q=64, block_k=64)
    assert got.dtype == torch.bfloat16
    want = ref_kernel(*_j(q, k, v, dtype=jnp.bfloat16), causal=True,
                      block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16)
    # against the float32 oracle on the same bf16-rounded inputs
    qb, kb, vb = (np.asarray(x, np.float32)
                  for x in _j(q, k, v, dtype=jnp.bfloat16))
    oracle = ref_oracle(*_j(qb, kb, vb), causal=True)
    np.testing.assert_allclose(_f32(got), _f32(oracle), **BF16)


def test_bf16_at_the_kernel_tiles():
    """The plain version at the bf16 CUDA kernel's own tiles (the tiles
    at which the card holds the kernel against it) against the Pallas
    kernel at the same tiles: both round p after the same running max."""
    q, k, v = _qkv(29, (2, 256, 64))
    bq, bk = ops.TILE_Q, ops.TILE_K
    got = flash_attention_kernel(*_t(q, k, v, dtype=torch.bfloat16),
                                 causal=True, block_q=bq, block_k=bk)
    assert got.dtype == torch.bfloat16
    want = ref_kernel(*_j(q, k, v, dtype=jnp.bfloat16), causal=True,
                      block_q=bq, block_k=bk, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16)
    qb, kb, vb = (np.asarray(x, np.float32)
                  for x in _j(q, k, v, dtype=jnp.bfloat16))
    oracle = ref_oracle(*_j(qb, kb, vb), causal=True)
    np.testing.assert_allclose(_f32(got), _f32(oracle), **BF16)


def test_gqa_wrapper_matches_model_attention():
    q, k, v = _qkv(11, (2, 128, 8, 32), (2, 128, 2, 32))
    got = flash_attention(*_t(q, k, v), causal=True, block_q=64, block_k=64)
    want = ref_flash(*_j(q, k, v), causal=True, block_q=64, block_k=64,
                     interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)
    np.testing.assert_allclose(
        _f32(got), _f32(ref_dense(*_j(q, k, v), causal=True)), **F32)
    np.testing.assert_allclose(
        _f32(got), _f32(dense_attention(*_t(q, k, v), causal=True)), **F32)


def test_causal_with_more_keys_than_queries():
    """Sq != Sk: the mask compares positions from 0 on both sides, as the
    TPU kernel's does, and the skipped tiles above the diagonal add
    nothing."""
    q, k, v = _qkv(13, (2, 128, 32), (2, 256, 32))
    got = flash_attention_kernel(*_t(q, k, v), causal=True,
                                 block_q=32, block_k=64)
    want = ref_kernel(*_j(q, k, v), causal=True, block_q=32, block_k=64,
                      interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_single_block(causal):
    """S = 100 is a multiple of no tile of the CUDA kernel; with block =
    S the plain version runs it as one tile."""
    q, k, v = _qkv(17, (2, 100, 64))
    got = flash_attention_kernel(*_t(q, k, v), causal=causal,
                                 block_q=100, block_k=100)
    want = ref_oracle(*_j(q, k, v), causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)


def test_cpu_takes_the_plain_version_without_a_launch():
    q, k, v = _t(*_qkv(19, (1, 64, 2, 32)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    assert flash_attention.launches == before
    assert torch.equal(got, flash_attention_plain(q, k, v, True, 64, 64))


def test_wrapper_rejects_bad_operands():
    q, k, v = _t(*_qkv(23, (1, 64, 4, 32), (1, 64, 2, 32)))
    with pytest.raises(TypeError):          # dtype
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):          # mixed dtypes
        flash_attention(q, k.to(torch.bfloat16), v, block_q=64, block_k=64)
    with pytest.raises(ValueError):         # Hq not a multiple of Hkv
        flash_attention(q[:, :, :3], k, v, block_q=64, block_k=64)
    with pytest.raises(ValueError):         # q and k disagree on D
        flash_attention(q[..., :16], k, v, block_q=64, block_k=64)
    with pytest.raises(ValueError):         # k and v disagree
        flash_attention(q, k, v[:, :32], block_q=64, block_k=64)
    with pytest.raises(ValueError):         # S not a multiple of the block
        flash_attention(q, k, v, block_q=48, block_k=64)
    with pytest.raises(ValueError):         # (BH, S, D) wrapper: rank
        flash_attention_kernel(q, k, v)
    with pytest.raises(ValueError):         # unsupported device
        flash_attention(elsewhere(q), elsewhere(k), elsewhere(v),
                        block_q=64, block_k=64)
    # what the CUDA kernel needs beyond that: a compiled D, unit stride
    for d in (8, 16, 48, 256):
        qd, kd, vd = _t(*_qkv(d, (1, 64, 4, d), (1, 64, 2, d)))
        with pytest.raises(ValueError, match="compiled for D"):
            ops.check_kernel_operands(qd, kd, vd)
    strided = torch.zeros(1, 64, 4, 64)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        ops.check_kernel_operands(strided, k, v)
    ops.check_kernel_operands(q, k, v)
    # bf16 (16-byte cp.async copies): 16-byte aligned data_ptr and (b, s,
    # h) strides; float32 takes any of them
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    ops.check_kernel_operands(qb, kb, vb)
    ops.check_kernel_operands(qb[:, :, 1:3], kb[:, :, 1:], vb)  # 64 B apart
    padded = torch.zeros(1, 64, 4, 36, dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="strides"):    # s, h: 144, 36
        ops.check_kernel_operands(padded, kb, vb)
    odd_b = torch.zeros(2 * 4100, dtype=torch.bfloat16).as_strided(
        (2, 64, 2, 32), (4100, 64, 32, 1))              # b stride 4100
    with pytest.raises(ValueError, match="strides"):
        ops.check_kernel_operands(qb, odd_b, vb)
    flat = torch.zeros(64 * 4 * 32 + 4, dtype=torch.bfloat16)
    shifted = flat[4:].view(1, 64, 4, 32)                # 8 bytes off
    with pytest.raises(ValueError, match="16-byte boundary"):
        ops.check_kernel_operands(shifted, kb, vb)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ops.check_kernel_operands(qb, kb, flat[4:4 + 64 * 2 * 32].view(
            1, 64, 2, 32))
    ops.check_kernel_operands(padded.float(), k, v)     # float32: no rule
    ops.check_kernel_operands(shifted.float(), k, v)
