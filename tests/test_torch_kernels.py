"""The port's kernel modules against the JAX reference, on the CPU.

On the CPU each wrapper takes its plain PyTorch version, so these tests
hold the plain versions (and the formats and wrappers around them) against
the reference: ``block_spmm_xla``, the ``spmm_ref`` scatter oracle, the
Pallas kernels in interpret mode (as ``tests/test_kernels.py`` runs them),
and the reference device tier. The SpMM runs the trainer's CSR
(``to_csr`` at the reference's padded shape, ``csr_spmm``, ``Spmm``); the
reference's block format (``to_block_sparse``) is held bit for bit. The
CUDA kernels themselves are held against the same plain versions on the
card by ``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.windowed_cache import DoubleBufferedCache as RefCache
from repro.kernels.embedding_bag import embedding_bag_pallas
from repro.kernels.segment_mm import block_spmm_xla, segment_mm
from repro.kernels.segment_mm import to_block_sparse as ref_to_block_sparse
from repro.kernels.segment_mm.ref import spmm_ref as ref_spmm
from repro.store import DevicePayloadTier as RefTier
from repro_torch.core.windowed_cache import DoubleBufferedCache
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.segment_mm import (
    CsrFormat,
    Spmm,
    csr_spmm,
    to_block_sparse,
    to_csr,
    transpose_csr,
)
from repro_torch.kernels.segment_mm.ref import spmm_ref
from repro_torch.store import DevicePayloadTier
from _elsewhere import elsewhere
from _jax_release import release_jax_executables  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)

# (n_src, n_dst, n_edges, f, tile, weighted)
SPMM_CASES = [
    (300, 260, 2000, 70, 64, False),     # ragged: nothing divides the tile
    (1000, 50, 4000, 32, 64, True),      # many-to-few, weighted
    (64, 700, 300, 16, 32, False),       # sparse rows: many empty dst blocks
    (130, 90, 0, 8, 32, False),          # no edges at all: zero blocks only
    (256, 256, 3000, 64, 128, True),     # the main path's tile
]


def _graph(n_src, n_dst, n_edges, f, weighted):
    rng = np.random.default_rng(n_src * 7 + n_dst + n_edges)
    src = rng.integers(0, n_src, n_edges)
    dst = rng.integers(0, n_dst, n_edges)
    x = rng.standard_normal((n_src, f)).astype(np.float32)
    w = rng.standard_normal(n_edges).astype(np.float32) if weighted else None
    return src, dst, x, w


def _pad_rows(x, rows):
    out = np.zeros((rows, x.shape[1]), np.float32)
    out[: len(x)] = x
    return out


class TestSegmentMM:
    @pytest.mark.parametrize("case", SPMM_CASES)
    def test_format_bit_equal_to_reference(self, case):
        n_src, n_dst, n_edges, f, t, weighted = case
        src, dst, _, w = _graph(n_src, n_dst, n_edges, f, weighted)
        got = to_block_sparse(src, dst, n_dst, n_src, t, t, w)
        want = ref_to_block_sparse(src, dst, n_dst, n_src, t, t, w)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("case", SPMM_CASES)
    def test_plain_matches_xla_twin_and_oracles(self, case):
        n_src, n_dst, n_edges, f, t, weighted = case
        src, dst, x, w = _graph(n_src, n_dst, n_edges, f, weighted)
        rows, cols, blocks, ndb, n_src_pad = to_block_sparse(
            src, dst, n_dst, n_src, t, t, w
        )
        xp = _pad_rows(x, n_src_pad)
        got = csr_spmm(_csr(src, dst, w, ndb * t, n_src_pad),
                       torch.as_tensor(xp)).numpy()
        twin = np.asarray(block_spmm_xla(
            jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(blocks),
            jnp.asarray(xp), ndb, tn=t, tm=t,
        ))
        np.testing.assert_allclose(got, twin, **TOL)
        ref = np.asarray(ref_spmm(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(x), n_dst,
            None if w is None else jnp.asarray(w),
        ))
        np.testing.assert_allclose(got[:n_dst], ref, **TOL)
        port_ref = spmm_ref(
            torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(x),
            n_dst, None if w is None else torch.as_tensor(w),
        ).numpy()
        np.testing.assert_allclose(port_ref, ref, **TOL)

    @pytest.mark.parametrize("case", SPMM_CASES[:3])
    def test_plain_matches_pallas_interpret(self, case):
        n_src, n_dst, n_edges, f, t, weighted = case
        src, dst, x, w = _graph(n_src, n_dst, n_edges, f, weighted)
        pallas = np.asarray(segment_mm(
            src, dst, jnp.asarray(x), n_dst, edge_weight=w, tn=t, tm=t,
            tf=64, interpret=True,
        ))
        n_dst_pad, n_src_pad = -(-n_dst // t) * t, -(-n_src // t) * t
        got = csr_spmm(_csr(src, dst, w, n_dst_pad, n_src_pad),
                       torch.as_tensor(_pad_rows(x, n_src_pad))
                       ).numpy()[:n_dst]
        np.testing.assert_allclose(got, pallas, **TOL)

    @pytest.mark.parametrize("case", SPMM_CASES)
    def test_transposed_backward_matches_autograd_of_oracle(self, case):
        n_src, n_dst, n_edges, f, t, weighted = case
        src, dst, x, w = _graph(n_src, n_dst, n_edges, f, weighted)
        n_dst_pad, n_src_pad = -(-n_dst // t) * t, -(-n_src // t) * t
        fwd = _csr(src, dst, w, n_dst_pad, n_src_pad)
        bwd = CsrFormat.from_numpy(
            *transpose_csr(*to_csr(src, dst, n_dst_pad, n_src_pad, w),
                           n_src_pad), n_dst_pad, "cpu")
        rng = np.random.default_rng(n_edges)
        dy = rng.standard_normal((n_dst_pad, f)).astype(np.float32)
        xt = torch.as_tensor(_pad_rows(x, n_src_pad)).requires_grad_(True)
        y = Spmm.apply(xt, fwd, bwd)
        (dx,) = torch.autograd.grad(y, xt, grad_outputs=torch.as_tensor(dy))
        # the reference's autodiff of its scatter oracle
        _, vjp = jax.vjp(
            lambda xx: ref_spmm(
                jnp.asarray(src), jnp.asarray(dst), xx, n_dst,
                None if w is None else jnp.asarray(w),
            ),
            jnp.asarray(x),
        )
        (want,) = vjp(jnp.asarray(dy[:n_dst]))
        np.testing.assert_allclose(dx.numpy()[:n_src], np.asarray(want),
                                   **TOL)
        assert not dx.numpy()[n_src:].any()  # padded source rows get nothing
        # and torch's own autograd of the port's oracle
        xo = torch.as_tensor(x).requires_grad_(True)
        yo = spmm_ref(torch.as_tensor(src), torch.as_tensor(dst), xo, n_dst,
                      None if w is None else torch.as_tensor(w))
        (dxo,) = torch.autograd.grad(yo, xo,
                                     grad_outputs=torch.as_tensor(dy[:n_dst]))
        np.testing.assert_allclose(dx.numpy()[:n_src], dxo.numpy(), **TOL)

    def test_no_transposed_format_means_no_input_gradient(self):
        src, dst, x, w = _graph(64, 64, 200, 8, False)
        fmt = _csr(src, dst, w, 64, 64)
        xt = torch.as_tensor(_pad_rows(x, 64)).requires_grad_(True)
        y = Spmm.apply(xt, fmt, None)
        with pytest.raises(RuntimeError, match="transposed format"):
            y.sum().backward()

    def test_wrapper_rejects_bad_operands(self):
        fmt = CsrFormat.from_numpy([0, 1], [0], [1.0], 32, "cpu")
        x = torch.zeros((32, 4))
        with pytest.raises(TypeError):
            csr_spmm(dataclasses.replace(fmt, col=fmt.col.long()), x)
        with pytest.raises(TypeError):
            csr_spmm(fmt, x.double())
        with pytest.raises(ValueError):
            csr_spmm(fmt, torch.zeros((30, 4)))
        with pytest.raises(ValueError):
            csr_spmm(dataclasses.replace(
                fmt, **{k: elsewhere(getattr(fmt, k))
                        for k in ("rowptr", "col", "val")}), elsewhere(x))


def _csr(src, dst, w, n_rows, n_cols):
    """The edge list's CSR at (n_rows, n_cols) on the CPU."""
    return CsrFormat.from_numpy(*to_csr(src, dst, n_rows, n_cols, w),
                                n_cols, "cpu")


class TestEmbeddingBag:
    def _table(self, rows, dim, seed):
        rng = np.random.default_rng(seed)
        return rng, rng.standard_normal((rows, dim)).astype(np.float32)

    @pytest.mark.parametrize("n,rows,dim", [(1, 10, 8), (37, 50, 16),
                                            (200, 300, 64)])
    def test_gather_bit_equal(self, n, rows, dim):
        """The device tier's use: one lookup per bag, pow2 padding with
        weight-0 pad bags; bit-equal to table[idx] and to the Pallas
        kernel."""
        rng, table = self._table(rows, dim, n)
        bucket = 1 << (n - 1).bit_length()
        idx = np.zeros(bucket, np.int32)
        idx[:n] = rng.integers(0, rows, n)
        w = np.zeros(bucket, np.float32)
        w[:n] = 1.0
        seg = np.arange(bucket, dtype=np.int32)
        got = embedding_bag(
            torch.as_tensor(table), torch.as_tensor(idx),
            torch.as_tensor(seg), bucket, torch.as_tensor(w),
        ).numpy()
        np.testing.assert_array_equal(got[:n], table[idx[:n]])
        pallas = np.asarray(embedding_bag_pallas(
            jnp.asarray(table), idx, seg, bucket, weights=jnp.asarray(w),
            interpret=True,
        ))
        np.testing.assert_array_equal(got, pallas)

    @pytest.mark.parametrize("rows,dim,lookups,bags", [
        (50, 8, 40, 10), (200, 64, 300, 32), (10, 16, 5, 8),
    ])
    def test_weighted_bags_match_pallas(self, rows, dim, lookups, bags):
        rng, table = self._table(rows, dim, lookups)
        idx = rng.integers(0, rows, lookups).astype(np.int32)
        seg = rng.integers(0, bags, lookups).astype(np.int32)
        w = rng.standard_normal(lookups).astype(np.float32)
        got = embedding_bag(
            torch.as_tensor(table), torch.as_tensor(idx),
            torch.as_tensor(seg), bags, torch.as_tensor(w),
        ).numpy()
        want = np.asarray(embedding_bag_pallas(
            jnp.asarray(table), idx, seg, bags, weights=jnp.asarray(w),
            interpret=True,
        ))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    def test_empty_bags_zeroed(self):
        table = torch.ones((5, 4))
        got = embedding_bag(table, torch.tensor([0, 1], dtype=torch.int32),
                            torch.tensor([0, 3], dtype=torch.int32), 5)
        want = np.asarray(embedding_bag_pallas(
            jnp.ones((5, 4)), jnp.asarray([0, 1], jnp.int32),
            jnp.asarray([0, 3], jnp.int32), 5, interpret=True,
        ))
        np.testing.assert_array_equal(got.numpy(), want)
        assert not got[[1, 2, 4]].any() and bool((got[[0, 3]] == 1).all())

    def test_wrapper_rejects_bad_operands(self):
        table = torch.zeros((4, 2))
        i32 = torch.zeros(3, dtype=torch.int32)
        with pytest.raises(TypeError):
            embedding_bag(table, i32.long(), i32, 2)
        with pytest.raises(TypeError):
            embedding_bag(table.double(), i32, i32, 2)
        with pytest.raises(ValueError):
            embedding_bag(table, i32, i32[:2], 2)
        with pytest.raises(ValueError):
            embedding_bag(table, i32, i32, 2, torch.ones(2))


class TestDevicePayloadTier:
    """The port's tier (kernel wrapper on the CPU) vs the reference's
    (Pallas interpreter), loaded from the same plans."""

    def _tiers(self, n=128, d=6, capacity=32, seed=0):
        rng = np.random.default_rng(seed)
        table = rng.standard_normal((n, d)).astype(np.float32)
        owner_idx = np.zeros(n, np.int64)
        tiers = []
        for cache_cls, tier_cls, kw in (
            (RefCache, RefTier, {}), (DoubleBufferedCache, DevicePayloadTier,
                                      {"device": "cpu"}),
        ):
            cache = cache_cls(capacity, owner_idx, n_owners=1)
            tier = tier_cls(cache, n_feat=d, **kw)
            tiers.append((tier, cache))
        hot = np.sort(rng.choice(n, size=capacity, replace=False))
        keep = hot[: capacity // 2]
        fresh = np.setdiff1d(np.arange(n), hot)[: capacity // 2]
        hot2 = np.sort(np.concatenate([keep, fresh]))
        for tier, cache in tiers:
            for h in (hot, hot2):  # second window persists half the rows
                plan = cache.plan_window([h], weights=np.ones(1))
                tier.load(plan, peek_fn=lambda ids: table[np.asarray(ids)])
                cache.swap(plan)
        return tiers, table

    def test_gather_bit_equal_to_reference_tier(self):
        ((ref, _), (port, _)), table = self._tiers()
        rng = np.random.default_rng(4)
        for size in (1, 5, 29, 13):
            ids = rng.choice(np.arange(len(table)), size=size)
            r_hit, r_rows = ref.gather(ids)
            p_hit, p_rows = port.gather(ids)
            np.testing.assert_array_equal(p_hit, r_hit)
            np.testing.assert_array_equal(p_rows, r_rows)
            np.testing.assert_array_equal(p_rows, table[ids[p_hit]])

    def test_empty_gather(self):
        (_, (port, _)), _ = self._tiers()
        assert port.gather_slots(np.empty(0, np.int64)).shape == (0, 6)
