"""The port's CSR SpMM (``to_csr``, ``csr_spmm``, ``Spmm``) against the JAX
reference, on the CPU.

On the CPU ``csr_spmm`` takes its plain PyTorch version, so these tests
hold the CSR format and the plain version against the reference's block
format (``to_block_sparse``, bit for bit once densified), its XLA twin
``block_spmm_xla``, the ``spmm_ref`` scatter oracle and the Pallas
``segment_mm`` kernel in interpret mode, on the same seeded inputs as
``tests/test_torch_kernels.py``. The CUDA kernel is held against the
plain version on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_mm import block_spmm_xla, segment_mm
from repro.kernels.segment_mm import to_block_sparse as ref_to_block_sparse
from repro.kernels.segment_mm.ref import spmm_ref as ref_spmm
from repro_torch.kernels.segment_mm import (
    CsrFormat,
    Spmm,
    csr_spmm,
    csr_spmm_plain,
    to_block_sparse,
    to_csr,
    transpose_csr,
)
from repro_torch.kernels.segment_mm.ops import (
    _rows_ok,
    check_kernel_operands,
    csr_plan,
)
from test_torch_kernels import SPMM_CASES, TOL, _graph, _pad_rows
from _elsewhere import elsewhere
from _jax_release import release_jax_executables  # noqa: F401


# widths the kernel covers: narrow, ragged, one slab, just past it, several
# slabs, and full_graph_sm's d_in
WIDE_F = (1, 3, 4, 5, 64, 127, 128, 129, 130, 256, 1433)


def _densify_csr(rowptr, col, val, n_cols):
    dense = np.zeros((len(rowptr) - 1, n_cols), np.float32)
    rows = np.repeat(np.arange(len(rowptr) - 1), np.diff(rowptr))
    dense[rows, col] = val
    return dense


def _densify_blocks(rows, cols, blocks, n_dst_blocks, n_src_pad):
    tn, tm = blocks.shape[1:]
    dense = np.zeros((n_dst_blocks * tn, n_src_pad), np.float32)
    for r, c, b in zip(rows, cols, blocks):
        dense[r * tn:(r + 1) * tn, c * tm:(c + 1) * tm] += b
    return dense


def _padded_csr(case):
    """The case's graph, its CSR at the reference's padded shape, and x
    padded to that many rows."""
    n_src, n_dst, n_edges, f, t, weighted = case
    src, dst, x, w = _graph(n_src, n_dst, n_edges, f, weighted)
    n_dst_pad, n_src_pad = -(-n_dst // t) * t, -(-n_src // t) * t
    csr = to_csr(src, dst, n_dst_pad, n_src_pad, w)
    return (src, dst, x, w), csr, n_dst_pad, n_src_pad


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


class TestFormat:
    @pytest.mark.parametrize("case", SPMM_CASES)
    def test_densified_csr_bit_equal_to_reference_blocks(self, case):
        (src, dst, _, w), csr, n_dst_pad, n_src_pad = _padded_csr(case)
        t = case[4]
        rows, cols, blocks, ndb, nsp = ref_to_block_sparse(
            src, dst, case[1], case[0], t, t, w)
        assert (ndb * t, nsp) == (n_dst_pad, n_src_pad)
        want = _densify_blocks(np.asarray(rows), np.asarray(cols),
                               np.asarray(blocks), ndb, nsp)
        np.testing.assert_array_equal(
            _bits(_densify_csr(*csr, n_src_pad)), _bits(want))

    @pytest.mark.parametrize("case", SPMM_CASES)
    def test_columns_strictly_ascend_and_entries_unique(self, case):
        (src, dst, _, _), (rowptr, col, val), n_dst_pad, _ = _padded_csr(case)
        assert rowptr.dtype == col.dtype == np.int32
        assert val.dtype == np.float32
        assert rowptr[0] == 0 and rowptr[-1] == len(col) == len(val)
        assert (np.diff(rowptr) >= 0).all()
        for r in range(n_dst_pad):
            assert (np.diff(col[rowptr[r]:rowptr[r + 1]]) > 0).all()
        assert len(col) == len(set(zip(dst.tolist(), src.tolist())))

    def test_duplicate_weights_sum_in_edge_order(self):
        # 1e8 + 1 - 1e8 rounds differently in another order
        src, dst = np.zeros(3, np.int64), np.zeros(3, np.int64)
        w = np.array([1e8, 1.0, -1e8], np.float32)
        rowptr, col, val = to_csr(src, dst, 1, 1, w)
        acc = np.float32(0)
        for x in w:
            acc = np.float32(acc + x)
        assert val.tolist() == [acc] and col.tolist() == [0]

    @pytest.mark.parametrize("case", SPMM_CASES)
    def test_transpose_is_the_transposed_matrix(self, case):
        _, csr, n_dst_pad, n_src_pad = _padded_csr(case)
        t_csr = transpose_csr(*csr, n_src_pad)
        assert len(t_csr[0]) == n_src_pad + 1
        np.testing.assert_array_equal(
            _bits(_densify_csr(*t_csr, n_dst_pad)),
            _bits(_densify_csr(*csr, n_src_pad).T))
        CsrFormat.from_numpy(*t_csr, n_dst_pad, "cpu")  # ascending rows

    def test_from_numpy_rejects_bad_formats(self):
        rowptr = np.array([0, 2, 3], np.int32)
        col = np.array([0, 3, 1], np.int32)
        val = np.ones(3, np.float32)
        CsrFormat.from_numpy(rowptr, col, val, 4, "cpu")
        with pytest.raises(IndexError):
            CsrFormat.from_numpy(rowptr, col, val, 3, "cpu")
        with pytest.raises(IndexError):
            CsrFormat.from_numpy(rowptr, col - 1, val, 4, "cpu")
        with pytest.raises(ValueError):  # not ascending within row 0
            CsrFormat.from_numpy(rowptr, col[[1, 0, 2]], val, 4, "cpu")
        with pytest.raises(ValueError):  # rowptr does not end at nnz
            CsrFormat.from_numpy(np.array([0, 2, 2], np.int32), col, val, 4,
                                 "cpu")
        with pytest.raises(ValueError):  # rowptr not monotone
            CsrFormat.from_numpy(np.array([0, 3, 2, 3], np.int32), col, val,
                                 4, "cpu")
        with pytest.raises(ValueError):
            CsrFormat.from_numpy(rowptr, col, val[:2], 4, "cpu")
        with pytest.raises(IndexError):
            to_csr(np.array([5]), np.array([0]), 1, 5)


class TestPlain:
    @pytest.mark.parametrize("case", SPMM_CASES)
    def test_plain_matches_xla_twin_and_oracles(self, case):
        n_src, n_dst, n_edges, f, t, weighted = case
        (src, dst, x, w), csr, n_dst_pad, n_src_pad = _padded_csr(case)
        fmt = CsrFormat.from_numpy(*csr, n_src_pad, "cpu")
        xp = _pad_rows(x, n_src_pad)
        got = csr_spmm(fmt, torch.as_tensor(xp)).numpy()
        assert got.shape == (n_dst_pad, f)
        np.testing.assert_array_equal(
            got, csr_spmm_plain(fmt.rowptr, fmt.col, fmt.val,
                                torch.as_tensor(xp)).numpy())
        rows, cols, blocks, ndb, _ = to_block_sparse(
            src, dst, n_dst, n_src, t, t, w)
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
        assert not got[n_dst:].any()  # padded rows are zero

    @pytest.mark.parametrize("case", SPMM_CASES[:3])
    def test_plain_matches_pallas_interpret(self, case):
        n_src, n_dst, n_edges, f, t, weighted = case
        (src, dst, x, w), csr, _, n_src_pad = _padded_csr(case)
        pallas = np.asarray(segment_mm(
            src, dst, jnp.asarray(x), n_dst, edge_weight=w, tn=t, tm=t,
            tf=64, interpret=True,
        ))
        fmt = CsrFormat.from_numpy(*csr, n_src_pad, "cpu")
        got = csr_spmm(fmt, torch.as_tensor(_pad_rows(x, n_src_pad)))
        np.testing.assert_allclose(got.numpy()[:n_dst], pallas, **TOL)


class TestAutograd:
    @pytest.mark.parametrize("case", SPMM_CASES)
    def test_backward_matches_vjp_of_reference_oracle(self, case):
        n_src, n_dst, n_edges, f, t, weighted = case
        (src, dst, x, w), csr, n_dst_pad, n_src_pad = _padded_csr(case)
        fwd = CsrFormat.from_numpy(*csr, n_src_pad, "cpu")
        bwd = CsrFormat.from_numpy(*transpose_csr(*csr, n_src_pad),
                                   n_dst_pad, "cpu")
        dy = np.random.default_rng(n_edges).standard_normal(
            (n_dst_pad, f)).astype(np.float32)
        xt = torch.as_tensor(_pad_rows(x, n_src_pad)).requires_grad_(True)
        y = Spmm.apply(xt, fwd, bwd)
        (dx,) = torch.autograd.grad(y, xt, grad_outputs=torch.as_tensor(dy))
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

    def test_no_transposed_format_means_no_input_gradient(self):
        src, dst, x, _ = _graph(64, 64, 200, 8, False)
        fmt = CsrFormat.from_numpy(*to_csr(src, dst, 64, 64), 64, "cpu")
        xt = torch.as_tensor(x).requires_grad_(True)
        y = Spmm.apply(xt, fmt, None)
        with pytest.raises(RuntimeError, match="transposed format"):
            y.sum().backward()
        # data that needs no gradient needs no transposed format
        assert Spmm.apply(torch.as_tensor(x), fmt, None).shape == (64, 8)

    def test_transposed_format_must_fit(self):
        src, dst, x, _ = _graph(64, 32, 200, 8, False)
        csr = to_csr(src, dst, 32, 64)
        fwd = CsrFormat.from_numpy(*csr, 64, "cpu")
        with pytest.raises(ValueError, match="transpose"):
            Spmm.apply(torch.as_tensor(x), fwd, fwd)


class TestWrapper:
    def _fmt(self):
        return CsrFormat.from_numpy(np.array([0, 1, 2], np.int32),
                                    np.array([0, 3], np.int32),
                                    np.ones(2, np.float32), 4, "cpu")

    def test_wrapper_rejects_bad_operands(self):
        fmt = self._fmt()
        x = torch.zeros((4, 8))
        assert csr_spmm(fmt, x).shape == (2, 8)
        with pytest.raises(TypeError):
            csr_spmm(fmt, x.double())
        with pytest.raises(TypeError):
            csr_spmm(CsrFormat(fmt.rowptr.long(), fmt.col, fmt.val, 4), x)
        with pytest.raises(ValueError):  # fewer rows than A has columns
            csr_spmm(fmt, torch.zeros((3, 8)))
        with pytest.raises(ValueError):  # operands on two devices
            csr_spmm(fmt, x.to("meta"))
        other = CsrFormat(*(elsewhere(t) for t in (fmt.rowptr, fmt.col,
                                                   fmt.val)), 4)
        with pytest.raises(ValueError, match="unsupported device"):
            csr_spmm(other, elsewhere(x))

    def test_kernel_operand_checks(self):
        """What a CUDA launch takes and refuses, checked on CPU tensors:
        any F >= 1, any row stride of at least F (padded, misaligned), and
        no F = 0 or column stride other than 1."""
        fmt = self._fmt()
        for f in WIDE_F:
            check_kernel_operands(fmt, torch.zeros((4, f)))
        check_kernel_operands(fmt, torch.zeros((4, 1436))[:, :1433])
        check_kernel_operands(fmt, torch.zeros(4 * 8 + 1)[1:].view(4, 8))
        for bad in (torch.zeros((4, 0)), torch.zeros((4, 16))[:, ::2],
                    torch.zeros((8, 4)).t()):
            with pytest.raises(ValueError):
                check_kernel_operands(fmt, bad)


def test_engine_prepare_densifies_to_the_block_format():
    """On a small trace, ``ComputeEngine.prepare``'s CSR layers (and the
    transposed one) are exactly what ``to_block_sparse`` gives at the same
    buckets, and the forward through them passes the scatter parity."""
    from repro_torch.store import MemoryBudget
    from repro_torch.train import compute, gnn_trainer as gt

    cfg = gt.RunConfig(method="static_w", compute="measured", batch_size=300,
                       n_epochs=1, warmup_epochs=0, steps_per_epoch=1,
                       mem_budget=MemoryBudget(), device="cpu")
    graph, _, _, mbs = gt.build_trace(cfg)
    eng = compute.ComputeEngine(graph, cfg)
    mb = mbs[0][0]
    layers, x_rows, _ = eng.prepare(mb)
    src_rows = x_rows
    for i, (blk, layer) in enumerate(zip(mb.blocks, layers)):
        fmt = layer["fwd"]
        assert fmt.n_cols == src_rows and fmt.n_rows % 128 == 0
        rows, cols, blocks, ndb, nsp = to_block_sparse(
            blk.edge_src, blk.edge_dst, fmt.n_rows, src_rows, 128, 128,
            blk.edge_mask.astype(np.float32))
        want = _densify_blocks(rows, cols, blocks, ndb, nsp)
        csr = (fmt.rowptr.numpy(), fmt.col.numpy(), fmt.val.numpy())
        np.testing.assert_array_equal(_bits(_densify_csr(*csr, src_rows)),
                                      _bits(want))
        if i == 0:
            assert layer["bwd"] is None
        else:
            b = layer["bwd"]
            got_t = _densify_csr(b.rowptr.numpy(), b.col.numpy(),
                                 b.val.numpy(), fmt.n_rows)
            np.testing.assert_array_equal(_bits(got_t), _bits(want.T))
        src_rows = fmt.n_rows
    assert eng.check_parity(mb, graph.features[mb.input_nodes]) < 2e-3


def _lane_columns(plan, f):
    """(first column, real columns) of every active lane, slab by slab, as
    the kernel assigns them (``c0 = (blockIdx.y * G + lane) * V``, active
    while ``c0 < F``; a lane's columns past F are the row's pad)."""
    out = []
    for s in range(plan.n_slabs):
        for lane in range(plan.g):
            c0 = (s * plan.g + lane) * plan.v
            if c0 < f:
                out.append((c0, min(plan.v, f - c0)))
    return out


class TestSlabPlan:
    """``csr_plan``: the launch ``csrc/csr_spmm.cu`` makes at each F."""

    @pytest.mark.parametrize("vec", [True, False], ids=["float4", "scalar"])
    @pytest.mark.parametrize("f", WIDE_F)
    def test_lanes_cover_every_column_once(self, f, vec):
        plan = csr_plan(f, vec)
        assert plan.slab <= (128 if vec else 32)
        assert plan.g & (plan.g - 1) == 0 and 1 <= plan.g <= 32
        assert plan.n_slabs == -(-f // plan.slab)
        cols = np.zeros(f, np.int64)
        for c0, n in _lane_columns(plan, f):
            cols[c0:c0 + n] += 1
            assert n == plan.v or c0 + n == f       # only the last is short
            # a float4 lane starts 16 bytes into an aligned row
            assert plan.v == 1 or (c0 * 4) % 16 == 0
        np.testing.assert_array_equal(cols, np.ones(f, np.int64))

    def test_narrow_widths_keep_the_old_groups(self):
        """F % 4 == 0 up to 128 launches one slab of F / 4 lanes rounded up
        to a power of two, the kernel's former only shape."""
        for f, g in ((4, 1), (8, 2), (16, 4), (64, 16), (100, 32), (128, 32)):
            assert csr_plan(f, True) == type(csr_plan(f, True))(4, g, 1)

    def test_float4_instance_needs_aligned_padded_rows(self):
        """The trainer's input layout (rows 1,436 floats apart, first 1,433
        used) takes the float4 instance; a contiguous (M, 1433) x, a
        misaligned x or a last row without its pad takes the scalar one."""
        buf = torch.zeros((6, 1436))
        assert _rows_ok(buf[:, :1433], 1433)
        assert _rows_ok(torch.zeros((6, 64)), 64)
        assert not _rows_ok(torch.zeros((6, 1433)), 1433)
        assert not _rows_ok(torch.zeros(6 * 64 + 1)[1:].view(6, 64), 64)
        assert not _rows_ok(torch.zeros(5 * 1436 + 1433)
                            .as_strided((6, 1433), (1436, 1)), 1433)


def test_full_graph_sm_layer0_matches_reference():
    """full_graph_sm's layer 0 at F = 1,433 on the CPU: the trainer's
    padded-stride input through ``csr_spmm`` against the reference's
    ``block_spmm_xla`` at the same CSR (``TOL``), and the same input
    contiguous giving the same bits."""
    from repro_torch.store import MemoryBudget
    from repro_torch.train import compute, gnn_trainer as gt

    cfg = gt.RunConfig(method="static_w", dataset="full_graph_sm",
                       compute="measured", batch_size=600, n_epochs=1,
                       warmup_epochs=0, steps_per_epoch=1,
                       mem_budget=MemoryBudget(), device="cpu")
    graph, _, _, mbs = gt.build_trace(cfg)
    eng = compute.ComputeEngine(graph, cfg)
    mb = mbs[0][0]
    layers, x_rows, _ = eng.prepare(mb)
    x = eng.pad_input(graph.features[mb.input_nodes], x_rows)
    assert x.shape[1] == 1433 and x.stride(0) == 1436
    fmt = layers[0]["fwd"]
    got = csr_spmm(fmt, x)
    blk = mb.blocks[0]
    rows, cols, blocks, ndb, _ = ref_to_block_sparse(
        blk.edge_src, blk.edge_dst, fmt.n_rows, fmt.n_cols, 128, 128,
        blk.edge_mask.astype(np.float32))
    want = np.asarray(block_spmm_xla(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(blocks),
        jnp.asarray(x.contiguous().numpy()), ndb))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, csr_spmm(fmt, x.contiguous()))
