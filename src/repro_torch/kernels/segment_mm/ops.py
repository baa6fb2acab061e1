"""Block-sparse SpMM: edge-list -> block format, the kernel wrapper, its
plain version and its autograd.

Port of ``repro/kernels/segment_mm/ops.py``. ``to_block_sparse`` is the
reference's numpy conversion, copied. ``block_spmm`` is the wrapper around
the hand-written CUDA kernel ``csrc/block_spmm.cu`` (which replaces
``repro/kernels/segment_mm/kernel.py::block_spmm_kernel``): it launches the
kernel for CUDA tensors and takes the plain version, a port of
``block_spmm_xla`` (a batched matmul plus ``index_add_`` over the row
blocks), only for CPU tensors. ``BlockSpmm`` is the autograd function: its
backward runs the same kernel over the transposed format
(:func:`transpose_block_sparse`), ``dX = A^T dY``.

Bound: bytes (the dense blocks; the 0.4%-full adjacency needs few
operations), but the kernel executes the dense block products and runs
on the fp32 FMA pipes far above that bound. Design (note at the top of
``csrc/block_spmm.cu``): one CTA per output tile walking its row's
blocks in order, no atomics, so the summation order is fixed and two
launches are bit-identical.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import _build

TILE = 128  # the CUDA kernel's TN = TM


def to_block_sparse(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    n_dst: int,
    n_src: int,
    tn: int = 128,
    tm: int = 128,
    edge_weight: np.ndarray | None = None,
):
    """Convert an edge list into row-sorted dense adjacency blocks.

    Every destination row-block is covered by at least one block (zero block
    if it has no edges). Returns
    (rows (nb,), cols (nb,), blocks (nb, tn, tm), n_dst_blocks, n_src_pad).
    """
    n_dst_blocks = -(-n_dst // tn)
    n_src_blocks = -(-n_src // tm)
    br = edge_dst // tn
    bc = edge_src // tm
    key = br.astype(np.int64) * n_src_blocks + bc
    uniq, inv = np.unique(key, return_inverse=True)
    w = (
        edge_weight.astype(np.float32)
        if edge_weight is not None
        else np.ones(len(edge_src), np.float32)
    )
    rows = (uniq // n_src_blocks).astype(np.int32)
    cols = (uniq % n_src_blocks).astype(np.int32)
    # missing dst row-blocks get a zero block pointing at col 0; each
    # block's final row-sorted position is computed up front so the edges
    # scatter straight into one preallocation
    present = np.zeros(n_dst_blocks, bool)
    present[rows] = True
    missing = np.flatnonzero(~present).astype(np.int32)
    nb = len(uniq) + len(missing)
    pos_real = np.arange(len(uniq)) + np.searchsorted(missing, rows)
    pos_missing = np.searchsorted(rows, missing) + np.arange(len(missing))
    blocks = np.zeros((nb, tn, tm), np.float32)
    np.add.at(
        blocks, (pos_real[inv], edge_dst % tn, edge_src % tm), w
    )
    rows_all = np.empty(nb, np.int32)
    cols_all = np.zeros(nb, np.int32)
    rows_all[pos_real] = rows
    rows_all[pos_missing] = missing
    cols_all[pos_real] = cols
    return (
        rows_all,
        cols_all,
        blocks,
        n_dst_blocks,
        n_src_blocks * tm,
    )


def transpose_block_sparse(rows: np.ndarray, cols: np.ndarray,
                           blocks: np.ndarray, n_src_blocks: int):
    """The transposed format A^T: blocks transposed, (row, col) swapped,
    stably re-sorted by the new row. Returns
    (rows, cols, blocks, n_dst_blocks) with n_dst_blocks = n_src_blocks."""
    order = np.argsort(cols, kind="stable")
    return (
        np.ascontiguousarray(cols[order]),
        np.ascontiguousarray(rows[order]),
        np.ascontiguousarray(blocks[order].transpose(0, 2, 1)),
        int(n_src_blocks),
    )


@dataclasses.dataclass(frozen=True)
class BlockFormat:
    """One block-sparse operand on a device: row-sorted blocks."""

    rows: torch.Tensor     # (nb,) int32, sorted ascending
    cols: torch.Tensor     # (nb,) int32
    blocks: torch.Tensor   # (nb, tn, tm) float32
    n_dst_blocks: int

    @classmethod
    def from_numpy(cls, rows, cols, blocks, n_dst_blocks, device):
        return cls(
            torch.as_tensor(rows, dtype=torch.int32).to(device),
            torch.as_tensor(cols, dtype=torch.int32).to(device),
            torch.as_tensor(blocks, dtype=torch.float32).to(device),
            int(n_dst_blocks),
        )


def block_spmm_plain(rows, cols, blocks, x, n_dst_blocks: int):
    """Plain PyTorch version (port of ``block_spmm_xla``): per-block dense
    matmul, summed into destination row-blocks with ``index_add_``."""
    tn, tm = blocks.shape[1], blocks.shape[2]
    xb = x.reshape(-1, tm, x.shape[1])
    prod = torch.bmm(blocks, xb[cols.long()])
    y = torch.zeros(
        (n_dst_blocks, tn, x.shape[1]), dtype=x.dtype, device=x.device
    )
    y.index_add_(0, rows.long(), prod)
    return y.reshape(n_dst_blocks * tn, x.shape[1])


def _check(rows, cols, blocks, x, n_dst_blocks: int) -> None:
    if not (rows.device == cols.device == blocks.device == x.device):
        raise ValueError("block_spmm: all operands must be on one device")
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("block_spmm: rows and cols must be int32")
    if blocks.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("block_spmm: blocks and x must be float32")
    if blocks.dim() != 3 or x.dim() != 2:
        raise ValueError("block_spmm: blocks must be (nb, tn, tm), x (M, F)")
    nb = blocks.shape[0]
    if rows.shape != (nb,) or cols.shape != (nb,):
        raise ValueError("block_spmm: rows and cols must be (nb,)")
    if x.shape[0] % blocks.shape[2] != 0:
        raise ValueError("block_spmm: x rows must be a multiple of tm")
    if n_dst_blocks < 0:
        raise ValueError("block_spmm: n_dst_blocks must be >= 0")


def block_spmm(rows, cols, blocks, x, n_dst_blocks: int) -> torch.Tensor:
    """Y (n_dst_blocks * tn, F) = block-sparse A @ X.

    CUDA tensors launch ``csrc/block_spmm.cu`` (128 x 128 blocks, F a
    multiple of 4, contiguous operands); CPU tensors take
    :func:`block_spmm_plain`. Indices are checked against the operand
    shapes before a launch.
    """
    _check(rows, cols, blocks, x, n_dst_blocks)
    if x.device.type == "cpu":
        return block_spmm_plain(rows, cols, blocks, x, n_dst_blocks)
    if x.device.type != "cuda":
        raise ValueError(f"block_spmm: unsupported device {x.device}")
    if tuple(blocks.shape[1:]) != (TILE, TILE):
        raise ValueError(f"block_spmm: CUDA kernel takes {TILE}x{TILE} blocks")
    f = x.shape[1]
    if f % 4 != 0:
        raise ValueError("block_spmm: CUDA kernel takes F % 4 == 0")
    for name, t in (("rows", rows), ("cols", cols), ("blocks", blocks),
                    ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"block_spmm: {name} must be contiguous")
    for name, t in (("blocks", blocks), ("x", x)):
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"block_spmm: {name} must be 16-byte aligned")
    nb = rows.shape[0]
    if nb:
        lo_hi = torch.stack([
            cols.min(), cols.max(), rows.min(), rows.max(),
            (rows[1:] >= rows[:-1]).all().to(torch.int32),
        ]).tolist()
        if not (0 <= lo_hi[0] and lo_hi[1] < x.shape[0] // TILE):
            raise IndexError("block_spmm: cols out of range of x")
        if not (0 <= lo_hi[2] and lo_hi[3] < n_dst_blocks):
            raise IndexError("block_spmm: rows out of range")
        if not lo_hi[4]:
            raise ValueError("block_spmm: rows must be sorted ascending")
    rowptr = torch.searchsorted(
        rows, torch.arange(n_dst_blocks + 1, dtype=torch.int32,
                           device=rows.device), out_int32=True,
    )
    y = torch.empty((n_dst_blocks * TILE, f), dtype=x.dtype, device=x.device)
    launch(rowptr, cols, blocks, x, y, n_dst_blocks)
    return y


def launch(rowptr, cols, blocks, x, y, n_dst_blocks: int) -> None:
    """Launch the kernel on checked operands (counts one launch)."""
    fn = _build.entry("block_spmm_f32")
    err = fn(
        rowptr.data_ptr(), cols.data_ptr(), blocks.data_ptr(), x.data_ptr(),
        y.data_ptr(), int(n_dst_blocks), int(x.shape[1]),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    block_spmm.launches += 1
    _build.check("block_spmm_f32", err)


block_spmm.launches = 0


class BlockSpmm(torch.autograd.Function):
    """Y = A @ X with dX = A^T @ dY, both through :func:`block_spmm`.

    ``fwd`` is A's :class:`BlockFormat`; ``bwd`` is A^T's (None when X
    needs no gradient, as for the data fed to the first layer)."""

    @staticmethod
    def forward(ctx, x, fwd: BlockFormat, bwd: BlockFormat | None):
        ctx.bwd = bwd
        return block_spmm(fwd.rows, fwd.cols, fwd.blocks, x, fwd.n_dst_blocks)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        bwd = ctx.bwd
        if bwd is None:
            raise RuntimeError(
                "BlockSpmm: X needs a gradient but no transposed format "
                "was given"
            )
        dx = block_spmm(bwd.rows, bwd.cols, bwd.blocks, dy.contiguous(),
                        bwd.n_dst_blocks)
        return dx, None, None
