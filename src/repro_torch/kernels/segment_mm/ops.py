"""The GNN SpMM ``Y = A @ X``: edge list -> sparse format, the kernel
wrappers, their plain versions and their autograd.

Port of ``repro/kernels/segment_mm/ops.py``. ``A`` is the padded adjacency
``(n_dst_pad, n_src_pad)`` with the weights of duplicate edges summed.

- **CSR, the trainer's format.** :func:`to_csr` builds it in numpy, unique
  ``(dst, src)`` entries with columns strictly ascending in each row;
  :func:`csr_spmm` wraps the hand-written CUDA kernel
  ``csrc/csr_spmm.cu``, which replaces the Pallas kernel of
  ``repro/kernels/segment_mm/kernel.py`` (``pl.pallas_call`` at ``:78``);
  :class:`Spmm` is its autograd (``dX = A^T dY`` over
  :func:`transpose_csr`). It takes any width F >= 1 in one launch:
  :func:`csr_plan` cuts a row into column slabs of at most 128 (float4
  lanes, where X and Y allow them) or 32 (one float a lane). Bound:
  bytes, the entries (8 B each), the row pointers, X and Y, about 2.8 MB
  at the reddit trainer's layer 0, which the card moves in under a
  microsecond: at these sizes a launch's latency, not the bound, sets
  the time. Design (note at the top of ``csrc/csr_spmm.cu``): a group of
  lanes owns a row's slab, no atomics, entries summed in ascending column
  order, so two launches are bit-identical.
- **Dense 128 x 128 blocks, the reference's format.** :func:`to_block_sparse`
  is the reference's numpy conversion, copied, and
  :func:`transpose_block_sparse` its transpose: the tests hold the CSR
  against them. No kernel of the port takes them.

The wrapper launches its kernel for CUDA tensors and takes its plain
PyTorch version (``csr_spmm_plain``) only for CPU tensors. On the
``meta`` device it returns Y's shape and charges the counter
(``launch.count``) what a launch would do, and launches nothing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import _build

TILE = 128  # the trainer's row and column padding (the reference's tile)


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


# ------------------------------------------------------------------- CSR
MAX_SLABS = 65535  # the kernel's grid.y: slabs of one row


def _round_up(n: int, m: int) -> int:
    return -(-int(n) // m) * m


@dataclasses.dataclass(frozen=True)
class SpmmPlan:
    """How the CSR kernel covers a row of F columns: ``n_slabs`` slabs of
    ``g`` lanes, each lane ``v`` consecutive floats (4: one float4, 1: one
    float), so a slab is ``g * v`` columns wide (at most 128 or 32)."""

    v: int
    g: int
    n_slabs: int

    @property
    def slab(self) -> int:
        return self.g * self.v


def csr_plan(f: int, vec: bool) -> SpmmPlan:
    """The launch the kernel makes for width ``f`` (``csrc/csr_spmm.cu``
    ``launch_v``): float4 lanes when ``vec``, else one float a lane; one
    slab of the fewest power-of-two lanes when F fits, else slabs of 32
    lanes."""
    v = 4 if vec else 1
    n_slabs = -(-int(f) // (32 * v))
    lanes = 32 if n_slabs > 1 else -(-int(f) // v)
    return SpmmPlan(v, 1 << max(lanes - 1, 0).bit_length(), n_slabs)


def _ld(t, f: int) -> int:
    """The row stride the kernel is given for ``t`` (any stride of at
    least F rounded up to 4 for a tensor of at most one row)."""
    return int(t.stride(0)) if t.shape[0] > 1 else _round_up(f, 4)


def _rows_ok(t, f: int) -> bool:
    """``t``'s rows take the float4 instance: 16-byte aligned, a row
    stride of a multiple of 4 floats, and every row's first ``f`` rounded
    up to 4 floats inside ``t``'s storage."""
    return (
        t.shape[0] == 0
        or t.data_ptr() % 16 == 0 and _ld(t, f) % 4 == 0
        and t.storage_offset() + (t.shape[0] - 1) * _ld(t, f)
        + _round_up(f, 4) <= t.untyped_storage().nbytes() // t.element_size()
    )


def _unit_columns(t, f: int) -> bool:
    return t.shape[0] <= 1 or f == 1 or (t.stride(1) == 1
                                         and t.stride(0) >= f)


def to_csr(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    n_dst: int,
    n_src: int,
    edge_weight: np.ndarray | None = None,
):
    """The ``(n_dst, n_src)`` adjacency of an edge list as CSR.

    Entries are the unique ``(dst, src)`` pairs, columns strictly
    ascending within a row; the weights of duplicate edges are summed in
    edge order (``np.add.at``, as :func:`to_block_sparse` sums them into
    its blocks), so the densified CSR equals the scattered blocks bit for
    bit. Returns ``(rowptr int32 (n_dst + 1,), col int32 (nnz,), val
    float32 (nnz,))``.
    """
    src = np.asarray(edge_src, np.int64)
    dst = np.asarray(edge_dst, np.int64)
    if src.ndim != 1 or src.shape != dst.shape:
        raise ValueError("to_csr: edge_src and edge_dst must be (E,)")
    if src.size and not (0 <= src.min() and src.max() < n_src
                         and 0 <= dst.min() and dst.max() < n_dst):
        raise IndexError("to_csr: an edge lies outside (n_dst, n_src)")
    w = (
        np.asarray(edge_weight, np.float32)
        if edge_weight is not None
        else np.ones(len(src), np.float32)
    )
    if w.shape != src.shape:
        raise ValueError("to_csr: edge_weight must be (E,)")
    uniq, inv = np.unique(dst * n_src + src, return_inverse=True)
    val = np.zeros(len(uniq), np.float32)
    np.add.at(val, inv, w)
    rowptr = np.zeros(n_dst + 1, np.int64)
    np.cumsum(np.bincount(uniq // n_src, minlength=n_dst), out=rowptr[1:])
    return (rowptr.astype(np.int32), (uniq % n_src).astype(np.int32), val)


def transpose_csr(rowptr: np.ndarray, col: np.ndarray, val: np.ndarray,
                  n_src: int):
    """The CSR of ``A^T`` (``n_src`` rows): entries stably sorted by
    column, so the original destination rows stay ascending within each
    row of ``A^T``. Returns ``(rowptr, col, val)`` as :func:`to_csr`."""
    rows = np.repeat(np.arange(len(rowptr) - 1, dtype=np.int32),
                     np.diff(rowptr))
    order = np.argsort(col, kind="stable")
    t_rowptr = np.zeros(n_src + 1, np.int64)
    np.cumsum(np.bincount(col, minlength=n_src), out=t_rowptr[1:])
    return (t_rowptr.astype(np.int32), rows[order],
            np.ascontiguousarray(val[order]))


def _check_csr(rowptr: np.ndarray, col: np.ndarray, val: np.ndarray,
              n_cols: int) -> None:
    """Raise unless ``(rowptr, col, val)`` is a CSR matrix of ``n_cols``
    columns with strictly ascending columns in each row."""
    if rowptr.ndim != 1 or rowptr.size < 1 or rowptr[0] != 0:
        raise ValueError("CSR: rowptr must be (n_rows + 1,) from 0")
    nnz = col.size
    if col.shape != (nnz,) or val.shape != (nnz,):
        raise ValueError("CSR: col and val must be (nnz,)")
    if (np.diff(rowptr) < 0).any() or rowptr[-1] != nnz:
        raise ValueError("CSR: rowptr must be monotone and end at nnz")
    if nnz and not (0 <= col.min() and col.max() < n_cols):
        raise IndexError("CSR: a column lies outside [0, n_cols)")
    starts = np.zeros(nnz, bool)
    starts[rowptr[:-1][np.diff(rowptr) > 0]] = True
    if (np.diff(col.astype(np.int64)) <= 0)[~starts[1:]].any():
        raise ValueError("CSR: columns must ascend strictly within a row")


@dataclasses.dataclass(frozen=True)
class CsrFormat:
    """One CSR operand on a device, checked once when it is made."""

    rowptr: torch.Tensor   # (n_rows + 1,) int32
    col: torch.Tensor      # (nnz,) int32, ascending within a row
    val: torch.Tensor      # (nnz,) float32
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.rowptr.shape[0] - 1

    @classmethod
    def from_numpy(cls, rowptr, col, val, n_cols, device):
        rowptr = np.asarray(rowptr, np.int32)
        col = np.asarray(col, np.int32)
        val = np.asarray(val, np.float32)
        _check_csr(rowptr, col, val, int(n_cols))
        return cls(
            torch.as_tensor(rowptr).to(device),
            torch.as_tensor(col).to(device),
            torch.as_tensor(val).to(device),
            int(n_cols),
        )


def csr_spmm_plain(rowptr, col, val, x):
    """Plain PyTorch version: ``index_add_`` of ``val * x[col]`` over the
    entries' rows."""
    n_rows = rowptr.shape[0] - 1
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device), (rowptr[1:] - rowptr[:-1]).long(),
        output_size=col.shape[0],
    )
    y = torch.zeros((n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    return y.index_add_(0, rows, val[:, None] * x[col.long()])


def _check_csr_operands(fmt: CsrFormat, x) -> None:
    if not (fmt.rowptr.device == fmt.col.device == fmt.val.device
            == x.device):
        raise ValueError("csr_spmm: all operands must be on one device")
    if fmt.val.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("csr_spmm: val and x must be float32")
    if fmt.rowptr.dtype != torch.int32 or fmt.col.dtype != torch.int32:
        raise TypeError("csr_spmm: rowptr and col must be int32")
    if x.dim() != 2:
        raise ValueError("csr_spmm: x must be (M, F)")
    if x.shape[0] < fmt.n_cols:
        raise ValueError(
            f"csr_spmm: x has {x.shape[0]} rows, A has {fmt.n_cols} columns")


def check_kernel_operands(fmt: CsrFormat, x) -> None:
    """What the CUDA kernel takes beyond the function: F >= 1 in at most
    ``MAX_SLABS`` slabs, contiguous CSR arrays, and X's rows at unit
    column stride (any row stride of at least F)."""
    f = x.shape[1]
    if not 0 < f <= MAX_SLABS * 32:
        raise ValueError(
            f"csr_spmm: CUDA kernel takes 0 < F <= {MAX_SLABS * 32}")
    for name, t in (("rowptr", fmt.rowptr), ("col", fmt.col),
                    ("val", fmt.val)):
        if not t.is_contiguous():
            raise ValueError(f"csr_spmm: {name} must be contiguous")
    if not _unit_columns(x, f):
        raise ValueError(
            "csr_spmm: x's rows must be at unit column stride, a row stride "
            "of at least F apart")


def csr_spmm(fmt: CsrFormat, x) -> torch.Tensor:
    """Y (n_rows, F) = A @ X for A in CSR, any F >= 1.

    CUDA tensors launch ``csrc/csr_spmm.cu``; CPU tensors take
    :func:`csr_spmm_plain`. The format was checked when it was made
    (:meth:`CsrFormat.from_numpy`), so nothing is read back from the
    device here. Where X's rows take the float4 instance (see
    :func:`_rows_ok`), Y is allocated with its rows padded to a multiple
    of 4 floats and its first F columns are returned (a view)."""
    _check_csr_operands(fmt, x)
    if x.device.type == "cpu":
        return csr_spmm_plain(fmt.rowptr, fmt.col, fmt.val, x)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"csr_spmm: unsupported device {x.device}")
    check_kernel_operands(fmt, x)
    f = x.shape[1]
    ld = _round_up(f, 4) if _rows_ok(x, f) else f
    y = torch.empty((fmt.n_rows, ld), dtype=x.dtype, device=x.device)
    csr_launch(fmt, x, y[:, :f])
    return y[:, :f]


def csr_work(fmt: CsrFormat, x_rows: int, f: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch, the bound's formula: a multiply and
    an add an entry and a column; the row pointers, the entries (8 B
    each), X's rows and Y's rows read or written once."""
    nnz = fmt.col.shape[0]
    return (2.0 * nnz * f,
            4.0 * (fmt.n_rows + 1) + 8.0 * nnz + 4.0 * f * (x_rows
                                                           + fmt.n_rows))


def csr_launch(fmt: CsrFormat, x, y) -> None:
    """Launch the CSR kernel on checked operands (counts one launch): the
    float4 instance when both X's and Y's rows take it, else the scalar
    one. Every launch charges :func:`csr_work` to the active counters
    (``_build.count_launch``); on ``meta`` the charge stands in for the
    launch."""
    f = x.shape[1]
    if tuple(y.shape) != (fmt.n_rows, f) or not _unit_columns(y, f):
        raise ValueError("csr_spmm: y must be (n_rows, F) rows at unit "
                         "column stride")
    vec = _rows_ok(x, f) and _rows_ok(y, f)
    work = csr_work(fmt, x.shape[0], f)
    if x.device.type == "meta":
        _build.charge(csr_spmm, *work)
        return
    fn = _build.entry("csr_spmm_f32")
    err = fn(
        fmt.rowptr.data_ptr(), fmt.col.data_ptr(), fmt.val.data_ptr(),
        x.data_ptr(), y.data_ptr(), int(fmt.n_rows), int(f),
        _ld(x, f), _ld(y, f), int(vec),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.count_launch(csr_spmm, *work)
    _build.check("csr_spmm_f32", err)


csr_spmm.launches = 0
csr_spmm.launches_by_thread = {}


class Spmm(torch.autograd.Function):
    """Y = A @ X with dX = A^T @ dY, both through :func:`csr_spmm`.

    ``fwd`` is A's :class:`CsrFormat`; ``bwd`` is A^T's (None when X needs
    no gradient, as for the data fed to the first layer)."""

    @staticmethod
    def forward(ctx, x, fwd: CsrFormat, bwd: CsrFormat | None):
        if bwd is not None and (bwd.n_rows != x.shape[0]
                                or bwd.n_cols != fwd.n_rows):
            raise ValueError("Spmm: bwd is not the transpose of fwd's shape")
        ctx.bwd = bwd
        return csr_spmm(fwd, x)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        if ctx.bwd is None:
            raise RuntimeError(
                "Spmm: X needs a gradient but no transposed format was given"
            )
        return csr_spmm(ctx.bwd, dy.contiguous()), None, None
