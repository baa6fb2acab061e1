"""Measured-compute lane: a real GraphSAGE step on the hot path.

Port of ``repro/train/compute.py::ComputeEngine``. Modeled mode charges
``CostModelParams.t_base`` for every trainer step; this engine replaces
that constant with the time of a real forward/backward/AdamW step over the
feature rows the step resolved, with neighbourhood aggregation through
``kernels.segment_mm``'s CSR SpMM: the CUDA kernel on the card, its plain
version on the CPU.

``prepare`` converts a mini-batch's edge lists to CSR in numpy
(``to_csr``: unique entries, duplicate weights summed), buckets the
source/destination row counts to powers of two of 128-row tiles (the
reference's block buckets, so the adjacency is the same padded matrix),
builds the transposed CSR the backward needs, and copies everything to
the device: the copies happen here, outside the timed step, as
``jnp.asarray`` does in the reference. Where the reference densifies the
adjacency into 128 x 128 blocks for the TPU's matrix unit (about 39 MB a
step at the trainer's size, 0.2-0.4% of it nonzero), the CSR of a step is
about 0.2 MB. Prepared batches sit in a bounded LRU keyed by
``(epoch, step)``.

The step's input rows come as an :class:`InputRows`: the rows read on
the host and the device tier's hits, already on the device, each with its
positions. ``place_input`` writes both into the padded input with one
host-to-device copy (the host rows and all positions, packed) and two
``index_copy_``; the result is bit-equal to padding the host overlay of
every row. The input's rows lie ``d_in`` rounded up to 4 floats apart (a
view of the first ``d_in`` columns), so that the SpMM kernel reads them as
float4 at any width (``full_graph_sm``'s 1,433 included); the pad columns
are never read into a result. The step is timed with CUDA events on the card and
``time.perf_counter`` on the CPU. On the first step ``check_parity``
holds the CSR path against the plain scatter path
(``sage.apply_blocks``), tolerance 2e-3. Gradient sync flows through
``grad_compression`` with error feedback between the gradients and AdamW;
``sync_wire_bytes`` is what the cluster driver feeds into
``ring_collective_cost`` in place of the uncompressed payload.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.device import resolve, to_device_packed
from repro_torch.kernels.segment_mm import (
    TILE,
    CsrFormat,
    Spmm,
    to_csr,
    transpose_csr,
)
from repro_torch.models.gnn import common, sage
from repro_torch.optim import optimizers as optim
from repro_torch.train import grad_compression as gc

LEARNING_RATE = 3e-3  # the reference's measured and modeled lanes' lr
PREP_CACHE_SIZE = 16  # prepared batches kept (a rebuild window's worth)


@dataclasses.dataclass(frozen=True)
class InputRows:
    """A step's input feature rows in two parts, each with its positions
    in the input order: rows read on the host, and rows already on the
    engine's device (the device tier's hits)."""

    host_rows: np.ndarray              # (n_host, d_in) float32
    host_pos: np.ndarray               # (n_host,) int64
    device_rows: torch.Tensor | None   # (n_device, d_in) float32
    device_pos: np.ndarray             # (n_device,) int64

    @property
    def n(self) -> int:
        return len(self.host_pos) + len(self.device_pos)


def _bucket(n: int) -> int:
    """Next power of two >= n (min 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def sage_config(graph, d_hidden: int = 16) -> sage.SageConfig:
    """The paper's training model (Section VI-A) sized for ``graph``."""
    d_in = (
        graph.features.shape[1]
        if graph.features is not None
        else graph.feature_source.n_feat
    )
    return sage.SageConfig(
        d_in=d_in, d_hidden=d_hidden,
        n_classes=int(graph.labels.max()) + 1, n_layers=2, dropout=0.0,
    )


def model_wire_bytes(graph, scheme: str = "none", frac: float = 0.05
                     ) -> float:
    """Per-sync gradient payload bytes of the SAGE model on ``graph`` under
    a compression scheme (parameters on the meta device: nothing is
    materialized). ``scheme="none"`` equals ``cluster.default_grad_bytes``
    bit for bit."""
    params = sage.init(sage_config(graph), torch.Generator().manual_seed(0),
                       device="meta")
    return float(gc.wire_bytes(params, scheme, frac))


class ComputeEngine:
    """Real SAGE step + timing + gradient compression for one worker, on
    ``cfg.device``."""

    def __init__(self, graph, cfg):
        self.scheme = cfg.grad_compression
        gc.check_scheme(self.scheme)
        self.topk_frac = float(cfg.topk_frac)
        self.device = resolve(cfg.device)
        self.mcfg = sage_config(graph)
        self.params = sage.init(
            self.mcfg, torch.Generator().manual_seed(int(cfg.seed)),
            device=self.device,
        )
        self.opt = optim.adamw(LEARNING_RATE)
        self.opt_state = self.opt.init(self.params)
        self.error = gc.init_error_feedback(self.params)
        self.sync_wire_bytes = float(
            gc.wire_bytes(self.params, self.scheme, self.topk_frac)
        )
        self.labels_np = np.asarray(graph.labels)

        self._prep: OrderedDict = OrderedDict()   # mb key -> prepared batch

        self.losses: list[float] = []
        self.step_s: list[float] = []
        self.step_edges: list[int] = []
        self.parity_max_diff: float | None = None
        self._parity_tol = 2e-3

    def load_params(self, tree: dict) -> None:
        """Replace the parameters with numpy arrays in the reference's
        layout ``{"layer_i": {"w_self", "w_neigh", "b"}}`` and reset the
        optimizer state."""
        from repro_torch.convert import sage_params_from_jax

        self.params = sage_params_from_jax(tree, self.device)
        self.opt_state = self.opt.init(self.params)
        self.error = gc.init_error_feedback(self.params)

    # ------------------------------------------------------------ prepare
    def prepare(self, mb, key=None):
        """CSR conversion, bucketing and device copy for one mini-batch:
        ``(layers, x_rows, n_edges)``, cached per ``key``."""
        if key is not None and key in self._prep:
            self._prep.move_to_end(key)
            return self._prep[key]
        prep = self._prepare(mb)
        if key is not None:
            self._prep[key] = prep
            while len(self._prep) > PREP_CACHE_SIZE:
                self._prep.popitem(last=False)
        return prep

    def _prepare(self, mb):
        t = TILE
        dev = self.device
        layers = []
        n_edges = 0
        n_src_rows = _bucket(-(-len(mb.blocks[0].src_nodes) // t)) * t
        src_rows = n_src_rows
        for i, blk in enumerate(mb.blocks):
            n_dst_true = len(blk.dst_nodes)
            n_dst_pad = _bucket(-(-n_dst_true // t)) * t
            csr = to_csr(blk.edge_src, blk.edge_dst, n_dst_pad, src_rows,
                         blk.edge_mask.astype(np.float32))
            indeg = np.bincount(
                blk.edge_dst[blk.edge_mask], minlength=n_dst_pad
            ).astype(np.float32)
            dst_pos = np.zeros(n_dst_pad, np.int64)
            dst_pos[:n_dst_true] = blk.dst_pos
            layer = {
                "fwd": CsrFormat.from_numpy(*csr, src_rows, dev),
                # layer 0 aggregates data, which needs no gradient
                "bwd": (
                    CsrFormat.from_numpy(*transpose_csr(*csr, src_rows),
                                         n_dst_pad, dev)
                    if i > 0 else None
                ),
                "counts": torch.as_tensor(
                    np.maximum(indeg, 1.0)[:, None]).to(dev),
                "dst_pos": torch.as_tensor(dst_pos).to(dev),
            }
            if i == len(mb.blocks) - 1:
                labels = np.zeros(n_dst_pad, np.int64)
                labels[:n_dst_true] = self.labels_np[blk.dst_nodes]
                lmask = np.zeros(n_dst_pad, np.float32)
                lmask[:n_dst_true] = blk.dst_mask.astype(np.float32)
                layer["labels"] = torch.as_tensor(labels).to(dev)
                layer["lmask"] = torch.as_tensor(lmask).to(dev)
            layers.append(layer)
            n_edges += int(blk.edge_mask.sum())
            src_rows = n_dst_pad
        return tuple(layers), n_src_rows, n_edges

    def _input_buffer(self, x_rows: int) -> torch.Tensor:
        """An uninitialised (x_rows, d_in) input on the device whose rows
        lie ``d_in`` rounded up to 4 floats apart."""
        d_in = self.mcfg.d_in
        ld = -(-d_in // 4) * 4
        return torch.empty((x_rows, ld), dtype=torch.float32,
                           device=self.device)[:, :d_in]

    def pad_input(self, x_in: np.ndarray, x_rows: int) -> torch.Tensor:
        """Zero-padded (x_rows, d_in) input rows, copied to the device."""
        x = np.zeros((x_rows, self.mcfg.d_in), np.float32)
        x[: len(x_in)] = x_in
        out = self._input_buffer(x_rows)
        out.copy_(torch.as_tensor(x))
        return out

    def place_input(self, x_in: InputRows, x_rows: int) -> torch.Tensor:
        """Zero-padded (x_rows, d_in) input on the device: the host rows
        and every position in one copy, each part placed at its rows."""
        n_host = len(x_in.host_pos)
        pos, rows = to_device_packed(
            [np.concatenate([x_in.host_pos, x_in.device_pos]).astype(np.int64),
             np.asarray(x_in.host_rows, np.float32)], self.device)
        x = self._input_buffer(x_rows)
        x[x_in.n:].zero_()
        x.index_copy_(0, pos[:n_host], rows)
        if len(x_in.device_pos):
            x.index_copy_(0, pos[n_host:], x_in.device_rows)
        return x

    def input_rows(self, x_in, x_rows: int) -> torch.Tensor:
        """The padded device input from an :class:`InputRows` or from the
        host rows of every input node (an array)."""
        if isinstance(x_in, InputRows):
            return self.place_input(x_in, x_rows)
        return self.pad_input(np.asarray(x_in, np.float32), x_rows)

    # ------------------------------------------------------------ forward
    def _forward(self, params, x_pad, layers):
        """CSR-path SAGE forward over prepared layers (padded rows)."""
        h = x_pad
        for i, layer in enumerate(layers):
            lp = params[f"layer_{i}"]
            agg = Spmm.apply(h, layer["fwd"], layer["bwd"]) / layer["counts"]
            h_new = h[layer["dst_pos"]] @ lp["w_self"] \
                + agg @ lp["w_neigh"] + lp["b"]
            if i < len(layers) - 1:
                h_new = torch.relu(h_new)
            h = h_new
        return h

    def loss_and_grads(self, x_pad, layers):
        """Loss and parameter gradients of one step (no update)."""
        params = optim.tree_map(
            lambda p: p.detach().requires_grad_(True), self.params
        )
        last = layers[-1]
        logits = self._forward(params, x_pad, layers)
        loss = common.cross_entropy(logits, last["labels"], last["lmask"])
        grads = torch.autograd.grad(loss, optim.tree_leaves(params))
        return loss.detach(), optim.tree_unflatten(params, grads)

    def _step_fn(self, x_pad, layers):
        loss, grads = self.loss_and_grads(x_pad, layers)
        # the gradients a peer would receive, the error carried in float32
        if self.scheme == "int8":
            grads, self.error = gc.compress_int8(grads, self.error)
        elif self.scheme == "topk":
            grads, self.error = gc.compress_topk(grads, self.error,
                                                 self.topk_frac)
        upd, self.opt_state = self.opt.update(grads, self.opt_state,
                                              self.params)
        self.params = optim.apply_updates(self.params, upd)
        return loss

    # --------------------------------------------------------------- step
    def step(self, mb, x_in, key=None) -> float:
        """One measured forward/backward/optimizer step over ``x_in``, the
        resolved feature rows for ``mb.input_nodes`` (an
        :class:`InputRows` or an array). Returns its measured seconds;
        loss/edge-count/timing streams accumulate on the engine.
        """
        layers, x_rows, n_edges = self.prepare(mb, key)
        x_pad = self.input_rows(x_in, x_rows)
        if self.parity_max_diff is None:
            self.check_parity(mb, x_in, _prep=(layers, x_pad))
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = self._step_fn(x_pad, layers)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            loss = self._step_fn(x_pad, layers)
            dt = time.perf_counter() - t0
        self.losses.append(float(loss))
        self.step_s.append(float(dt))
        self.step_edges.append(int(n_edges))
        return float(dt)

    # ------------------------------------------------------------- parity
    @torch.no_grad()
    def check_parity(self, mb, x_in, tol: float | None = None, _prep=None):
        """Assert CSR-path forward == scatter reference on this batch.

        The reference is ``sage.apply_blocks`` (per-edge gather + scatter
        mean) on the UNPADDED blocks, which index only the input's own
        rows; the CSR path must agree on every valid dst row within
        float-accumulation tolerance.
        """
        tol = self._parity_tol if tol is None else tol
        if _prep is None:
            layers, x_rows, _ = self.prepare(mb)
            x_pad = self.input_rows(x_in, x_rows)
        else:
            layers, x_pad = _prep
        got = self._forward(self.params, x_pad, layers)
        dev = self.device
        ref_blocks = [
            {
                "edge_src": torch.as_tensor(b.edge_src).to(dev),
                "edge_dst": torch.as_tensor(b.edge_dst).to(dev),
                "edge_mask": torch.as_tensor(b.edge_mask).to(dev),
                "dst_pos": torch.as_tensor(b.dst_pos).to(dev),
            }
            for b in mb.blocks
        ]
        ref = sage.apply_blocks(self.params, self.mcfg, x_pad, ref_blocks)
        n = ref.shape[0]
        valid = np.asarray(mb.blocks[-1].dst_mask, bool)
        diff = (got[:n] - ref).abs().cpu().numpy()[valid]
        self.parity_max_diff = float(diff.max()) if diff.size else 0.0
        if self.parity_max_diff > tol:
            raise AssertionError(
                f"CSR-path/scatter parity violated: max |diff| "
                f"{self.parity_max_diff:.3e} > {tol:.0e}"
            )
        return self.parity_max_diff

    # ---------------------------------------------------------- reporting
    def model_eval(self, graph) -> float:
        from repro_torch.train import gnn_trainer as gt

        return gt._model_eval(self.params, self.mcfg, graph, self.device)

    def report(self) -> dict:
        return {
            "n_steps": len(self.step_s),
            "losses": list(self.losses),
            "step_s": list(self.step_s),
            "step_edges": list(self.step_edges),
            "device": str(self.device),
            "grad_compression": self.scheme,
            "sync_wire_bytes": self.sync_wire_bytes,
            "parity_max_diff": self.parity_max_diff,
        }
