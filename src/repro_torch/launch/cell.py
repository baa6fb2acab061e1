"""Cell builders for the GNN zoo and FM on one device.

Port of the GNN and FM part of ``repro/launch/cell.py``, with no mesh and
no sharding: ``build_gnn_cell`` and ``build_fm_cell`` return the
reference's step (the loss, its gradients, the reference's AdamW, clipping
where it clips) and, where the reference has abstract stand-ins, real
inputs drawn from ``seed``:

  * graph shapes: ``graph.synthetic.power_law_graph`` at the shape's nodes
    and features (positions for NequIP and MACE, whose species are drawn
    uniform), its edges padded to the cell's count with masked edges;
  * ``molecule``: ``graph.synthetic.molecule_batch(128, 30, 64,
    n_species=32)`` (the config's species count for NequIP and MACE: 32
    at their full configs);
  * FM: ids uniform over each field's vocabulary, 0/1 labels, candidate
    rows uniform over the table.

The returned dict holds ``step_fn``, its ``args`` (parameters, optimizer
state and inputs, on ``device``), ``cfg``, ``kind`` and ``meta``; a train
cell also holds ``loss_fn(params, *inputs)``. ``device`` defaults to the
card and raises without one. The LM cell and the FLOP counting are not
ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs.registry import ArchDef
from repro_torch.configs.shapes import FM_SHAPES, GNN_SHAPES
from repro_torch.device import resolve
from repro_torch.graph import synthetic
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten

GEOMETRIC = ("nequip", "mace")
EDGE_PAD = 512                 # edges padded to a multiple of this
CHUNK_ABOVE = 4_000_000        # geometric models chunk edges above this
EDGE_CHUNK = 524_288
MOLECULE_SPECIES = 32          # the molecule shape's species (full configs')


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _gnn_graph_arrays(arch: ArchDef, shape) -> tuple[int, int, int, int]:
    """(n_nodes, n_edges, d_feat, edge_chunk) of a graph-shaped cell at one
    device: edges padded to a multiple of 512, and to the chunk for a
    geometric model above 4M edges."""
    geometric = arch.arch_id in GEOMETRIC
    if shape.kind == "molecule":
        n_nodes = shape.batch_graphs * shape.atoms_per_graph
        n_edges = shape.batch_graphs * shape.edges_per_graph
        d_feat = 16
    else:
        n_nodes, n_edges, d_feat = shape.n_nodes, shape.n_edges, shape.d_feat
        if shape.kind == "minibatch":
            # the unified sampled-subgraph representation: S0 src nodes of
            # the inner block; edges of both levels
            f0, f1 = shape.fanouts
            n_nodes = shape.batch_nodes * (f0 + 1) * (f1 + 1)    # 180224
            n_edges = (shape.batch_nodes * (f0 + 1) * f1
                       + shape.batch_nodes * f0)
    edge_chunk = 0
    if geometric and n_edges > CHUNK_ABOVE:
        edge_chunk = EDGE_CHUNK
        n_edges = _pad_to(n_edges, edge_chunk)
    return n_nodes, _pad_to(n_edges, EDGE_PAD), d_feat, edge_chunk


def _pad_edges(edge_index: np.ndarray, n_edges: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """``edge_index`` cut or padded to ``n_edges`` (padding edges point at
    node 0) and the mask of the real ones."""
    e = min(edge_index.shape[1], n_edges)
    ei = np.zeros((2, n_edges), np.int64)
    ei[:, :e] = edge_index[:, :e]
    mask = np.zeros(n_edges, bool)
    mask[:e] = True
    return ei, mask


def gnn_inputs(arch: ArchDef, shape_name: str, cfg, seed: int = 0) -> dict:
    """The cell's inputs as numpy arrays, in the order of the reference's
    step after ``(params, opt_state)``: ``x, edge_index, edge_mask,
    labels, label_mask`` (PNA, GatedGCN) or ``species, positions,
    edge_index, edge_mask, graph_id, targets`` (NequIP, MACE)."""
    shape = GNN_SHAPES[shape_name]
    n_nodes, n_edges, d_feat, _ = _gnn_graph_arrays(arch, shape)
    geometric = arch.arch_id in GEOMETRIC
    rng = np.random.default_rng(seed + 1)
    if shape.kind == "molecule":
        mol = synthetic.molecule_batch(
            shape.batch_graphs, shape.atoms_per_graph, shape.edges_per_graph,
            n_species=getattr(cfg, "n_species", MOLECULE_SPECIES), seed=seed)
        edge_index, edge_mask = _pad_edges(mol["edge_index"], n_edges)
        edge_mask &= np.pad(mol["edge_mask"],
                            (0, n_edges - mol["edge_mask"].shape[0]))
        if geometric:
            return {
                "species": mol["species"].astype(np.int64),
                "positions": mol["positions"],
                "edge_index": edge_index, "edge_mask": edge_mask,
                "graph_id": mol["graph_id"].astype(np.int64),
                "targets": rng.standard_normal(
                    shape.batch_graphs).astype(np.float32),
            }
        return {
            "x": rng.standard_normal((n_nodes, d_feat)).astype(np.float32),
            "edge_index": edge_index, "edge_mask": edge_mask,
            "labels": (mol["species"] % cfg.n_classes).astype(np.int64),
            "label_mask": np.ones(n_nodes, np.float32),
        }
    graph = synthetic.power_law_graph(
        n_nodes, n_edges / n_nodes,
        n_feat=0 if geometric else d_feat,
        n_classes=1 if geometric else cfg.n_classes,
        seed=seed, with_positions=geometric)
    edge_index, edge_mask = _pad_edges(graph.edge_index, n_edges)
    if geometric:
        return {
            "species": rng.integers(0, cfg.n_species, n_nodes),
            "positions": graph.positions,
            "edge_index": edge_index, "edge_mask": edge_mask,
            "graph_id": np.zeros(n_nodes, np.int64),
            "targets": rng.standard_normal(1).astype(np.float32),
        }
    return {
        "x": graph.features, "edge_index": edge_index,
        "edge_mask": edge_mask, "labels": graph.labels.astype(np.int64),
        "label_mask": np.ones(n_nodes, np.float32),
    }


def value_and_grad(loss_fn, params, *inputs):
    """``loss_fn(params, *inputs)`` and its gradient with respect to every
    parameter, as a tree of ``params``' structure; a parameter the loss
    does not reach (the last GatedGCN layer's edge update) gets zeros, as
    JAX gives it."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), *inputs)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def _train_step(loss_fn, opt):
    def step_fn(params, opt_state, *inputs):
        loss, grads = value_and_grad(loss_fn, params, *inputs)
        updates, new_opt = opt.update(grads, opt_state, params)
        return optim.apply_updates(params, updates), new_opt, loss

    return step_fn


def _model(arch_id: str):
    from repro_torch.models.gnn import gatedgcn, mace, nequip, pna

    return {"pna": pna, "gatedgcn": gatedgcn, "nequip": nequip,
            "mace": mace}[arch_id]


def build_gnn_cell(arch: ArchDef, shape_name: str, device="cuda",
                   seed: int = 0) -> dict:
    """The reference's GNN train step at ``arch``'s config: node
    classification with cross-entropy (PNA, GatedGCN) or per-graph
    energies with MSE (NequIP, MACE), ``adamw(3e-3, max_grad_norm=1.0)``;
    parameters drawn from ``seed`` and the inputs of :func:`gnn_inputs`
    on ``device``."""
    from repro_torch.models.gnn import common

    dev = resolve(device)
    shape = GNN_SHAPES[shape_name]
    n_nodes, n_edges, d_feat, edge_chunk = _gnn_graph_arrays(arch, shape)
    model = _model(arch.arch_id)
    opt = optim.adamw(3e-3, max_grad_norm=1.0)
    if arch.arch_id in GEOMETRIC:
        cfg = dataclasses.replace(arch.make_config(), edge_chunk=edge_chunk)
        n_graphs = shape.batch_graphs if shape.kind == "molecule" else 1

        def loss_fn(p, species, positions, edge_index, edge_mask, graph_id,
                    targets):
            e = model.apply(p, cfg, species, positions, edge_index,
                            edge_mask, graph_id, n_graphs)
            return torch.mean((e - targets) ** 2)
    else:
        cfg = arch.make_config(d_in=d_feat)
        if arch.arch_id == "pna":
            def apply_fn(p, x, ei, em):
                return model.apply_full(p, cfg, x, ei, em)
        else:
            def apply_fn(p, x, ei, em):
                return model.apply_full(p, cfg, x, ei, edge_mask=em)

        def loss_fn(p, x, edge_index, edge_mask, labels, label_mask):
            logits = apply_fn(p, x, edge_index, edge_mask)
            return common.cross_entropy(logits, labels, label_mask)

    params, _ = model.init(cfg, seed=seed, device=dev)
    inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in gnn_inputs(arch, shape_name, cfg, seed).values()]
    return {"step_fn": _train_step(loss_fn, opt), "loss_fn": loss_fn,
            "args": (params, opt.init(params), *inputs), "cfg": cfg,
            "kind": "train_step",
            "meta": {"n_nodes": n_nodes, "n_edges": n_edges,
                     "edge_chunk": edge_chunk}}


def fm_inputs(cfg, shape_name: str, seed: int = 0) -> dict:
    """The cell's inputs as numpy int64/float32 arrays: ``ids, labels``
    (train), ``ids`` (serve) or ``query_ids, candidate_rows``
    (retrieval)."""
    shape = FM_SHAPES[shape_name]
    rng = np.random.default_rng(seed + 1)
    vocab = np.asarray(cfg.vocab_sizes, np.int64)
    if shape.kind == "retrieval":
        return {
            "query_ids": rng.integers(0, vocab[:-1]),
            "candidate_rows": rng.integers(0, cfg.total_rows,
                                           shape.n_candidates),
        }
    ids = rng.integers(0, vocab, (shape.batch, cfg.n_fields))
    if shape.kind == "serve":
        return {"ids": ids}
    return {"ids": ids,
            "labels": rng.integers(0, 2, shape.batch).astype(np.float32)}


def build_fm_cell(arch: ArchDef, shape_name: str, device="cuda",
                  seed: int = 0) -> dict:
    """The reference's FM step at ``arch``'s config: a train step
    (``adamw(1e-3)`` on ``bce_loss``), a serve step (``scores``) or a
    retrieval step (``retrieval_scores`` of one query against the
    candidates); parameters drawn from ``seed`` and the inputs of
    :func:`fm_inputs` on ``device``."""
    from repro_torch.models.recsys import fm as model

    dev = resolve(device)
    cfg = arch.make_config()
    shape = FM_SHAPES[shape_name]
    params, _ = model.init(cfg, seed=seed, device=dev)
    offsets = torch.from_numpy(model.offsets(cfg)).to(dev)
    inputs = [torch.from_numpy(a).to(dev)
              for a in fm_inputs(cfg, shape_name, seed).values()]
    cell = {"cfg": cfg, "meta": {"total_rows": cfg.total_rows}}
    if shape.kind == "train":
        opt = optim.adamw(1e-3)

        def loss_fn(p, ids, labels):
            return model.bce_loss(p, cfg, ids, labels, offsets)

        return {**cell, "step_fn": _train_step(loss_fn, opt),
                "loss_fn": loss_fn, "kind": "train_step",
                "args": (params, opt.init(params), *inputs)}
    if shape.kind == "serve":
        def step_fn(p, ids):
            return model.scores(p, cfg, ids, offsets)
    else:
        def step_fn(p, query_ids, candidate_rows):
            return model.retrieval_scores(p, cfg, query_ids, offsets[:-1],
                                          candidate_rows)
        cell["meta"]["n_candidates"] = shape.n_candidates
    return {**cell, "step_fn": step_fn, "kind": "serve_step",
            "args": (params, *inputs)}

