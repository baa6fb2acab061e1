"""Cell builders: (architecture x input shape) -> one step on one device.

Port of ``repro/launch/cell.py`` without a device mesh: ``build_cell``
dispatches to ``build_lm_cell`` (``train``: the loss and gradients of
``cfg.grad_accum`` microbatches and the reference's AdamW, through
``launch.train.make_train_step``; ``prefill``; ``decode``, one token
against a cache of the shape's length), ``build_gnn_cell`` (PNA,
GatedGCN and GraphSAGE node classification, NequIP and MACE energies)
and ``build_fm_cell`` (FM train, serve, retrieval). Each returns the
reference's step and, where the reference has abstract stand-ins, real
inputs drawn from ``seed``:

  * LM tokens and targets uniform over the vocabulary;
  * graph shapes: ``graph.synthetic.power_law_graph`` at the shape's nodes
    and features (positions for NequIP and MACE, whose species are drawn
    uniform), its edges padded to the cell's count with masked edges;
  * ``molecule``: ``graph.synthetic.molecule_batch(128, 30, 64,
    n_species=32)`` (the config's species count for NequIP and MACE: 32
    at their full configs);
  * FM: ids uniform over each field's vocabulary, 0/1 labels, candidate
    rows uniform over the table.

On ``device="meta"`` nothing is drawn or allocated: the parameters, the
optimizer state and the inputs are empty meta tensors of the cell's
shapes and dtypes (``ogb_products``' 61.9M edges cost nothing), the
step runs shapes only, and the kernel wrappers charge the counter
(``launch.count``). That is the port's dry-run (``launch.dryrun``).

The returned dict holds ``step_fn``, its ``args`` (parameters, optimizer
state and inputs, on ``device``), ``arg_axes`` (each argument's logical
axes, a tree of tuples beside ``args``: what ``distributed.sharding``
turns into per-device sizes under a mesh's rules, :func:`cell_rules`),
``cfg``, ``kind`` and ``meta``; a GNN or FM train cell also holds
``loss_fn(params, *inputs)``. ``device`` defaults to the card and raises
without one. Node and candidate counts are not padded to a mesh's device
count, as the reference pads them; edges are padded to 512.

An LM cell also builds over a ``torch.distributed`` ``DeviceMesh``
(``build_lm_cell(..., mesh=...)``, under ``launch.mesh.fake_world`` for
the production meshes): its arguments become DTensors at the reference's
placements (``sharding.distribute_tree`` under :func:`cell_rules`), and
its step runs under those rules and that mesh, so it is the program of
one device, this rank's. On ``meta`` nothing is drawn; on the card this
rank's shards are drawn from ``seed`` (parameters by their initialiser
at the whole leaf's fan-in, tokens uniform, optimizer state and cache
zeros). The GNN and FM cells take no mesh.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs.registry import ArchDef
from repro_torch.configs.shapes import FM_SHAPES, GNN_SHAPES, LM_SHAPES
from repro_torch.device import resolve
from repro_torch.distributed import sharding as shlib
from repro_torch.graph import synthetic
from repro_torch.optim.optimizers import OptState, tree_leaves, tree_unflatten

GEOMETRIC = ("nequip", "mace")
EDGE_PAD = 512                 # edges padded to a multiple of this
CHUNK_ABOVE = 4_000_000        # geometric models chunk edges above this
EDGE_CHUNK = 524_288
MOLECULE_SPECIES = 32          # the molecule shape's species (full configs')


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def cell_rules(arch: ArchDef, shape_name: str, mesh) -> dict:
    """The reference's rules of a cell under ``mesh``: the default rules
    (single- or multi-pod), ``cache_seq`` replicated unless the arch says
    otherwise, the arch's overrides; at ``long_500k`` (batch 1) the batch
    is not sharded and the half-million-token cache is spread over the
    data axes (and the model axis where attention heads leave it)."""
    multi = "pod" in shlib.axis_names_of(mesh)
    rules = shlib.default_rules(multi)
    rules.setdefault("cache_seq", None)
    rules.update(arch.rule_overrides)
    if shape_name == "long_500k":
        rules["batch"] = None
        base = rules.get("cache_seq")
        extra = ("pod", "data") if multi else ("data",)
        rules["cache_seq"] = extra + ((base,) if isinstance(base, str)
                                      else ())
    return rules


def _device(device) -> torch.device:
    """``resolve``'s device, or ``meta`` (shapes only)."""
    if torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve(device)


def _opt_axes(axes):
    """The logical axes of an ``OptState`` over parameters with
    ``axes``: the step is a host int, the moments are the parameters'."""
    return OptState(step=None, mu=axes, nu=axes)


def _inputs_on(specs: dict, arrays, dev) -> list:
    """The cell's inputs on ``dev``: the numpy ``arrays`` copied, or on
    ``meta`` empty tensors of the ``specs``' shapes and dtypes."""
    if dev.type == "meta":
        return [torch.empty(shape, dtype=dtype, device=dev)
                for shape, dtype, _ in specs.values()]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays().values()]


# ===================================================================== LM
def build_lm_cell(arch: ArchDef, shape_name: str, device="cuda",
                  seed: int = 0, mesh=None) -> dict:
    """The reference's LM cell at ``arch``'s config: ``train`` (the
    ``make_train_step`` of ``cfg.grad_accum`` microbatches under
    ``adamw(warmup_cosine_schedule(3e-4, 2000, 100_000), weight_decay=0.1,
    max_grad_norm=1.0)``), ``prefill`` (last-position logits) or
    ``decode`` (one token (B, 1) against a bf16 cache of the shape's
    length, written at its last slot)."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.lm import transformer as tf

    if mesh is not None:
        return _over_mesh(arch, shape_name, device, seed, mesh)
    dev = _device(device)
    cfg = arch.make_config()
    shape = LM_SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    params, axes = tf.init(cfg, seed=seed, device=dev, with_axes=True)
    tok_axes = ("batch", "seq")
    gen = torch.Generator().manual_seed(seed + 1)

    def tokens(rows: int, cols: int):
        if dev.type == "meta":
            return torch.empty((rows, cols), dtype=torch.int64, device=dev)
        return torch.randint(0, cfg.vocab, (rows, cols),
                             generator=gen).to(dev)

    cell = {"cfg": cfg, "meta": {"batch": b, "seq_len": s}}
    if shape.kind == "train":
        opt = optim.adamw(optim.warmup_cosine_schedule(3e-4, 2000, 100_000),
                          weight_decay=0.1, max_grad_norm=1.0)
        accum = max(cfg.grad_accum, 1)
        cell["meta"]["grad_accum"] = accum
        return {**cell, "step_fn": make_train_step(cfg, opt, accum),
                "kind": "train_step",
                "args": (params, opt.init(params), tokens(b, s),
                         tokens(b, s)),
                "arg_axes": (axes, _opt_axes(axes), tok_axes, tok_axes)}
    if shape.kind == "prefill":
        def step_fn(p, toks):
            return tf.prefill(p, cfg, toks)

        return {**cell, "step_fn": step_fn, "kind": "serve_step",
                "args": (params, tokens(b, s)),
                "arg_axes": (axes, tok_axes)}
    cache = tf.init_cache(cfg, b, s, dtype=torch.bfloat16, device=dev)

    def step_fn(p, token, cache, cache_len):
        return tf.decode_step(p, cfg, token, cache, cache_len)

    return {**cell, "step_fn": step_fn, "kind": "serve_step",
            "args": (params, tokens(b, 1), cache, s - 1),
            "arg_axes": (axes, tok_axes, tf.cache_specs(cfg), None)}


def _drawn_shard(dev, seed: int, cfg, inits: dict):
    """``local_fn`` of ``sharding.distribute_tree`` on the card: a
    parameter's shard drawn by its initialiser at the whole leaf's fan-in
    (``inits``: ``id`` of its meta leaf -> (initialiser, fan-in, stacked)),
    token ids uniform over the vocabulary, anything else zeros."""
    from repro_torch.models import param as P

    gen = torch.Generator(device=dev).manual_seed(seed)
    tok_gen = torch.Generator().manual_seed(seed + 1)

    def local_fn(t, shape, offset):
        init = inits.get(id(t))
        if init is not None:
            how, fan_in, stacked = init
            scale = None if how != "normal" else 1.0 / fan_in ** 0.5
            if stacked:
                return P.param(shape[1:], gen, how, dev, t.dtype,
                               layers=shape[0], scale=scale)
            return P.param(shape, gen, how, dev, t.dtype, scale=scale)
        if t.dtype == torch.int64:
            return torch.randint(0, cfg.vocab, shape, generator=tok_gen
                                 ).to(dev)
        return torch.zeros(shape, dtype=t.dtype, device=dev)

    return local_fn


def _over_mesh(arch: ArchDef, shape_name: str, device, seed: int,
               dmesh) -> dict:
    """The LM cell over the ``DeviceMesh`` ``dmesh``: the meta cell's
    arguments distributed at the reference's placements, its step run
    under the cell's rules and ``dmesh`` (see the module's doc)."""
    from repro_torch.models.lm import transformer as tf

    dev = _device(device)
    cell = build_lm_cell(arch, shape_name, "meta", seed)
    rules = cell_rules(arch, shape_name, dmesh)
    local_fn = None
    if dev.type != "meta":
        params = cell["args"][0]
        inits = {}
        for name, init in tf.param_inits(cell["cfg"]).items():
            leaf = params[name]
            if isinstance(init, dict):
                for k, (how, fan_in) in init.items():
                    inits[id(leaf[k])] = (how, fan_in, name == "layers")
            else:
                inits[id(leaf)] = (*init, False)
        local_fn = _drawn_shard(dev, seed, cell["cfg"], inits)
    args = shlib.distribute_tree(cell["args"], cell["arg_axes"], rules,
                                 dmesh, local_fn)
    step = cell["step_fn"]

    def step_fn(*a):
        with shlib.use_rules(rules, dmesh):
            return step(*a)

    meta = dict(cell["meta"], mesh=dict(zip(dmesh.mesh_dim_names,
                                            dmesh.mesh.shape)))
    return {**cell, "step_fn": step_fn, "args": args, "rules": rules,
            "meta": meta}


# ===================================================================== GNN


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


def gnn_input_specs(arch: ArchDef, shape_name: str, cfg) -> dict:
    """name -> (shape, dtype, logical axes) of the cell's inputs, in
    :func:`gnn_inputs`' order, with the reference's axes."""
    shape = GNN_SHAPES[shape_name]
    n, e, d_feat, _ = _gnn_graph_arrays(arch, shape)
    i64, f32 = torch.int64, torch.float32
    edges = {"edge_index": ((2, e), i64, (None, "edges")),
             "edge_mask": ((e,), torch.bool, ("edges",))}
    if arch.arch_id in GEOMETRIC:
        n_graphs = shape.batch_graphs if shape.kind == "molecule" else 1
        return {"species": ((n,), i64, ("nodes",)),
                "positions": ((n, 3), f32, ("nodes", None)),
                **edges,
                "graph_id": ((n,), i64, ("nodes",)),
                # a single graph's energy cannot be sharded
                "targets": ((n_graphs,), f32,
                            ("graph_batch",) if n_graphs > 1 else (None,))}
    return {"x": ((n, d_feat), f32, ("nodes", None)), **edges,
            "labels": ((n,), i64, ("nodes",)),
            "label_mask": ((n,), f32, ("nodes",))}


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
    from repro_torch.models.gnn import gatedgcn, mace, nequip, pna, sage

    return {"pna": pna, "gatedgcn": gatedgcn, "nequip": nequip,
            "mace": mace, "greendygnn-sage": sage}[arch_id]


def _init(model, cfg, seed: int, dev) -> tuple[dict, dict]:
    """``(params, axes)`` of a GNN model on ``dev``. GraphSAGE's ``init``
    is the trainer's (a CPU generator, no axes): its axes are
    ``sage.param_axes``."""
    if model.__name__.endswith(".sage"):
        return (model.init(cfg, torch.Generator().manual_seed(seed),
                           device=dev), model.param_axes(cfg))
    return model.init(cfg, seed=seed, device=dev)


def build_gnn_cell(arch: ArchDef, shape_name: str, device="cuda",
                   seed: int = 0) -> dict:
    """The reference's GNN train step at ``arch``'s config: node
    classification with cross-entropy (PNA, GatedGCN, GraphSAGE through
    ``sage.apply_full``) or per-graph energies with MSE (NequIP, MACE),
    ``adamw(3e-3, max_grad_norm=1.0)``; parameters drawn from ``seed``
    and the inputs of :func:`gnn_inputs` on ``device`` (on ``meta``,
    empty tensors of :func:`gnn_input_specs`)."""
    from repro_torch.models.gnn import common

    dev = _device(device)
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
        if arch.arch_id == "gatedgcn":
            def apply_fn(p, x, ei, em):
                return model.apply_full(p, cfg, x, ei, edge_mask=em)
        else:       # pna, greendygnn-sage
            def apply_fn(p, x, ei, em):
                return model.apply_full(p, cfg, x, ei, em)

        def loss_fn(p, x, edge_index, edge_mask, labels, label_mask):
            logits = apply_fn(p, x, edge_index, edge_mask)
            return common.cross_entropy(logits, labels, label_mask)

    params, axes = _init(model, cfg, seed, dev)
    specs = gnn_input_specs(arch, shape_name, cfg)
    inputs = _inputs_on(specs, lambda: gnn_inputs(arch, shape_name, cfg,
                                                  seed), dev)
    return {"step_fn": _train_step(loss_fn, opt), "loss_fn": loss_fn,
            "args": (params, opt.init(params), *inputs), "cfg": cfg,
            "arg_axes": (axes, _opt_axes(axes),
                         *(a for _, _, a in specs.values())),
            "kind": "train_step",
            "meta": {"n_nodes": n_nodes, "n_edges": n_edges,
                     "edge_chunk": edge_chunk}}


def fm_input_specs(cfg, shape_name: str) -> dict:
    """name -> (shape, dtype, logical axes) of the cell's inputs, in
    :func:`fm_inputs`' order, with the reference's axes."""
    shape = FM_SHAPES[shape_name]
    i64 = torch.int64
    if shape.kind == "retrieval":
        return {"query_ids": ((cfg.n_fields - 1,), i64, (None,)),
                "candidate_rows": ((shape.n_candidates,), i64,
                                   ("candidates",))}
    ids = {"ids": ((shape.batch, cfg.n_fields), i64, ("batch", None))}
    if shape.kind == "serve":
        return ids
    return {**ids, "labels": ((shape.batch,), torch.float32, ("batch",))}


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
    :func:`fm_inputs` on ``device`` (on ``meta``, empty tensors of
    :func:`fm_input_specs`)."""
    from repro_torch.models.recsys import fm as model

    dev = _device(device)
    cfg = arch.make_config()
    shape = FM_SHAPES[shape_name]
    params, axes = model.init(cfg, seed=seed, device=dev)
    offsets = torch.from_numpy(model.offsets(cfg)).to(dev)
    specs = fm_input_specs(cfg, shape_name)
    inputs = _inputs_on(specs, lambda: fm_inputs(cfg, shape_name, seed), dev)
    in_axes = tuple(a for _, _, a in specs.values())
    cell = {"cfg": cfg, "meta": {"total_rows": cfg.total_rows}}
    if shape.kind == "train":
        opt = optim.adamw(1e-3)

        def loss_fn(p, ids, labels):
            return model.bce_loss(p, cfg, ids, labels, offsets)

        return {**cell, "step_fn": _train_step(loss_fn, opt),
                "loss_fn": loss_fn, "kind": "train_step",
                "args": (params, opt.init(params), *inputs),
                "arg_axes": (axes, _opt_axes(axes), *in_axes)}
    if shape.kind == "serve":
        def step_fn(p, ids):
            return model.scores(p, cfg, ids, offsets)
    else:
        def step_fn(p, query_ids, candidate_rows):
            return model.retrieval_scores(p, cfg, query_ids, offsets[:-1],
                                          candidate_rows)
        cell["meta"]["n_candidates"] = shape.n_candidates
    return {**cell, "step_fn": step_fn, "kind": "serve_step",
            "args": (params, *inputs), "arg_axes": (axes, *in_axes)}


def build_cell(arch: ArchDef, shape_name: str, device="cuda",
               seed: int = 0, mesh=None) -> dict:
    """The cell of ``arch`` at ``shape_name``, by the arch's family; over
    the ``DeviceMesh`` ``mesh`` for an LM arch."""
    if arch.family == "lm":
        return build_lm_cell(arch, shape_name, device, seed, mesh)
    if mesh is not None:
        raise NotImplementedError(
            f"cell over a mesh: {arch.family} cells run on one device")
    if arch.family == "gnn":
        return build_gnn_cell(arch, shape_name, device, seed)
    if arch.family == "recsys":
        return build_fm_cell(arch, shape_name, device, seed)
    raise ValueError(arch.family)

