"""Assigned input shapes per family (the x-axis of the 40-cell matrix).

A copy of ``repro/configs/shapes.py`` (plain dataclasses, no JAX).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


LM_SHAPES = {
    "train_4k": LMShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": LMShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": LMShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": LMShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    kind: str  # "full_graph" | "minibatch" | "molecule"
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanouts: tuple = ()
    batch_graphs: int = 0
    atoms_per_graph: int = 0
    edges_per_graph: int = 0


GNN_SHAPES = {
    "full_graph_sm": GNNShape(
        "full_graph_sm", "full_graph", n_nodes=2_708, n_edges=10_556,
        d_feat=1_433,
    ),
    "minibatch_lg": GNNShape(
        "minibatch_lg", "minibatch", n_nodes=232_965, n_edges=114_615_892,
        d_feat=602, batch_nodes=1_024, fanouts=(15, 10),
    ),
    "ogb_products": GNNShape(
        "ogb_products", "full_graph", n_nodes=2_449_029, n_edges=61_859_140,
        d_feat=100,
    ),
    "molecule": GNNShape(
        "molecule", "molecule", batch_graphs=128, atoms_per_graph=30,
        edges_per_graph=64,
    ),
}


@dataclasses.dataclass(frozen=True)
class FMShape:
    name: str
    kind: str  # "train" | "serve" | "retrieval"
    batch: int
    n_candidates: int = 0


FM_SHAPES = {
    "train_batch": FMShape("train_batch", "train", 65_536),
    "serve_p99": FMShape("serve_p99", "serve", 512),
    "serve_bulk": FMShape("serve_bulk", "serve", 262_144),
    "retrieval_cand": FMShape("retrieval_cand", "retrieval", 1, 1_000_000),
}
