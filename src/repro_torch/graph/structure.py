"""Graph containers.

Graphs are stored as COO edge lists (``edge_index`` of shape (2, E),
row 0 = src, row 1 = dst) plus a lazily-built CSR view for sampling.
JAX has no CSR/CSC sparse support (BCOO only), so message passing is done
via segment ops over the edge index — the CSR here exists for the *host*
sampler only.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSR:
    indptr: np.ndarray   # (N+1,)
    indices: np.ndarray  # (E,) neighbor ids, grouped by source node


def build_csr(edge_index: np.ndarray, n_nodes: int) -> CSR:
    """CSR over *incoming* message direction: indices[j] are the in-neighbors
    (sources) grouped by destination — what neighbor sampling expands."""
    src, dst = edge_index
    order = np.argsort(dst, kind="stable")
    sorted_src = src[order]
    counts = np.bincount(dst, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSR(indptr=indptr, indices=sorted_src)


@dataclasses.dataclass
class Graph:
    """An attributed graph (host-side container; arrays are numpy)."""

    n_nodes: int
    edge_index: np.ndarray                 # (2, E) int64
    features: np.ndarray | None = None     # (N, F)
    labels: np.ndarray | None = None       # (N,)
    positions: np.ndarray | None = None    # (N, 3) for geometric models
    edge_feat: np.ndarray | None = None    # (E, Fe)
    feature_source: object | None = None   # chunked out-of-core row source
                                           # (datasets.StreamingFeatures)
                                           # when features is None
    _csr: CSR | None = dataclasses.field(default=None, repr=False)

    @property
    def n_edges(self) -> int:
        return self.edge_index.shape[1]

    @property
    def csr(self) -> CSR:
        if self._csr is None:
            self._csr = build_csr(self.edge_index, self.n_nodes)
        return self._csr

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.edge_index[1], minlength=self.n_nodes)

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.edge_index[0], minlength=self.n_nodes)

    def validate(self) -> None:
        assert self.edge_index.shape[0] == 2
        assert self.edge_index.min() >= 0
        assert self.edge_index.max() < self.n_nodes
        if self.features is not None:
            assert self.features.shape[0] == self.n_nodes

    def add_self_loops(self) -> "Graph":
        loops = np.arange(self.n_nodes, dtype=self.edge_index.dtype)
        ei = np.concatenate(
            [self.edge_index, np.stack([loops, loops])], axis=1
        )
        return dataclasses.replace(self, edge_index=ei, _csr=None, edge_feat=None)


def pad_edges(
    edge_index: np.ndarray, n_target: int, pad_node: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pad an edge list to a static size; padding edges point at ``pad_node``
    (a dedicated dummy node whose messages are masked out). Returns
    (padded_edge_index, mask)."""
    e = edge_index.shape[1]
    if e > n_target:
        raise ValueError(f"edge list {e} exceeds static budget {n_target}")
    pad = n_target - e
    pad_edges_ = np.full((2, pad), pad_node, edge_index.dtype)
    mask = np.concatenate([np.ones(e, bool), np.zeros(pad, bool)])
    return np.concatenate([edge_index, pad_edges_], axis=1), mask
