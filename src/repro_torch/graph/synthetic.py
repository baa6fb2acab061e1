"""Synthetic graph generators.

Real OGB/Reddit downloads are unavailable offline, so the generators below
produce graphs matching the *systems-relevant statistics* of the paper's
datasets: power-law degree distribution (hub nodes -> cacheable hot set),
community structure (so partitioning is meaningful and cross-partition
traffic is hub-concentrated), and configurable scale.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.structure import Graph


def power_law_graph(
    n_nodes: int,
    avg_degree: float,
    n_feat: int = 0,
    n_classes: int = 16,
    n_communities: int = 32,
    zipf_a: float = 1.6,
    intra_frac: float = 0.8,
    seed: int = 0,
    with_positions: bool = False,
) -> Graph:
    """Community-structured configuration-model graph with zipf hubs.

    Edges attach preferentially to low-rank (hub) nodes; ``intra_frac`` of
    edges stay within a community, the rest cross — crossing edges follow the
    same hub bias, concentrating remote traffic on few hot nodes (the regime
    GreenDyGNN's cache exploits).
    """
    rng = np.random.default_rng(seed)
    n_edges = int(n_nodes * avg_degree)
    community = rng.integers(0, n_communities, n_nodes)

    # global hub ranking: node id -> popularity rank via permutation
    rank_of = rng.permutation(n_nodes)

    def zipf_nodes(size: int) -> np.ndarray:
        ranks = (rng.zipf(zipf_a, size) - 1).clip(0, n_nodes - 1)
        return rank_of[ranks]

    dst = rng.integers(0, n_nodes, n_edges)
    src = zipf_nodes(n_edges)
    # rewire intra-community edges: pick src from the dst's community
    intra = rng.random(n_edges) < intra_frac
    comm_sorted = np.argsort(community, kind="stable")
    comm_counts = np.bincount(community, minlength=n_communities)
    comm_start = np.zeros(n_communities + 1, np.int64)
    np.cumsum(comm_counts, out=comm_start[1:])
    c = community[dst[intra]]
    offsets = (rng.random(intra.sum()) * comm_counts[c]).astype(np.int64)
    src_intra = comm_sorted[comm_start[c] + np.minimum(offsets, comm_counts[c] - 1)]
    src[intra] = src_intra

    # remove self loops
    keep = src != dst
    edge_index = np.stack([src[keep], dst[keep]]).astype(np.int64)

    features = (
        rng.standard_normal((n_nodes, n_feat)).astype(np.float32)
        if n_feat
        else None
    )
    labels = (community % n_classes).astype(np.int32)
    if features is not None:
        # make labels learnable: add class-dependent signal
        centers = rng.standard_normal((n_classes, n_feat)).astype(np.float32)
        features += 0.5 * centers[labels]
    positions = (
        rng.uniform(0, 10.0, (n_nodes, 3)).astype(np.float32)
        if with_positions
        else None
    )
    return Graph(
        n_nodes=n_nodes,
        edge_index=edge_index,
        features=features,
        labels=labels,
        positions=positions,
    )


def molecule_batch(
    n_mols: int,
    n_atoms: int = 30,
    n_edges_per_mol: int = 64,
    n_species: int = 8,
    cell: float = 6.0,
    cutoff: float = 3.5,
    seed: int = 0,
) -> dict:
    """A batch of small 3-D molecular graphs (for NequIP/MACE shapes).

    Returns flat batched arrays with static shapes:
      positions (B*A, 3), species (B*A,), edge_index (2, B*Epad) with
      per-molecule radius-graph edges padded/truncated to n_edges_per_mol,
      edge_mask (B*Epad,), graph_id (B*A,).
    """
    rng = np.random.default_rng(seed)
    pos_all, spec_all, ei_all, mask_all = [], [], [], []
    for m in range(n_mols):
        pos = rng.uniform(0, cell, (n_atoms, 3)).astype(np.float32)
        diff = pos[:, None] - pos[None, :]
        dist = np.sqrt((diff ** 2).sum(-1))
        np.fill_diagonal(dist, np.inf)
        src, dst = np.where(dist < cutoff)
        order = rng.permutation(len(src))
        src, dst = src[order], dst[order]
        e = min(len(src), n_edges_per_mol)
        ei = np.full((2, n_edges_per_mol), 0, np.int64)
        mask = np.zeros(n_edges_per_mol, bool)
        ei[0, :e] = src[:e] + m * n_atoms
        ei[1, :e] = dst[:e] + m * n_atoms
        # padding edges self-point at the molecule's atom 0 (masked out)
        ei[:, e:] = m * n_atoms
        mask[:e] = True
        pos_all.append(pos)
        spec_all.append(rng.integers(0, n_species, n_atoms))
        ei_all.append(ei)
        mask_all.append(mask)
    return {
        "positions": np.concatenate(pos_all).astype(np.float32),
        "species": np.concatenate(spec_all).astype(np.int32),
        "edge_index": np.concatenate(ei_all, axis=1),
        "edge_mask": np.concatenate(mask_all),
        "graph_id": np.repeat(np.arange(n_mols), n_atoms).astype(np.int32),
        "n_mols": n_mols,
        "n_atoms": n_atoms,
    }
