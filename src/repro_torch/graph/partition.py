"""Balanced edge-cut partitioner (METIS stand-in).

METIS is not available offline, so we implement a greedy BFS region-growing
partitioner with the same contract the paper relies on: P balanced parts,
locality-preserving (most edges internal), deterministic. The paper treats
partitioning as orthogonal (Section III); what matters downstream is that
remote accesses concentrate on hub nodes and are roughly balanced across
owners — which BFS growth on power-law graphs reproduces.
"""
from __future__ import annotations

import collections

import numpy as np

from repro_torch.graph.structure import Graph


def partition_graph(
    graph: Graph,
    n_parts: int,
    seed: int = 0,
    degree_bias: float = 0.0,
    biased_part: int = 0,
    hot_frac: float = 0.01,
) -> np.ndarray:
    """Assign each node an owner in [0, n_parts). Greedy BFS region growing:
    grow P regions from spread-out seeds, always expanding the currently
    smallest region through its frontier; unreached nodes round-robin.

    ``degree_bias`` creates *demand skew*: that fraction of the globally
    hottest ``hot_frac`` of nodes (by total degree) is pre-assigned to
    partition ``biased_part`` before region growing, so one partition owns
    a disproportionate share of the hub nodes every remote batch touches.
    Total partition sizes stay balanced (the pre-assigned hubs count
    toward the biased part's quota, so it grows correspondingly less) —
    what skews is the *demand* directed at its NIC, not its node count.
    With the default ``degree_bias=0.0`` the legacy partition is
    reproduced bit-for-bit.
    """
    if not 0.0 <= degree_bias <= 1.0:
        raise ValueError(f"degree_bias must be in [0, 1], got {degree_bias}")
    if degree_bias > 0.0 and not 0 <= biased_part < n_parts:
        raise ValueError(
            f"biased_part {biased_part} outside [0, n_parts={n_parts})"
        )
    rng = np.random.default_rng(seed)
    n = graph.n_nodes
    csr_ptr = graph.csr.indptr
    csr_idx = graph.csr.indices
    out = np.full(n, -1, np.int32)

    # undirected adjacency (union of in/out) for growth
    rev_src, rev_dst = graph.edge_index[1], graph.edge_index[0]
    order = np.argsort(rev_dst, kind="stable")
    rcounts = np.bincount(rev_dst, minlength=n)
    rptr = np.zeros(n + 1, np.int64)
    np.cumsum(rcounts, out=rptr[1:])
    ridx = rev_src[order]

    def neighbors(u: int) -> np.ndarray:
        return np.concatenate(
            [csr_idx[csr_ptr[u] : csr_ptr[u + 1]], ridx[rptr[u] : rptr[u + 1]]]
        )

    # seeds: highest-degree nodes, spaced by choosing from distinct hubs
    deg = graph.in_degrees() + graph.out_degrees()
    by_degree = np.argsort(-deg)     # one full sort, sliced for both the
    pre_hot = None                   # hot set and the hub seeds
    if degree_bias > 0.0:
        # demand skew: pre-claim a degree_bias share of the globally-hot
        # set for one partition (drawn before the seed permutation so the
        # degree_bias=0 path consumes the legacy rng stream untouched)
        n_hot = max(int(np.ceil(hot_frac * n)), 1)
        hot = by_degree[:n_hot]
        take = int(np.round(degree_bias * n_hot))
        pre_hot = hot[np.sort(rng.permutation(n_hot)[:take])]
    hubs = by_degree[: max(8 * n_parts, n_parts)]
    seeds = hubs[rng.permutation(len(hubs))[:n_parts]]

    frontiers = [collections.deque([int(s)]) for s in seeds]
    sizes = np.zeros(n_parts, np.int64)
    if pre_hot is not None and len(pre_hot):
        out[pre_hot] = biased_part
        sizes[biased_part] += len(pre_hot)
        frontiers[biased_part].extend(int(v) for v in pre_hot)
    for p, s in enumerate(seeds):
        if out[s] == -1:
            out[s] = p
            sizes[p] += 1

    # per-node scan pointer into its (concatenated) neighbor list so each
    # adjacency entry is visited at most once overall -> O(E) total
    scan_pos = np.zeros(n, np.int64)
    CHUNK = max(16, n // (64 * n_parts))  # nodes claimed per turn (balance unit)

    n_assigned = int(sizes.sum())
    unseen = iter(rng.permutation(n))  # reseed source for dead frontiers
    while n_assigned < n:
        p = int(np.argmin(sizes))
        fr = frontiers[p]
        claimed = 0
        while fr and claimed < CHUNK:
            u = fr[0]
            nbrs = neighbors(u)
            pos = scan_pos[u]
            while pos < len(nbrs) and claimed < CHUNK:
                v = int(nbrs[pos])
                pos += 1
                if out[v] == -1:
                    out[v] = p
                    sizes[p] += 1
                    fr.append(v)
                    claimed += 1
            scan_pos[u] = pos
            if pos >= len(nbrs):
                fr.popleft()
        if claimed == 0:
            # frontier exhausted: re-seed this part from any unassigned node
            # (keeps regions balanced; also handles disconnected components)
            for cand in unseen:
                if out[cand] == -1:
                    out[cand] = p
                    sizes[p] += 1
                    fr.append(int(cand))
                    claimed = 1
                    break
            if claimed == 0:
                break
        n_assigned += claimed
    return out


def edge_cut(graph: Graph, owner_of: np.ndarray) -> float:
    """Fraction of edges crossing partition boundaries."""
    src, dst = graph.edge_index
    return float(np.mean(owner_of[src] != owner_of[dst]))


def balance(owner_of: np.ndarray, n_parts: int) -> float:
    """max part size / mean part size (1.0 = perfectly balanced)."""
    sizes = np.bincount(owner_of, minlength=n_parts)
    return float(sizes.max() / sizes.mean())


def hot_share(
    graph: Graph, owner_of: np.ndarray, n_parts: int, hot_frac: float = 0.01
) -> np.ndarray:
    """Per-partition ownership share of the globally-hot node set (the
    quantity ``degree_bias`` skews; uniform ~1/P without bias)."""
    deg = graph.in_degrees() + graph.out_degrees()
    n_hot = max(int(np.ceil(hot_frac * graph.n_nodes)), 1)
    hot = np.argsort(-deg)[:n_hot]
    return np.bincount(owner_of[hot], minlength=n_parts) / n_hot


def random_partition(n_nodes: int, n_parts: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_parts, n_nodes).astype(np.int32)
