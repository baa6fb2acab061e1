"""Multi-hop fanout neighbor sampling (DGL DistSampler stand-in).

The sampler runs on the host (numpy), matching the paper's Stage-1
"background sampler thread". It produces *blocks* — per-layer bipartite
edge lists with static padded shapes — suitable for jit'd GNN forward
passes, plus the set of input (frontier) nodes whose features must be
resolved (locally, from cache, or remotely: the GreenDyGNN hot path).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structure import Graph


@dataclasses.dataclass
class Block:
    """One message-passing layer: edges from src_nodes -> dst_nodes.

    Node ids are *local* to the block: dst j of layer L corresponds to
    src_nodes[j] of layer L+1. ``src_nodes``/``dst_nodes`` map local -> global.
    """

    src_nodes: np.ndarray   # (S,) global ids (padded with pad_node)
    dst_nodes: np.ndarray   # (D,) global ids
    edge_src: np.ndarray    # (E,) local src index
    edge_dst: np.ndarray    # (E,) local dst index
    edge_mask: np.ndarray   # (E,) bool
    src_mask: np.ndarray    # (S,) bool — real vs padding
    dst_pos: np.ndarray = None  # (D,) position of each dst inside src_nodes
    dst_mask: np.ndarray = None  # (D,) bool


@dataclasses.dataclass
class MiniBatch:
    blocks: list[Block]          # ordered input-layer -> output-layer
    input_nodes: np.ndarray      # global ids needing features (= blocks[0].src_nodes)
    input_mask: np.ndarray
    seeds: np.ndarray            # target nodes (labels live here)
    seed_mask: np.ndarray


def sample_blocks(
    graph: Graph,
    seeds: np.ndarray,
    fanouts: list[int],
    rng: np.random.Generator,
    pad: bool = True,
) -> MiniBatch:
    """Layer-wise uniform neighbor sampling with replacement.

    fanouts are listed from the *output* layer inward (DGL convention
    [25, 10] means: seeds expand by 25, that frontier expands by 10... here
    we follow [f_out, ..., f_in] and build blocks inner-first)."""
    indptr, indices = graph.csr.indptr, graph.csr.indices
    blocks_rev: list[Block] = []
    frontier = np.unique(seeds)
    for fanout in fanouts:
        dst_nodes = frontier
        deg = indptr[dst_nodes + 1] - indptr[dst_nodes]
        has_nbr = deg > 0
        # sample `fanout` in-neighbors with replacement per dst
        offs = (
            rng.random((len(dst_nodes), fanout)) * np.maximum(deg, 1)[:, None]
        ).astype(np.int64)
        nbrs = indices[indptr[dst_nodes][:, None] + offs]  # (D, fanout)
        edge_dst_local = np.repeat(np.arange(len(dst_nodes)), fanout)
        edge_src_global = nbrs.reshape(-1)
        valid = np.repeat(has_nbr, fanout)
        edge_dst_local = edge_dst_local[valid]
        edge_src_global = edge_src_global[valid]

        # src node set = sampled neighbors + the dst nodes themselves
        # (self features needed by SAGE-style concat update)
        src_nodes, inverse = np.unique(
            np.concatenate([dst_nodes, edge_src_global]), return_inverse=True
        )
        dst_pos = inverse[: len(dst_nodes)]
        edge_src_local = inverse[len(dst_nodes):]
        blocks_rev.append(
            Block(
                src_nodes=src_nodes,
                dst_nodes=dst_nodes,
                edge_src=edge_src_local,
                edge_dst=edge_dst_local,
                edge_mask=np.ones(len(edge_src_local), bool),
                src_mask=np.ones(len(src_nodes), bool),
                dst_pos=dst_pos,
                dst_mask=np.ones(len(dst_nodes), bool),
            )
        )
        frontier = src_nodes
    blocks = blocks_rev[::-1]
    mb = MiniBatch(
        blocks=blocks,
        input_nodes=blocks[0].src_nodes,
        input_mask=blocks[0].src_mask,
        seeds=np.asarray(seeds),
        seed_mask=np.ones(len(seeds), bool),
    )
    return pad_minibatch(mb, fanouts) if pad else mb


def _pad_block(block: Block, n_src: int, n_dst: int, n_edge: int) -> Block:
    def pad_ids(a, n):
        out = np.zeros(n, a.dtype)
        out[: len(a)] = a
        return out

    def pad_mask(k, n):
        m = np.zeros(n, bool)
        m[:k] = True
        return m

    return Block(
        src_nodes=pad_ids(block.src_nodes, n_src),
        dst_nodes=pad_ids(block.dst_nodes, n_dst),
        edge_src=pad_ids(block.edge_src, n_edge),
        edge_dst=pad_ids(block.edge_dst, n_edge),
        edge_mask=pad_mask(len(block.edge_src), n_edge),
        src_mask=pad_mask(len(block.src_nodes), n_src),
        dst_pos=pad_ids(block.dst_pos, n_dst),
        dst_mask=pad_mask(len(block.dst_nodes), n_dst),
    )


def static_block_sizes(batch_size: int, fanouts: list[int]) -> list[tuple]:
    """Upper-bound (n_src, n_dst, n_edge) per block for padding.

    Walks in construction order (output block first, fanouts[0]); block k's
    src bound becomes block k-1's dst bound. Returned in input->output order
    to match MiniBatch.blocks."""
    sizes_rev = []
    n_dst = batch_size
    for f in fanouts:
        sizes_rev.append((n_dst * (f + 1), n_dst, n_dst * f))
        n_dst = n_dst * (f + 1)
    return sizes_rev[::-1]


def pad_minibatch(mb: MiniBatch, fanouts: list[int]) -> MiniBatch:
    batch = len(mb.seeds)
    sizes = static_block_sizes(batch, fanouts)
    blocks = [
        _pad_block(b, *s) for b, s in zip(mb.blocks, sizes)
    ]
    return MiniBatch(
        blocks=blocks,
        input_nodes=blocks[0].src_nodes,
        input_mask=blocks[0].src_mask,
        seeds=mb.seeds,
        seed_mask=np.ones(batch, bool),
    )


def presample_epoch(
    graph: Graph,
    train_nodes: np.ndarray,
    batch_size: int,
    fanouts: list[int],
    steps: int,
    rng: np.random.Generator,
    pad: bool = False,
    sequential: bool = False,
    locality_frac: float = 1.0,
) -> list[MiniBatch]:
    """Pre-sample one epoch's trace (RapidGNN/GreenDyGNN presampling).

    sequential=True keeps the caller's node ordering (locality traversal);
    otherwise nodes are permuted (classic random shuffling)."""
    out = []
    perm = train_nodes if sequential else rng.permutation(train_nodes)
    for s in range(steps):
        lo = (s * batch_size) % max(len(perm) - batch_size, 1)
        seeds = perm[lo : lo + batch_size]
        if sequential and locality_frac < 1.0:
            # partial locality: a fraction of each batch is drawn globally
            # (smooths the hit-rate falloff across window sizes)
            n_rand = int((1 - locality_frac) * batch_size)
            if n_rand:
                seeds = np.concatenate([
                    seeds[: batch_size - n_rand],
                    rng.choice(train_nodes, n_rand, replace=False),
                ])
        out.append(sample_blocks(graph, seeds, fanouts, rng, pad=pad))
    return out
