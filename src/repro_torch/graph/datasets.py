"""Dataset registry.

Two kinds of entries:
  * SPEC datasets — full-scale shapes (for the dry-run these are only
    ShapeDtypeStructs; nothing is materialized),
  * materialized instances — synthetic graphs at (possibly reduced) scale
    for smoke tests, benchmarks, and the end-to-end examples.

The paper's three datasets are represented by scaled synthetic analogues
with matched degree statistics (see DESIGN.md "Measured vs modeled").
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from repro_torch.graph.structure import Graph
from repro_torch.graph.synthetic import molecule_batch, power_law_graph


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    name: str
    n_nodes: int
    n_edges: int
    d_feat: int
    n_classes: int = 16
    # sampled-training extras
    batch_nodes: int | None = None
    fanouts: tuple | None = None
    # batched-small-graph extras
    batch_graphs: int | None = None


# ---- the assignment's four GNN shape regimes ------------------------------
FULL_GRAPH_SM = GraphSpec("full_graph_sm", 2_708, 10_556, 1_433, n_classes=7)
MINIBATCH_LG = GraphSpec(
    "minibatch_lg", 232_965, 114_615_892, 602, n_classes=41,
    batch_nodes=1_024, fanouts=(15, 10),
)
OGB_PRODUCTS = GraphSpec("ogb_products", 2_449_029, 61_859_140, 100, n_classes=47)
MOLECULE = GraphSpec("molecule", 30, 64, 0, batch_graphs=128)

# ---- the paper's evaluation datasets (Section VI-A) -----------------------
PAPER_REDDIT = GraphSpec(
    "reddit", 232_965, 114_615_892, 602, n_classes=41,
    batch_nodes=2_000, fanouts=(10, 25),
)
PAPER_PRODUCTS = GraphSpec(
    "ogbn-products", 2_449_029, 61_859_140, 100, n_classes=47,
    batch_nodes=2_000, fanouts=(10, 25),
)
PAPER_PAPERS100M = GraphSpec(
    "ogbn-papers100m", 111_059_956, 1_615_685_872, 128, n_classes=172,
    batch_nodes=2_000, fanouts=(10, 25),
)

# ---- out-of-core streaming specs (tiered store; Armada's 100M+-edge
# regime). Features are NEVER materialized as one matrix: ``materialize``
# attaches a chunked ``StreamingFeatures`` source instead, and the tiered
# host tier pages blocks in/out under ``MemoryBudget.host_bytes``.
OOC_COMMUNITY = GraphSpec(
    "ooc_community", 8_000_000, 96_000_000, 128, n_classes=64,
    batch_nodes=1_000, fanouts=(10, 25),
)
OOC_PAPERS100M = GraphSpec(
    "ooc_papers100m", 16_000_000, 160_000_000, 128, n_classes=172,
    batch_nodes=2_000, fanouts=(10, 25),
)
OUT_OF_CORE = frozenset({OOC_COMMUNITY.name, OOC_PAPERS100M.name})

SPECS = {
    s.name: s
    for s in [
        FULL_GRAPH_SM, MINIBATCH_LG, OGB_PRODUCTS, MOLECULE,
        PAPER_REDDIT, PAPER_PRODUCTS, PAPER_PAPERS100M,
        OOC_COMMUNITY, OOC_PAPERS100M,
    ]
}

# Scaled materialization targets: (n_nodes, avg_degree, d_feat) chosen to
# preserve hub structure and remote-traffic statistics at CPU-tractable size.
_BENCH_SCALE = {
    "reddit": (24_000, 40.0, 64),
    "ogbn-products": (48_000, 24.0, 64),
    "ogbn-papers100m": (96_000, 16.0, 64),
    "full_graph_sm": (2_708, 3.9, 1_433),
    "minibatch_lg": (24_000, 40.0, 64),
    "ogb_products": (48_000, 24.0, 64),
    "ooc_community": (24_000, 12.0, 96),
    "ooc_papers100m": (48_000, 10.0, 128),
}


class StreamingFeatures:
    """Chunked feature generator: rows are a pure function of (seed, block).

    Each block of ``chunk_rows`` rows is produced by its own
    ``np.random.SeedSequence((seed, block))`` stream, so any block can be
    (re)materialized independently and deterministically — the tiered
    store's host tier evicts blocks freely and regenerates them on demand;
    the full (n_rows, n_feat) matrix never exists in memory.
    """

    def __init__(self, n_rows: int, n_feat: int, chunk_rows: int = 2048,
                 seed: int = 0, dtype=np.float32):
        self.n_rows = int(n_rows)
        self.n_feat = int(n_feat)
        self.chunk_rows = int(chunk_rows)
        self.seed = int(seed)
        self.dtype = np.dtype(dtype)
        self.n_blocks = -(-self.n_rows // self.chunk_rows)

    @property
    def bytes_per_row(self) -> float:
        return float(self.n_feat * self.dtype.itemsize)

    def block(self, b: int) -> np.ndarray:
        """Materialize block ``b`` (rows [b*chunk, min((b+1)*chunk, N)))."""
        if not 0 <= b < self.n_blocks:
            raise IndexError(f"block {b} outside [0, {self.n_blocks})")
        lo = b * self.chunk_rows
        n = min(self.chunk_rows, self.n_rows - lo)
        rng = np.random.default_rng(np.random.SeedSequence((self.seed, b)))
        return rng.standard_normal((n, self.n_feat)).astype(self.dtype)

    def rows(self, node_ids: np.ndarray) -> np.ndarray:
        """Gather arbitrary rows, regenerating only the blocks touched."""
        node_ids = np.asarray(node_ids, np.int64).ravel()
        out = np.empty((len(node_ids), self.n_feat), self.dtype)
        blocks = node_ids // self.chunk_rows
        for b in np.unique(blocks):
            mask = blocks == b
            rows = self.block(int(b))
            out[mask] = rows[node_ids[mask] - int(b) * self.chunk_rows]
        return out


@lru_cache(maxsize=8)
def materialize(name: str, seed: int = 0, with_positions: bool = False) -> Graph:
    """Build the scaled synthetic instance for a named dataset.

    Out-of-core specs (``OUT_OF_CORE``) come back with ``features=None``
    and a chunked ``StreamingFeatures`` source on ``graph.feature_source``
    — consumers that need rows go through the tiered store's
    ``peek_rows`` / host tier instead of a monolithic matrix.
    """
    if name == "molecule":
        raise ValueError("molecule datasets use materialize_molecules()")
    spec = SPECS[name]
    n, deg, d = _BENCH_SCALE[name]
    if name in OUT_OF_CORE:
        graph = power_law_graph(
            n_nodes=n,
            avg_degree=deg,
            n_feat=0,
            n_classes=spec.n_classes,
            seed=seed,
            with_positions=with_positions,
        )
        graph.feature_source = StreamingFeatures(
            n_rows=n, n_feat=d, seed=seed
        )
        return graph
    return power_law_graph(
        n_nodes=n,
        avg_degree=deg,
        n_feat=d,
        n_classes=spec.n_classes,
        seed=seed,
        with_positions=with_positions,
    )


def materialize_molecules(batch: int = 128, seed: int = 0) -> dict:
    return molecule_batch(n_mols=batch, seed=seed)


def train_split(graph: Graph, frac: float = 0.6, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ids = rng.permutation(graph.n_nodes)
    return ids[: int(frac * graph.n_nodes)]
