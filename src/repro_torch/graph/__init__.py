"""Graph substrate: structures, partitioning, sampling, feature store."""
from repro_torch.graph.structure import Graph, build_csr  # noqa: F401
