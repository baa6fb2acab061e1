"""GNN models: GraphSAGE (paper)."""
