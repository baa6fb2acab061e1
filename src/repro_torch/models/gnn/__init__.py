"""GNN models: GraphSAGE (paper), PNA, GatedGCN, NequIP and MACE (with the
irreps algebra)."""
