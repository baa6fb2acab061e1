"""Model zoo: the paper's GraphSAGE, the GNN zoo (PNA, GatedGCN, NequIP,
MACE), the LM family and the FM recommender."""
