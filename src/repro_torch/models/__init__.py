"""Model zoo: the paper's GraphSAGE (other families are not ported yet)."""
