"""Model configurations (the paper's GCN)."""
