"""Weight-sharing Kronecker approximation policy (KFAC-expand/reduce)."""
