"""Device ops: the sorting-network kernels and their drivers."""
