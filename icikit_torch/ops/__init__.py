"""Device ops: the sorting-network, attention and cross-entropy
kernels, their drivers, and the tensor ops around them."""
