"""Device ops: the sorting-network and attention kernels, their
drivers, and the tensor ops around them."""
