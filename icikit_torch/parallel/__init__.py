"""Exchange layer over the rank axis."""
