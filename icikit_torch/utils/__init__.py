"""Runtime core: rank mesh, dtype helpers, registry, timing."""
