"""Per-cluster circuit breakers (fault injection is a later slice)."""
