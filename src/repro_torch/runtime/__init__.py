"""Runtime policy layer: the port's copy of ``repro.runtime`` (host logic)."""
