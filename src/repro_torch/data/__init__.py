"""The data pipeline: the port's copy of ``repro.data`` (NumPy only)."""
