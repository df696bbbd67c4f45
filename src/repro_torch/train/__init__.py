"""Training in one process: the port's copy of ``repro.train``."""
