"""Checkpoints: the port's copy of ``repro.checkpoint``."""
