"""Placement legality (counterpart of the validators of ``repro.search``)."""
