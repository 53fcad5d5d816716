"""Optimizer of the port (twin of ``repro.optim``)."""
