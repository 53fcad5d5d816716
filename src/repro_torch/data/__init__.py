"""Data pipeline of the port (twin of ``repro.data``)."""
