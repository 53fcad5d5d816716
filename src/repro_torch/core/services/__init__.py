"""Dynamic-layer services of the port (twin of ``repro.core.services``)."""
