"""Model layers of the port (twin of ``repro.models``)."""
