"""Training loop of the port (twin of ``repro.train``)."""
