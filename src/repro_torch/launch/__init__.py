"""Launchers of the port (twin of ``repro.launch``)."""
