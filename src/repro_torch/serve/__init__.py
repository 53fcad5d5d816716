"""Paged serving datapath of the port (twin of ``repro.serve``)."""
