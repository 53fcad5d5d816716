"""Checkpointing of the port (twin of ``repro.checkpoint``)."""
