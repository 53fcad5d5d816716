"""Paged attention, decode and prefill: CUDA kernels, plain versions and
dispatch."""
